"""WebSocket transport (counterpart of ``gofr_tpu/websocket``)."""

from gofr_tpu_torch.websocket.connection import (
    Connection,
    ConnectionClosed,
    ConnectionHub,
)
from gofr_tpu_torch.websocket.frames import (accept_key, decode_frame,
                                             encode_frame)
from gofr_tpu_torch.websocket.upgrade import hub, make_ws_route

__all__ = ["Connection", "ConnectionClosed", "ConnectionHub", "accept_key",
           "decode_frame", "encode_frame", "hub", "make_ws_route"]
