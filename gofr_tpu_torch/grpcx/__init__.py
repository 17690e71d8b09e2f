"""gRPC transport (counterpart of ``gofr_tpu/grpcx``)."""

from gofr_tpu_torch.grpcx.server import GRPCRequest, GRPCServer, grpc_available

__all__ = ["GRPCRequest", "GRPCServer", "grpc_available"]
