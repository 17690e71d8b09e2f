"""GT001 positive fixture: torch's device->host syncs on the event loop.

Parsed by graftcheck in tests, never imported.
"""

import torch


async def scalar(logits):
    return logits.argmax().item()


async def to_host(logits):
    return logits.cpu()


async def listed(tokens):
    return tokens.tolist()


def _as_numpy(x):
    return x.numpy()


async def transitive(x):
    # blocks through a plain-call hop: transitive -> _as_numpy -> sync
    return _as_numpy(x)


async def drain():
    torch.cuda.synchronize()


async def wait_event(event, stream):
    event.synchronize()
    stream.synchronize()
