"""GT006 positive fixture: torch syncs in a KV export/adopt module.

Its path ends in ``tpu/cluster.py``, one of the KV modules, where every
torch sync on the loop is a KV one. Parsed by graftcheck in tests, never
imported.
"""

import torch


async def adopt(payload, event):
    torch.cuda.synchronize()
    event.synchronize()
    return payload.tokens.tolist()
