"""GT001 negative fixture: torch syncs offloaded from the event loop.

Parsed by graftcheck in tests, never imported.
"""

import asyncio

import torch


def _fetch(logits):
    # only ever *passed* to an executor: no call edge from the loop
    torch.cuda.synchronize()
    return logits.argmax().item(), logits.cpu().tolist()


async def handler(logits):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, _fetch, logits)


async def hopped(event):
    await asyncio.to_thread(event.synchronize)


async def queued(logits, staging):
    # queueing device work and a pinned copy does not wait for the card
    out = torch.softmax(logits, dim=-1)
    return staging.fetch(out)
