"""GT006 negative fixture: torch KV copies staged off the loop.

Parsed by graftcheck in tests, never imported.
"""

import asyncio


def _export(pool):
    # only ever *passed* to an executor: no call edge from the loop
    return {name: leaf.cpu().numpy() for name, leaf in pool.leaves.items()}


async def export_handler(pool):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, _export, pool)


async def metadata_only(pool, logits):
    # bookkeeping, and a sync of something that is not the pool (GT001's
    # business, not GT006's), outside the KV modules
    return len(pool.free_pages), logits.cpu()
