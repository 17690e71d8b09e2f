"""GT006 positive fixture: KV pool leaves synced to host on the loop.

Parsed by graftcheck in tests, never imported.
"""


async def export_handler(pool):
    # a whole prompt's KV pages cross device->host on the loop
    return pool.leaves["k"].cpu()


def _stage(engine):
    return engine._pool.leaves["v"].numpy()


async def transitive(engine):
    return _stage(engine)


async def listed(pool):
    return pool.leaves["k"][0].tolist()
