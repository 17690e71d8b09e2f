"""GT007 negative fixture: staged torch dispatch paths.

Parsed by graftcheck in tests, never imported.
"""

import torch


class Executorish:
    def _dispatch(self, name, rows, n):
        # rows go into a leased pinned slab; the device buffer is made on
        # the card, and from_numpy is a view
        slab = self._staging.acquire(name)
        slab[:n].copy_(torch.from_numpy(rows))
        out = torch.empty((n,), device=self.device)
        return self._enqueue(name, slab, out)

    def _new_slab(self, shape, dtype):
        # a pinned constructor is how a staging slab is made
        return torch.empty(shape, dtype=dtype, pin_memory=True)

    def _enqueue(self, name, slab, out):
        return (name, slab, out)

    def predict(self, rows):
        # cold path: not a dispatch root and nothing on one calls it
        return torch.tensor(rows).pin_memory()
