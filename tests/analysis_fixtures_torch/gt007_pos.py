"""GT007 positive fixture: per-dispatch host tensors.

Parsed by graftcheck in tests, never imported.
"""

import torch


class Executorish:
    def _dispatch(self, name, rows):
        # a fresh tensor from Python data on every dispatch
        batch = torch.tensor(rows)
        return self._enqueue(name, batch)

    def dispatch_rows(self, name, n, width):
        # a host tensor made per dispatch (no device=)
        buf = torch.zeros((n, width), dtype=torch.int32)
        return self._enqueue(name, buf)

    def dispatch(self, name, batch):
        # transitive: dispatch -> _prep -> a fresh pinned copy
        return self._enqueue(name, self._prep(batch))

    def _prep(self, batch):
        return batch.pin_memory()

    def _enqueue(self, name, batch):
        return (name, batch)


class Engineish:
    def _dispatch_tick(self, n):
        return torch.empty((n,), device="cpu")
