"""GT003 negative fixture: captures kept in a rung-keyed table.

Parsed by graftcheck in tests, never imported.
"""

import torch

from gofr_tpu_torch.tpu import capture

RUNGS = (8, 16, 32)


def _rung(n):
    return next(r for r in RUNGS if r >= n)


class Engine:
    def __init__(self):
        self._graphs = {}

    def _record(self, eager, body):
        # a capture helper: its graph leaves through the return
        return capture.record(self.device, self.pool, eager, body)

    def _capture(self, key):
        buf = torch.zeros((key, 4), device=self.device)
        graph, out, launches = self._record(lambda: buf * 2,
                                            lambda: buf * 2)
        self._graphs[key] = (graph, out, launches)
        return self._graphs[key]

    def tick(self, batch):
        key = _rung(len(batch))
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._capture(key)
        return entry

    def tick_inline(self, batch):
        return self._graphs.get(next(r for r in RUNGS if r >= len(batch)))

    def body(self, table, pw):
        def body():
            # the width is a rung and the shape a static buffer's own
            half = table.shape[1] // 2
            return table[:, :pw].sum() + table[:, :half].sum()
        return capture.record(self.device, self.pool, body, body)


def build_graph(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = x + 1
    return g, y
