"""GT003 positive fixture: CUDA-graph recapture hazards.

Parsed by graftcheck in tests, never imported.
"""

import torch

from gofr_tpu_torch.tpu import capture


def per_call(device, pool, x):
    # captured on every call and thrown away after one replay
    graph, out, _ = capture.record(device, pool, lambda: x * 2,
                                   lambda: x * 2)
    graph.replay()
    return out.clone()


def fresh_graph(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y = x + 1
    g.replay()
    return y.sum()


class Engine:
    def __init__(self):
        self._graphs = {}

    def _capture(self, key, x):
        entry = capture.record(self.device, self.pool, lambda: x * 2,
                               lambda: x * 2)
        self._graphs[key] = entry
        return entry

    def tick(self, batch, x):
        # keyed on the live batch size: one capture per distinct length
        entry = self._graphs.get(len(batch))
        if entry is None:
            entry = self._capture(len(batch), x)
        return entry

    def tick_listed(self, batch, x):
        key = [len(batch)]
        return self._graphs.get(key)

    def static_buffers(self, batch):
        buf = torch.zeros((len(batch), 4), device=self.device)
        return capture.record(self.device, self.pool, lambda: buf * 2,
                              lambda: buf * 2)

    def gathered(self, table, pages):
        def body():
            return table[:, :len(pages)].sum()
        return capture.record(self.device, self.pool, body, body)
