"""GT004 positive fixture: host work inside CUDA-graph bodies.

Parsed by graftcheck in tests, never imported.
"""

import random

import numpy as np
import torch

from gofr_tpu_torch.tpu import capture


class Engine:
    def _record(self, eager, body):
        return capture.record(self.device, self.pool, eager, body)

    def _tick_body(self, active: torch.Tensor):
        self.logger.info("tick")
        self.metrics.increment_counter("app_fixture_requests_total")
        return active * 2

    def capture_tick(self):
        return self._record(lambda: self._tick_body(self.active),
                            lambda: self._tick_body(self.active))


def noisy(device, pool, x):
    def body():
        print("captured")
        return x + 1
    return capture.record(device, pool, body, body)


def synced(device, pool, x):
    def body():
        return x * x.sum().item()
    return capture.record(device, pool, body, body)


def seeded(device, pool, x):
    def body():
        noise = np.random.rand()
        return x + noise + random.random()
    return capture.record(device, pool, body, body)


def branchy(device, pool, x: torch.Tensor):
    def body():
        total = torch.sum(x)
        if total > 0:
            return x
        return -x
    return capture.record(device, pool, body, body)


def graph_block(x):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        torch.cuda.synchronize()
        y = x + 1
    return g, y
