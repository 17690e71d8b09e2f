"""The premises of GT003, GT004 and GT015, as code that runs on the card.

Each CUDA-graph rule has a positive function here, which the port's
analyzer flags, and a negative one, which it passes (the expected
findings are :data:`EXPECTED`). ``chip_smoke.py`` phase 43b runs every
function on the card through ``capture.record`` with a graph pool and
holds what the card shows against the verdict: the hazard on each
positive, none on its negative. ``tests/test_torch_analysis.py`` holds
the verdict on the CPU, where nothing here runs.
"""

import torch

from gofr_tpu_torch.tpu import capture

RUNGS = (4, 8, 16)

# (rule, key) of every finding the analyzer must report here, no more
EXPECTED = {
    ("GT004", ".increment_counter(...) in counted_body"),
    ("GT004", ".item() in synced_body"),
    ("GT003", "raw-key graphs in raw_key_pos"),
    ("GT015", "static-output first in held_pos"),
}


class Counter:
    """A metrics sink that counts ``increment_counter`` calls."""

    def __init__(self):
        self.n = 0

    def increment_counter(self, name, **labels):
        self.n += 1


# -- GT004: a capture's host work runs at the capture, never at a replay ---

def counted_pos(device, pool, metrics, x, replays):
    """The body bumps the counter: at the eager run and the capture only."""
    def counted_body():
        metrics.increment_counter("app_fixture_requests_total")
        return x * 2
    graph, out, _ = capture.record(device, pool, counted_body, counted_body)
    for _ in range(replays):
        graph.replay()
    return graph, out


def counted_neg(device, pool, metrics, x, replays):
    """The dispatch site bumps the counter: once a replay."""
    graph, out, _ = capture.record(device, pool, lambda: x * 2,
                                   lambda: x * 2)
    for _ in range(replays):
        graph.replay()
        metrics.increment_counter("app_fixture_requests_total")
    return graph, out


def synced_pos(device, pool, x):
    """A host sync in the body: ``capture.record`` raises."""
    def synced_body():
        return x * x.sum().item()
    return capture.record(device, pool, synced_body, synced_body)


# -- GT003: a table keyed on raw lengths captures once a length ------------

def raw_key_pos(device, pool, graphs, x, batch):
    key = len(batch)
    if key not in graphs:
        graphs[key] = capture.record(device, pool, lambda: x[:key] * 2,
                                     lambda: x[:key] * 2)
    return graphs[key]


def raw_key_neg(device, pool, graphs, x, batch):
    key = next(r for r in RUNGS if r >= len(batch))
    if key not in graphs:
        graphs[key] = capture.record(device, pool, lambda: x[:key] * 2,
                                     lambda: x[:key] * 2)
    return graphs[key]


# -- GT015: a held static output takes the next replay's values -----------

def held_pos(entry, a, b):
    entry.inp.copy_(a)
    entry.graph.replay()
    first = entry.out
    entry.inp.copy_(b)
    entry.graph.replay()
    return first


def held_neg(entry, a, b):
    entry.inp.copy_(a)
    entry.graph.replay()
    first = entry.out.clone()
    entry.inp.copy_(b)
    entry.graph.replay()
    return first
