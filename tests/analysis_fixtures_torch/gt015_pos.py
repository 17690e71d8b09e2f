"""GT015 positive fixture: static outputs read after the next replay.

Parsed by graftcheck in tests, never imported.
"""

import torch

from gofr_tpu_torch.tpu import capture


def held(device, pool, static_in, a, b):
    graph, out, _ = capture.record(device, pool, lambda: static_in * 2,
                                   lambda: static_in * 2)
    static_in.copy_(a)
    graph.replay()
    first = out[0]
    static_in.copy_(b)
    graph.replay()
    return first.sum(), out


def held_view(entry, a, b):
    entry.inp.copy_(a)
    entry.graph.replay()
    first = entry.out.view(-1)
    entry.inp.copy_(b)
    entry.graph.replay()
    return first


def collected(entry, batches):
    outs = []
    for batch in batches:
        entry.inp.copy_(batch)
        entry.graph.replay()
        outs.append(entry.out)
    return outs


def raced(entry, side, a, b):
    entry.inp.copy_(a)
    entry.graph.replay()
    with torch.cuda.stream(side):
        entry.inp.copy_(b)
    return entry.out.clone()
