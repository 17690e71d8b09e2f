"""GT015 negative fixture: static outputs copied before the next replay.

Parsed by graftcheck in tests, never imported.
"""

import torch

from gofr_tpu_torch.tpu import capture


def cloned(device, pool, static_in, a, b):
    graph, out, _ = capture.record(device, pool, lambda: static_in * 2,
                                   lambda: static_in * 2)
    static_in.copy_(a)
    graph.replay()
    first = out[0].clone()
    static_in.copy_(b)
    graph.replay()
    return first.sum(), out


def copied_out(entry, a, b, keep):
    entry.inp.copy_(a)
    entry.graph.replay()
    keep.copy_(entry.out)
    entry.inp.copy_(b)
    entry.graph.replay()
    return keep, entry.out


def collected(entry, batches):
    outs = []
    for batch in batches:
        entry.inp.copy_(batch)
        entry.graph.replay()
        outs.append(entry.out.clone())
    return outs


def fenced(entry, side, a, b):
    entry.inp.copy_(a)
    entry.graph.replay()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        entry.inp.copy_(b)
    return entry.out.clone()


def one_replay(entry, a):
    entry.inp.copy_(a)
    entry.graph.replay()
    return entry.out
