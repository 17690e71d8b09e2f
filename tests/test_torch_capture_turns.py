"""Graph captures and the launch counters under threads (the port's own;
the JAX package has no counterpart). Engines serve from threads of their
own, so on the card one engine captures a graph while others replay
theirs:

- captures take turns: no two threads are ever inside
  ``generate._no_collection`` at once, and the cyclic collector is off
  inside and back on after;
- ``launch_counts.capture()`` gives a capture exactly the launches its
  own thread made inside it, while replays other threads count with
  ``launch_counts.add`` meanwhile all land in the counters: none is lost
  and none is charged to the capture.

Both run with more threads than cores and a shortened switch interval.
"""

import gc
import sys
import threading

from gofr_tpu_torch.ops.cuda import flash_attention as flash
from gofr_tpu_torch.ops.cuda import launch_counts
from gofr_tpu_torch.ops.cuda import ragged_paged_attention as ragged
from gofr_tpu_torch.tpu import generate

THREADS = 16
ROUNDS = 200


def _run(workers):
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=w) for w in workers]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)


def test_captures_take_turns_with_the_collector_off():
    inside = []
    overlaps = []
    collector_on = []
    lock = threading.Lock()

    def worker():
        for _ in range(ROUNDS):
            with generate._no_collection():
                with lock:
                    inside.append(1)
                    overlaps.append(len(inside))
                collector_on.append(gc.isenabled())
                with lock:
                    inside.pop()

    assert gc.isenabled()
    _run([worker] * THREADS)
    assert max(overlaps) == 1 and len(overlaps) == THREADS * ROUNDS
    assert not any(collector_on)
    assert gc.isenabled() and generate._CAPTURES["open"] == 0


def test_capture_counts_its_own_launches_and_keeps_the_replays():
    saved = launch_counts.read()
    launch_counts.write(dict.fromkeys(saved, 0))
    captured = []
    replay = dict.fromkeys(saved, 0)
    replay["ragged_paged_attention.launches"] = 3

    def capturer():
        for n in range(1, ROUNDS // 4 + 1):
            with generate._no_collection(), \
                    launch_counts.capture() as launches:
                # what a wrapper does where it launches its kernel
                for _ in range(n):
                    flash.launches += 1
            captured.append((n, launches["flash_attention.launches"],
                             launches["ragged_paged_attention.launches"]))

    def replayer():
        for _ in range(ROUNDS):
            launch_counts.add(replay)

    try:
        _run([capturer] * 2 + [replayer] * (THREADS - 2))
        counts = launch_counts.read()
    finally:
        launch_counts.write(saved)
    assert all(got == n and other == 0 for n, got, other in captured)
    assert len(captured) == 2 * (ROUNDS // 4)
    # a capture launches nothing; every replay's launches land
    assert counts["flash_attention.launches"] == 0
    assert counts["ragged_paged_attention.launches"] == \
        3 * ROUNDS * (THREADS - 2)
    assert ragged.launches == saved["ragged_paged_attention.launches"]
