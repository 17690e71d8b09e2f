"""GT004 negative fixture: graph bodies that only launch kernels.

Parsed by graftcheck in tests, never imported.
"""

import torch

from gofr_tpu_torch.tpu import capture


class Engine:
    def _record(self, eager, body):
        return capture.record(self.device, self.pool, eager, body)

    def _tick_body(self, active: torch.Tensor, sampled: bool,
                   window=None):
        # host-state branches and structure checks steer the capture
        if sampled:
            active = active * 2
        if window is None:
            return active
        if active.shape[0] > window and active.dtype == torch.int32:
            return active[:window]
        return torch.where(active > 0, active, -active)

    def capture_tick(self, sampled):
        return self._record(
            lambda: self._tick_body(self.active, sampled),
            lambda: self._tick_body(self.active, sampled))

    def dispatch(self, entry):
        # host work at the dispatch site, around the replay
        entry.graph.replay()
        self.metrics.increment_counter("app_fixture_requests_total")
        self.logger.info("replayed")
        return entry.out


def host_side(logger, x):
    # not a graph body: loggers, syncs and branches are fine out here
    logger.info("x = %s", x.sum().item())
    if x.any():
        return 1
    return 0
