"""graftcheck rule registry. Rule catalog: docs/references/static-analysis-torch.md."""

from __future__ import annotations

from typing import List, Optional, Sequence

from gofr_tpu_torch.analysis.engine import Rule
from gofr_tpu_torch.analysis.rules.gt001_event_loop import EventLoopBlockRule
from gofr_tpu_torch.analysis.rules.gt002_tasks import FireAndForgetRule
from gofr_tpu_torch.analysis.rules.gt003_recompile import RecompileHazardRule
from gofr_tpu_torch.analysis.rules.gt004_traced_effects import TracedSideEffectsRule
from gofr_tpu_torch.analysis.rules.gt005_metrics import MetricDisciplineRule
from gofr_tpu_torch.analysis.rules.gt006_kv_transfer import KVTransferSyncRule
from gofr_tpu_torch.analysis.rules.gt007_host_alloc import HostAllocRule
from gofr_tpu_torch.analysis.rules.gt008_label_cardinality import \
    LabelCardinalityRule
from gofr_tpu_torch.analysis.rules.gt009_cron import CronReentrancyRule
from gofr_tpu_torch.analysis.rules.gt010_retry import UnboundedRetryRule
from gofr_tpu_torch.analysis.rules.gt011_telemetry import \
    UnboundedTelemetryBufferRule
from gofr_tpu_torch.analysis.rules.gt012_workload import WorkloadContentLeakRule
from gofr_tpu_torch.analysis.rules.gt013_watchdog_reasons import \
    WatchdogReasonDriftRule
from gofr_tpu_torch.analysis.rules.gt014_knobs import ServingKnobMutationRule
from gofr_tpu_torch.analysis.rules.gt015_donate import DonateUseRule
from gofr_tpu_torch.analysis.rules.gt016_pool_lock import PoolLockRule
from gofr_tpu_torch.analysis.rules.gt017_lock_across_await import \
    LockAcrossAwaitRule

ALL_RULES = (
    EventLoopBlockRule,
    FireAndForgetRule,
    RecompileHazardRule,
    TracedSideEffectsRule,
    MetricDisciplineRule,
    KVTransferSyncRule,
    HostAllocRule,
    LabelCardinalityRule,
    CronReentrancyRule,
    UnboundedRetryRule,
    UnboundedTelemetryBufferRule,
    WorkloadContentLeakRule,
    WatchdogReasonDriftRule,
    ServingKnobMutationRule,
    DonateUseRule,
    PoolLockRule,
    LockAcrossAwaitRule,
)


def default_rules(select: Optional[Sequence[str]] = None,
                  **options) -> List[Rule]:
    """Instantiate the rule set, optionally filtered to ``select`` ids.
    ``options`` are forwarded to rules that accept them (GT005/GT013
    take ``docs_catalog``, GT011/GT012 take ``scope_all``)."""
    rules: List[Rule] = []
    for cls in ALL_RULES:
        if select and cls.rule_id not in select:
            continue
        if cls is MetricDisciplineRule and "docs_catalog" in options:
            rules.append(cls(docs_catalog=options["docs_catalog"]))
        elif cls is WatchdogReasonDriftRule and "docs_catalog" in options:
            rules.append(cls(docs_catalog=options["docs_catalog"]))
        elif cls is UnboundedTelemetryBufferRule and "scope_all" in options:
            rules.append(cls(scope_all=options["scope_all"]))
        elif cls is WorkloadContentLeakRule and "scope_all" in options:
            rules.append(cls(scope_all=options["scope_all"]))
        else:
            rules.append(cls())
    return rules
