"""Prometheus text exposition format (v0.0.4) rendered from the Manager
store (a copy of ``gofr_tpu/metrics/exposition.py``), with OpenMetrics
exemplars on histogram bucket lines.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from gofr_tpu_torch.metrics.manager import Manager

_KIND_TO_PROM = {
    "counter": "counter",
    "updown": "gauge",
    "gauge": "gauge",
    "histogram": "histogram",
}


def _fmt_labels(key) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_float(value: float) -> str:
    if value == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _fmt_exemplar(exemplar) -> str:
    """OpenMetrics exemplar suffix: `` # {trace_id="..."} value timestamp``
    (OpenMetrics 1.0 §exemplars). Appended to ``_bucket`` sample lines so a
    latency histogram links back to one concrete traced request."""
    labels, value, ts = exemplar
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return f" # {{{inner}}} {_fmt_float(value)} {ts:.3f}"


def render_prometheus(manager: "Manager") -> str:
    lines = []
    for name, metric in sorted(manager.snapshot().items()):
        prom_kind = _KIND_TO_PROM[metric.kind]
        if metric.desc:
            lines.append(f"# HELP {name} {metric.desc}")
        lines.append(f"# TYPE {name} {prom_kind}")
        if metric.kind == "histogram":
            for key, state in sorted(metric.series.items()):
                assert isinstance(state, dict)
                exemplars = state.get("exemplars", {})
                cumulative = 0
                for i, (bound, count) in enumerate(
                        zip(metric.buckets, state["buckets"])):
                    cumulative += count
                    le_labels = dict(key)
                    le_labels["le"] = _fmt_float(bound)
                    line = (
                        f"{name}_bucket{_fmt_labels(tuple(sorted(le_labels.items())))} {cumulative}"
                    )
                    if i in exemplars:
                        line += _fmt_exemplar(exemplars[i])
                    lines.append(line)
                inf_labels = dict(key)
                inf_labels["le"] = "+Inf"
                line = (
                    f"{name}_bucket{_fmt_labels(tuple(sorted(inf_labels.items())))} {state['count']}"
                )
                if len(metric.buckets) in exemplars:
                    line += _fmt_exemplar(exemplars[len(metric.buckets)])
                lines.append(line)
                lines.append(f"{name}_sum{_fmt_labels(key)} {_fmt_float(state['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(key)} {state['count']}")
        else:
            for key, value in sorted(metric.series.items()):
                lines.append(f"{name}{_fmt_labels(key)} {_fmt_float(float(value))}")  # type: ignore[arg-type]
    return "\n".join(lines) + "\n"
