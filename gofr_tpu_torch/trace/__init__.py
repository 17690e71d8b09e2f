from gofr_tpu_torch.trace.tracer import (
    ListExporter,
    Span,
    Tracer,
    current_span,
    extract_traceparent,
    format_traceparent,
    new_tracer,
)

__all__ = [
    "ListExporter",
    "Span",
    "Tracer",
    "current_span",
    "extract_traceparent",
    "format_traceparent",
    "new_tracer",
]
