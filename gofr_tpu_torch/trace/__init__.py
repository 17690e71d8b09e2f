from gofr_tpu_torch.trace.tracer import (
    ListExporter,
    Span,
    Tracer,
    current_span,
    extract_traceparent,
    format_traceparent,
)

__all__ = [
    "ListExporter",
    "Span",
    "Tracer",
    "current_span",
    "extract_traceparent",
    "format_traceparent",
]
