"""The port's copy of ``a_modular_rag_framework_tpu/telemetry/__init__.py``.
"""
from .sinks import (
    LocalJsonlSink,
    NullSink,
    TelemetrySink,
    build_latency_breakdown,
    build_mermaid,
    finalize_trace_artifacts,
    record_device_timing,
    record_llm_call,
    record_metrics,
    record_run_end,
    record_run_start,
    span,
)

__all__ = [
    "LocalJsonlSink",
    "NullSink",
    "TelemetrySink",
    "build_latency_breakdown",
    "build_mermaid",
    "finalize_trace_artifacts",
    "record_device_timing",
    "record_llm_call",
    "record_metrics",
    "record_run_end",
    "record_run_start",
    "span",
]
