"""Deterministic observability for the serving stack: frame-lifecycle
tracing (``trace``), streaming latency histograms (``metrics``),
Perfetto/Chrome timeline export (``export``) and trace-replay invariant
auditing (``audit``), copied from the reference package."""
from .audit import AuditResult, audit_events, audit_recorder
from .export import events_from_chrome, to_chrome_trace, write_chrome_trace
from .metrics import (LatencyHistogram, detection_latency_keys,
                      merge_hist_dicts, quantile_of_dict)
from .trace import NULL_RECORDER, NullRecorder, TraceRecorder

__all__ = [
    "TraceRecorder", "NullRecorder", "NULL_RECORDER",
    "LatencyHistogram", "detection_latency_keys", "merge_hist_dicts",
    "quantile_of_dict",
    "to_chrome_trace", "events_from_chrome", "write_chrome_trace",
    "AuditResult", "audit_events", "audit_recorder",
]
