"""Deterministic observability for the serving stack: frame-lifecycle
tracing (``trace``) and streaming latency histograms (``metrics``),
copied from the reference package.  The audit and the Perfetto export
are not carried over yet."""
from .metrics import (LatencyHistogram, detection_latency_keys,
                      merge_hist_dicts, quantile_of_dict)
from .trace import NULL_RECORDER, NullRecorder, TraceRecorder

__all__ = [
    "TraceRecorder", "NullRecorder", "NULL_RECORDER",
    "LatencyHistogram", "detection_latency_keys", "merge_hist_dicts",
    "quantile_of_dict",
]
