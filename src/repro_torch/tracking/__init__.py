"""Batched multi-object tracking for the parallel detection pipeline
(the port of the reference package's ``tracking``): a constant-velocity
Kalman filter over the whole (B, T) track table (``kalman``), box
plumbing around the fused IoU cost-matrix + greedy-assignment kernel
(``association``), the fixed-capacity track table with birth /
confirm / coast / kill as masked tensor updates, B streams in lockstep
(``tracker``), and the dropped-frame interpolation of a simulated run
(``interpolate.fill_stream``: every frame the scheduler dropped gets
tracker-coasted boxes, tagged ``interpolated``)."""
from .interpolate import TrackedFrame, fill_stream
from .tracker import (TrackerConfig, TrackerState, coast, export_rows,
                      init_state, output, rows_to_state, step)

__all__ = ["TrackedFrame", "TrackerConfig", "TrackerState", "coast",
           "export_rows", "fill_stream", "init_state", "output",
           "rows_to_state", "step"]
