"""Batched multi-object tracking for the parallel detection pipeline
(the port of the reference package's ``tracking``): a constant-velocity
Kalman filter over the whole (B, T) track table (``kalman``), box
plumbing around the fused IoU cost-matrix + greedy-assignment kernel
(``association``), and the fixed-capacity track table with birth /
confirm / coast / kill as masked tensor updates, B streams in lockstep
(``tracker``).  The dropped-frame interpolation helper
(``interpolate.fill_stream``) comes with a later slice."""
from .tracker import (TrackerConfig, TrackerState, coast, export_rows,
                      init_state, output, rows_to_state, step)

__all__ = ["TrackerConfig", "TrackerState", "coast", "export_rows",
           "init_state", "output", "rows_to_state", "step"]
