"""Deterministic virtual-clock simulation of the online detection pipeline.

Drives a scheduler with frame arrivals at λ FPS and records, per frame,
whether it was detection-processed (and when) or randomly dropped — the
quantity the paper's entire analysis (σ, drop rate, mAP degradation)
hangs off.  Service times are calibrated device profiles or real measured
JAX inference (executor.infer_fn); either way the clock is virtual so a
7-accelerator edge rig can be simulated exactly on this CPU-only host.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .scheduler import Assignment, _Base
from .stream import FrameStream


@dataclass
class SimResult:
    video: str
    lambda_fps: float
    assignments: List[Assignment]
    dropped: List[int]
    n_frames: int
    makespan: float

    @property
    def processed_indices(self):
        return [a.frame_idx for a in self.assignments]

    @property
    def sigma(self) -> float:
        """Achieved detection processing rate σ_P (FPS)."""
        if not self.assignments:
            return 0.0
        return len(self.assignments) / max(self.makespan, 1e-9)

    @property
    def drop_rate(self) -> float:
        return len(self.dropped) / max(self.n_frames, 1)

    @property
    def drops_per_processed(self) -> float:
        return len(self.dropped) / max(len(self.assignments), 1)

    def per_executor_counts(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for a in self.assignments:
            out[a.executor_idx] = out.get(a.executor_idx, 0) + 1
        return out


def simulate(stream: FrameStream, scheduler: _Base, offline: bool = False,
             arrival_rate: Optional[float] = None) -> SimResult:
    """offline=True reproduces the paper's zero-frame-drop reference: every
    frame waits for a free executor (unbounded buffer), σ == μ aggregate.
    ``arrival_rate`` overrides the video's λ (e.g. saturated feeding to
    measure a scheduler's processing capacity, the paper's Detection FPS)."""
    assignments, dropped = [], []
    t_next_free = 0.0
    for frame in stream:
        t = (frame.index / arrival_rate if arrival_rate is not None
             else frame.t_arrival)
        if offline:
            # blocking dispatch through the scheduler's own policy
            assignments.append(scheduler.blocking_assign(frame.index))
            continue
        a = scheduler.assign(frame.index, t)
        if a is None:
            dropped.append(frame.index)
        else:
            assignments.append(a)
    makespan = max((a.t_done for a in assignments), default=0.0)
    return SimResult(stream.video.spec.name, stream.fps, assignments,
                     dropped, len(stream), makespan)
