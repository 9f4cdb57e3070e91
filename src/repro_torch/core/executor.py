"""Detection-model executors and device/interface profiles.

Device service rates (μ, FPS) and TDP come straight from the paper's
Tables IV–IX (measured on real hardware by the authors); the executor can
alternatively *measure* service time by running a real JAX model on this
host.  Interface goodput is calibrated from Table IX: the per-frame USB-2.0
penalty the paper measured (1/1.9 − 1/2.5 ≈ 126 ms for YOLOv3-class
inputs) implies ≈ 8.4 MB/s effective NCS2 goodput on USB 2.0; USB 3.0 is
effectively unconstrained at these frame sizes.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field, replace
from typing import Callable, Optional

import numpy as np


@dataclass(frozen=True)
class ModelProfile:
    """A pre-trained detector (paper Table II)."""
    name: str
    input_size: int          # square input resolution
    channels: int = 3
    bytes_per_px: int = 2    # FP16 deployment on NCS2
    model_size_mb: float = 0.0
    base_map: float = 0.0    # zero-drop reference mAP (paper Tables IV/V)

    @property
    def frame_bytes(self) -> int:
        return self.input_size * self.input_size * self.channels \
            * self.bytes_per_px


MODEL_PROFILES = {
    "ssd300": ModelProfile("ssd300", 300, model_size_mb=51, base_map=0.745),
    "yolov3": ModelProfile("yolov3", 416, model_size_mb=119, base_map=0.869),
}


@dataclass(frozen=True)
class DeviceProfile:
    """An edge AI device (paper Tables III & VI)."""
    name: str
    tdp_watts: float
    # per-model zero-drop service rate μ (FPS), from the paper's tables
    fps: dict = field(default_factory=dict)

    def mu(self, model: str) -> float:
        return self.fps[model]


DEVICE_PROFILES = {
    "ncs2": DeviceProfile("ncs2", 2.0, {"ssd300": 2.3, "yolov3": 2.5}),
    "fast_cpu": DeviceProfile("fast_cpu", 125.0,
                              {"ssd300": 12.0, "yolov3": 13.5}),
    "slow_cpu": DeviceProfile("slow_cpu", 15.0,
                              {"ssd300": 0.5, "yolov3": 0.4}),
    "gpu_titanx": DeviceProfile("gpu_titanx", 250.0,
                                {"ssd300": 46.0, "yolov3": 35.0}),
}

# effective host->accelerator goodput in bytes/s (calibration in docstring)
INTERFACE_GOODPUT = {
    "usb2": 8.4e6,
    "usb3": 8.4e6 * (5.0 / 0.48),     # scales with the 5 Gbps/480 Mbps ratio
    "pcie": 1e12,                      # host-local (CPU/GPU): no penalty
}


@dataclass(eq=False)
class DetectorExecutor:
    """One parallel detection model instance bound to one device.

    Service time = compute (1/μ) + interface transfer (frame_bytes/goodput),
    with optional lognormal jitter; or measured from a real `infer_fn`.
    """
    device: DeviceProfile
    model: ModelProfile
    interface: str = "usb3"
    jitter: float = 0.0            # relative stddev of service time
    infer_fn: Optional[Callable] = None   # real JAX inference (measured)
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.busy_until = 0.0
        self.n_processed = 0
        self.ewma_service = None   # fed back to the proportional scheduler
        self.faults = None         # optional serving.faults.ReplicaFaultView

    @property
    def mu_effective(self) -> float:
        t = 1.0 / self.device.mu(self.model.name)
        t += self.model.frame_bytes / INTERFACE_GOODPUT[self.interface]
        return 1.0 / t

    def service_time(self, frame=None, t=None) -> float:
        """Virtual service seconds for one frame; ``t`` (the virtual
        dispatch time, passed by the scheduler) only matters when a
        fault view is attached — injected slowdowns multiply the base
        time and a dead replica reports infinity, which the scheduler's
        timeout rule detects."""
        if self.infer_fn is not None and frame is not None:
            t0 = time.perf_counter()
            self.infer_fn(frame)
            return time.perf_counter() - t0
        s = 1.0 / self.mu_effective
        if self.jitter > 0:
            sigma = self.jitter
            s *= float(self._rng.lognormal(-0.5 * sigma ** 2, sigma))
        if self.faults is not None and t is not None:
            if not self.faults.alive(t):
                return float("inf")
            s *= self.faults.factor(t)
        return s

    def record(self, t_service: float):
        self.n_processed += 1
        a = 0.2
        self.ewma_service = (t_service if self.ewma_service is None
                             else (1 - a) * self.ewma_service + a * t_service)
