"""End-to-end edge video analytics driver on the PyTorch port (the
counterpart of ``examples/video_analytics.py``, step for step):

  1. Train the mini-SSD detector (``repro_torch.detector``) on the
     synthetic benchmark video with plain SGD, each step the autograd
     gradient of ``detector_loss``.
  2. Use the measured per-frame inference time of the trained detector
     (``decode_detections``: the convs, then the NMS kernel on ``cuda``)
     as a real service time.
  3. Stream the video through the parallel detection pipeline
     (scheduler -> n executors -> sequence synchronizer) with the
     tracker on the device, and report the FPS/mAP table across n (the
     paper's Table IV shape) with the track-and-interpolate columns.

  PYTHONPATH=src python examples/video_analytics_torch.py [--steps 150]
      [--device cuda|cpu]

The device defaults to ``cuda`` and the run raises without one; pass
``--device cpu`` to run on the CPU.  Every step of the training runs
with float32 convolutions in IEEE float32 (``device.ieee_float32``) and
deterministic cuDNN algorithms (``device.cudnn_deterministic``), so two
runs on one card give the same losses and weights bit for bit.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import ParallelDetector, SyntheticVideo, choose_n
from repro_torch.core.stream import ETH_SUNNYDAY
from repro_torch.detector import (SSDConfig, decode_detections,
                                  detector_loss, init_ssd, make_anchors)
from repro_torch.device import (cudnn_deterministic, ieee_float32,
                                resolve_device)

LR = 3e-3


def make_batch_fn(video: SyntheticVideo, cfg: SSDConfig, batch: int):
    """The example's batch sampler: ``make_batch(rng)`` draws ``batch``
    frame indices and returns numpy (images (B,S,S,3), boxes (B,K,4) in
    [0,1], classes (B,K) int32, mask (B,K) float32)."""
    spec = video.spec
    K = spec.n_objects

    def make_batch(rng):
        idx = rng.integers(0, spec.n_frames, batch)
        imgs = np.stack([video.pixels(i, cfg.image_size) for i in idx])
        boxes = np.stack([video.boxes_at(i) for i in idx])
        boxes = boxes / np.array([spec.width, spec.height] * 2)
        cls = np.tile(video.classes[None], (batch, 1))
        mask = np.ones((batch, K), np.float32)
        return (imgs.astype(np.float32), boxes.astype(np.float32),
                cls.astype(np.int32), mask)
    return make_batch


def leaves(p):
    """The parameter tensors of a tree, in a fixed order."""
    if isinstance(p, dict):
        return [t for k in sorted(p) for t in leaves(p[k])]
    if isinstance(p, (list, tuple)):
        return [t for v in p for t in leaves(v)]
    return [p]


def rebuild(p, it):
    """``p``'s tree with its leaves taken from the iterator ``it``."""
    if isinstance(p, dict):
        return {k: rebuild(p[k], it) for k in sorted(p)}
    if isinstance(p, (list, tuple)):
        return [rebuild(v, it) for v in p]
    return next(it)


@ieee_float32()
@cudnn_deterministic()
def sgd_step(params, cfg, anchors, imgs, boxes, cls, mask, lr=LR):
    """One plain SGD step, ``p - lr * grad``, the gradient by autograd
    of ``detector_loss`` on one batch of tensors on the parameters'
    device.  Forward, backward and update run inside ``ieee_float32``
    and ``cudnn_deterministic``.  Returns ``(params, loss, parts)``,
    the loss and parts as tensors of the step's parameters."""
    ws = [w.detach().requires_grad_(True) for w in leaves(params)]
    p = rebuild(params, iter(ws))
    loss, parts = detector_loss(p, cfg, imgs, boxes, cls, mask, anchors)
    grads = torch.autograd.grad(loss, ws)
    with torch.no_grad():
        new = [w - lr * g for w, g in zip(ws, grads)]
    return (rebuild(params, iter(new)), loss.detach(),
            {k: v.detach() for k, v in parts.items()})


def train_detector(video: SyntheticVideo, steps: int, batch: int = 8,
                   device=None, params=None, history=None, log=print):
    """Train the mini-SSD on ``video`` for ``steps`` SGD steps at lr
    ``LR`` (batches from ``make_batch_fn`` drawn with numpy seed 0) on
    ``device`` (None: ``cuda``, raising without one).  ``params``
    defaults to ``init_ssd`` from ``torch.Generator`` seed 0; a list
    passed as ``history`` receives each step's ``(loss, box, obj, cls)``
    as floats.  Prints the loss at the reference example's print
    points.  Returns ``(cfg, params, anchors)``, ``anchors`` a tensor on
    the device."""
    dev = resolve_device(device)
    cfg = SSDConfig()
    anchors = torch.from_numpy(make_anchors(cfg)).to(dev)
    if params is None:
        params = init_ssd(cfg, torch.Generator().manual_seed(0), device=dev)
    make_batch = make_batch_fn(video, cfg, batch)
    rng = np.random.default_rng(0)
    for i in range(steps):
        batch_t = [torch.from_numpy(a).to(dev) for a in make_batch(rng)]
        params, loss, parts = sgd_step(params, cfg, anchors, *batch_t)
        shown = i % max(1, steps // 6) == 0 or i == steps - 1
        if history is None and not shown:
            continue              # reading a loss waits for the device
        row = tuple(float(x) for x in (loss, parts["box"], parts["obj"],
                                       parts["cls"]))
        if history is not None:
            history.append(row)
        if shown:
            log(f"  detector step {i:4d} loss={row[0]:.3f} "
                f"(box={row[1]:.3f} obj={row[2]:.3f} cls={row[3]:.3f})")
    return cfg, params, anchors


def inference_ms(params, cfg, anchors, video: SyntheticVideo, n: int = 10):
    """Per-frame wall seconds of ``decode_detections`` on one frame at a
    time (after one warm-up call), the clock read after the device has
    finished: the example's measured service time."""
    dev = anchors.device

    def infer(i):
        img = torch.from_numpy(video.pixels(i)[None]).to(dev)
        return decode_detections(params, cfg, img, anchors)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    infer(0)
    sync()
    t0 = time.perf_counter()
    for i in range(n):
        infer(i)
    sync()
    return (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    video = SyntheticVideo(ETH_SUNNYDAY)
    print(f"== 1. training mini-SSD on synthetic ETH-Sunnyday ({dev}) ==")
    cfg, params, anchors = train_detector(video, args.steps, device=dev)

    print("== 2. measuring real per-frame inference service time ==")
    per_frame = inference_ms(params, cfg, anchors, video)
    print(f"  measured {per_frame*1e3:.1f} ms/frame on {dev} "
          f"({1/per_frame:.1f} FPS) — NCS2 profile stays at 2.5 FPS for "
          f"the virtual-clock runs below")

    print("== 3. parallel detection pipeline across n (Table IV shape) ==")
    lam = video.spec.fps
    print(f"  lambda={lam} FPS, mu=2.5 FPS -> paper rule: n in "
          f"[{choose_n(lam, 2.5)}, {choose_n(lam, 2.5, 'conservative')}]")
    print(f"  {'n':>3s} {'sigma(FPS)':>10s} {'mAP%':>6s} {'trk mAP%':>8s} "
          f"{'cover%':>6s} {'IDsw':>4s} {'drops/proc':>10s}")
    off = ParallelDetector(video.spec, "yolov3", ["ncs2"],
                           device=dev).run(offline=True)
    print(f"  off {off.sigma:10.2f} {off.map_score*100:6.1f} "
          f"{'—':>8s} {'—':>6s} {'—':>4s} {'(zero-drop ref)':>10s}")
    for n in range(1, 8):
        r = ParallelDetector(video.spec, "yolov3", ["ncs2"] * n, "fcfs",
                             device=dev).run(track=True)
        print(f"  {n:3d} {r.sigma:10.2f} {r.map_score*100:6.1f} "
              f"{r.map_tracked*100:8.1f} {r.track_coverage*100:6.1f} "
              f"{r.id_switches:4.0f} {r.drops_per_processed:10.1f}")


if __name__ == "__main__":
    main()
