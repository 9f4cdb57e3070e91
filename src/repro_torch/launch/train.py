"""Training launcher (the port of the reference package's
``launch/train.py``): real training steps of an architecture's config,
AdamW with the WSD schedule for minicpm and cosine otherwise, printing
the reference's lines.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 20

Everything runs on ``--device`` (default ``cuda``, raising where no CUDA
device exists; ``--device cpu`` runs on the CPU).  The sweep of the
full configs over the production meshes is ``launch.dryrun``.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCH_IDS, get_config
from ..data import LMBatchIterator, make_modality_batch
from ..device import resolve_device
from ..optim import AdamWConfig, make_schedule
from ..optim.adamw import tree_leaves
from ..runtime import make_train_step, train_state_init
from ..runtime.checkpoint import restore_checkpoint, save_checkpoint


def _bits(t):
    """A tensor's bytes (NaN equals itself bit for bit)."""
    return t.detach().reshape(-1).view(torch.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b", choices=ARCH_IDS)
    ap.add_argument("--preset", default="smoke")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default=None,
                    help="cosine|wsd (default: wsd for minicpm, else cosine)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, preset=args.preset)
    sched_kind = args.schedule or ("wsd" if "minicpm" in args.arch
                                   else "cosine")
    opt_cfg = AdamWConfig(peak_lr=args.lr)
    schedule = make_schedule(sched_kind, args.lr, args.steps,
                             warmup_steps=max(2, args.steps // 10))
    state = train_state_init(
        cfg, torch.Generator(device=device).manual_seed(0), opt_cfg, device)
    step_fn = make_train_step(cfg, opt_cfg, schedule, remat=False,
                              donate=True)

    if cfg.modality == "text":
        batches = iter(LMBatchIterator(cfg, args.batch, args.seq,
                                       device=device))
        next_batch = lambda i: next(batches)
    else:
        next_batch = lambda i: make_modality_batch(cfg, args.batch,
                                                   args.seq, seed=i,
                                                   device=device)

    t0 = time.time()
    for i in range(args.steps):
        state, metrics = step_fn(state, next_batch(i))
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={float(metrics['total_loss']):.4f} "
                  f"ce={float(metrics['ce_loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"{args.steps} steps in {dt:.1f}s "
          f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")

    if args.checkpoint:
        save_checkpoint(args.checkpoint, state, step=args.steps)
        restored = restore_checkpoint(args.checkpoint, state, device=device)
        for a, b in zip(tree_leaves(state), tree_leaves(restored)):
            if a.dtype != b.dtype or not torch.equal(_bits(a), _bits(b)):
                raise RuntimeError(f"checkpoint round trip changed a leaf "
                                   f"({a.dtype}, {tuple(a.shape)})")
        print(f"checkpoint round-trip OK -> {args.checkpoint}")


if __name__ == "__main__":
    main()
