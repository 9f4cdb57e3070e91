"""Fault-tolerant NVR serving demo on the PyTorch port (the counterpart
of ``examples/fault_tolerant_serving.py``): deterministic chaos,
supervised recovery.

Three legs, all driven by a ``FaultSchedule`` of virtual-time events
(so every run replays bit-identically — re-run with the same seed and
watch the same failures and the same recoveries):

1. **Replica death** on a single host: the scheduler's timeout rule
   detects the dead replica (a dispatcher never sees "dead", only "no
   completion within k x the expected service"), fails the in-flight
   frame over, and the lockstep tracker coasts whatever the shrunken
   pool drops — full per-stream coverage, quality degrading gracefully.
2. **Whole-shard death** on a 2-shard epoch-loop deployment: frames
   arriving while the shard is down are lost (accounted as drops,
   never a silent gap); the ``Watchdog`` notices the missed heartbeat
   at the next epoch boundary, restarts the shard, and evacuates its
   cameras to live shards — every stream back at full coverage within
   one epoch.
3. **Replica lending**: ONE 30 fps camera overloads shard 0 while
   shard 1 idles.  Stream migration refuses to act (moving the only
   stream would just relocate the overload), so the watchdog lends
   shard 1's tail replica to shard 0 and takes it back once the
   pressure clears — strictly fewer drops, pools restored by serve end.

  PYTHONPATH=src python examples/fault_tolerant_serving_torch.py
      [--cameras 4] [--frames 48] [--seed 0] [--device cuda|cpu]

The trackers run on ``--device`` (default ``cuda``, raising without
one; ``--device cpu`` runs on the CPU).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import evaluate_streams, proxy_detect_fn_streams
from repro_torch.serving import (DetectionEngine, FaultSchedule, FrameRequest,
                           ShardedDetectionEngine, Watchdog,
                           make_nvr_streams)


def leg_replica_death(n_cameras, n_frames, device):
    frames, frame_of, videos, dets = make_nvr_streams(n_cameras,
                                                      n_frames, rate=4.0)
    oracle = proxy_detect_fn_streams(videos, dets, frame_of)
    kw = dict(detect_fn=oracle, n_replicas=2, service_time=0.05,
              track_and_interpolate=True, device=device)
    horizon = n_frames / 4.0
    sched = FaultSchedule.replica_kill(horizon / 3, replica=1)
    print(f"== leg 1: replica 1 of 2 dies at t={horizon / 3:.1f}s "
          f"(never revives) ==")
    print(f"  {'run':>10s} {'cover%':>6s} {'interp':>6s} {'mAP%':>6s} "
          f"{'retries':>7s} {'failovers':>9s}")
    reps = {}
    for name, faults in (("fault-free", None), ("replica-kill", sched)):
        rep = reps[name] = DetectionEngine(faults=faults, **kw).serve(frames)
        q = evaluate_streams(videos, rep["streams"], n_frames)
        print(f"  {name:>10s} {rep['coverage'] * 100:6.1f} "
              f"{rep['interpolated']:6d} {q['map_mean'] * 100:6.1f} "
              f"{sum(rep['retries'].values()):7d} "
              f"{sum(rep['failovers'].values()):9d}")
        assert rep["coverage"] == 1.0   # the tracker coasts the losses
    return reps


def leg_shard_death(n_cameras, n_frames, device):
    frames, frame_of, videos, dets = make_nvr_streams(n_cameras,
                                                      n_frames, rate=4.0)
    oracle = proxy_detect_fn_streams(videos, dets, frame_of)
    kw = dict(detect_fn=oracle, n_replicas=2, service_time=0.02,
              n_shards=2, rebalance=True, epoch_s=2.0,
              track_and_interpolate=True, device=device)
    sched = FaultSchedule.shard_kill(2.5, shard=0)
    print("== leg 2: shard 0 of 2 dies at t=2.5s (epoch_s=2.0) ==")
    print(f"  {'run':>12s} {'drops':>5s} {'lost':>4s} {'recov_cov':>9s} "
          f"{'restarts':>8s} {'evacuations':>11s}")
    reps = {}
    for name, sup in (("unsupervised", None), ("watchdog", Watchdog())):
        rep = reps[name] = ShardedDetectionEngine(
            faults=sched, supervisor=sup, **kw).serve(frames)
        fl = rep["faults"]
        evac = [m for m in rep["migrations"] if m["src"] == 0]
        print(f"  {name:>12s} {len(rep['dropped']):5d} "
              f"{fl['frames_lost_shard']:4d} "
              f"{rep['recovered_coverage']:9.2f} "
              f"{len(fl['restarts']):8d} {len(evac):11d}")
    for r in fl["restarts"]:
        print(f"  watchdog: restarted shard {r['shard']} at boundary "
              f"t={r['t']:.1f} (epoch {r['epoch']}, ok={r['ok']})")
    for m in evac:
        print(f"  watchdog: evacuated camera {m['stream']} "
              f"{m['src']}->{m['dst']} at epoch {m['epoch']}")
    assert rep["recovered_coverage"] == 1.0
    return reps


def leg_lending(device):
    def stub(images, rids=None):
        b = len(images)
        return (np.zeros((b, 4, 4), np.float32),
                np.zeros((b, 4), np.float32),
                np.zeros((b, 4), np.int32), np.zeros((b, 4), bool))

    events = [(k / 30.0, 0, k) for k in range(240)]
    events += [(k + 0.5, 1, k) for k in range(8)]
    events.sort()
    frames = [FrameRequest(rid, np.zeros((4, 4, 3), np.float32), t,
                           stream_id=s)
              for rid, (t, s, k) in enumerate(events)]
    kw = dict(detect_fn=stub, n_replicas=2, service_time=0.1,
              drop_when_busy=True, micro_batch=1, max_micro_batch=1,
              n_shards=2, rebalance=True, epoch_s=2.0, device=device)
    print("== leg 3: one 30 FPS camera on shard 0, shard 1 idle "
          "(drop mode) ==")
    print(f"  {'run':>12s} {'drops':>5s} {'cover%':>6s} "
          f"{'migrations':>10s} {'loans':>5s}")
    reps = {}
    for name, sup in (("unsupervised", None),
                      ("lending", Watchdog(idle_backlog_s=0.5))):
        rep = reps[name] = ShardedDetectionEngine(supervisor=sup,
                                                  **kw).serve(frames)
        loans = rep.get("faults", {}).get("loans", [])
        print(f"  {name:>12s} {len(rep['dropped']):5d} "
              f"{rep['coverage'] * 100:6.1f} "
              f"{len(rep['migrations']):10d} {len(loans):5d}")
    for ln in loans:
        print(f"  watchdog: shard {ln['lender']} lent a replica to "
              f"shard {ln['borrower']} at epoch {ln['epoch']}, "
              f"returned at epoch {ln['returned_epoch']}")
    return reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for the bonus random-chaos leg")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    results = {"replica_death": leg_replica_death(args.cameras, args.frames,
                                                  dev),
               "shard_death": leg_shard_death(args.cameras, args.frames,
                                              dev),
               "lending": leg_lending(dev)}

    # bonus: seeded random chaos — same seed, same failures, same
    # recoveries, bit-identical report (run it twice to check)
    frames, frame_of, videos, dets = make_nvr_streams(
        args.cameras, args.frames, rate=4.0)
    sched = FaultSchedule.random(args.seed, args.frames / 4.0,
                                 n_shards=2, n_replicas=2,
                                 n_replica_events=2, n_shard_events=1)
    eng = ShardedDetectionEngine(
        detect_fn=proxy_detect_fn_streams(videos, dets, frame_of),
        n_replicas=2, service_time=0.02, n_shards=2, rebalance=True,
        epoch_s=2.0, track_and_interpolate=True, faults=sched,
        supervisor=Watchdog(), device=dev)
    r1, r2 = eng.serve(frames), eng.serve(frames)
    assert r1["faults"] == r2["faults"]
    print(f"== bonus: seeded chaos (seed={args.seed}) — "
          f"{len(sched)} events, {len(r1['faults']['restarts'])} "
          f"restarts, {len(r1['faults']['loans'])} loans, "
          f"recovered_coverage={r1['recovered_coverage']:.2f}, "
          "replays bit-identically ==")
    results["chaos"] = r1
    return results


if __name__ == "__main__":
    main()
