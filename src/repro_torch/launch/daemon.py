"""Always-on NVR serving daemon: drive ``ServingRuntime`` from a clock
(the port of the reference package's ``launch/daemon.py``).

The batch launchers (``launch/serve.py``) hand a full frame trace to
``eng.serve(frames)`` and wait.  The daemon is the long-lived shape of
the same computation: frames are ingested as they *arrive* on a
pluggable clock, the runtime advances its virtual time to the clock
(never past a frame not yet ingested, however far the clock ran ahead),
per-epoch rolling reports stay available mid-run, and every trace
event streams to subscribers (JSONL on disk, counters, …) the moment
it is recorded.  On shutdown the runtime drains in-flight frames and
the final report is bit-identical to what a one-shot batch
``serve(frames)`` would have produced on the same trace.

Two clocks:

* ``VirtualClock`` — ``sleep_until`` jumps instantly.  Tests and CI
  replay a whole trace in milliseconds, deterministically.
* ``WallClock`` — ``sleep_until`` really sleeps, anchored at daemon
  start.  Real runs pace ingest at the trace's arrival rate.

The serving *simulation* itself always runs on the virtual timeline
(``t_arrival`` seconds); the clock only decides how fast the daemon
walks that timeline.

Smoke run (finishes instantly, writes one JSON object per event)::

  PYTHONPATH=src python -m repro_torch.launch.daemon --cameras 4 \\
      --frames 16 --shards 2 --clock virtual --events events.jsonl

The engines' trackers run on ``--device`` (default ``cuda``, raising
where no CUDA device exists; ``--device cpu`` runs the plain versions of
the kernels), so on the card the assignment kernel runs in every
tracker tick.

Graceful shutdown: SIGINT/SIGTERM (wall runs) stop ingest after the
current chunk; frames already ingested are drained, audited, and
reported — never dropped on the floor.
"""
from __future__ import annotations

import argparse
import signal
import time


class VirtualClock:
    """A clock whose ``sleep_until`` jumps: ``now()`` is simply the
    largest time ever slept to.  Deterministic; replays any trace at
    CPU speed.  This is the clock for tests and CI."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def sleep_until(self, t: float):
        if t > self._now:
            self._now = float(t)


class WallClock:
    """Real time, anchored at construction: ``now()`` is seconds since
    the daemon started, ``sleep_until(t)`` blocks until that many
    seconds have really elapsed.  Paces ingest at the trace's own
    arrival rate for live runs."""

    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def sleep_until(self, t: float):
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


class ServingDaemon:
    """Long-lived driver: ingest frames as the clock reaches their
    arrival times, advance the runtime behind the clock, drain on
    shutdown.

    ``runtime`` is a constructed ``ServingRuntime`` (any engine);
    ``clock`` anything with ``now()`` / ``sleep_until(t)``.  ``run``
    consumes an iterable of ``FrameRequest`` in arrival order, ingests
    them in chunks of ``chunk`` frames (frames whose arrival times tie
    always travel in one chunk — the runtime's watermark contract),
    and returns the final drained report.  ``request_stop()`` (also
    wired to SIGINT/SIGTERM by the CLI) makes ``run`` stop ingesting
    after the current chunk and fall through to ``shutdown()``.
    """

    def __init__(self, runtime, clock=None, chunk: int = 1):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.runtime = runtime
        self.clock = clock if clock is not None else VirtualClock()
        self.chunk = chunk
        self.frames_ingested = 0
        self._stop = False

    def request_stop(self):
        """Ask ``run`` to stop ingesting after the current chunk; the
        frames already ingested still drain.  Safe from a signal
        handler."""
        self._stop = True

    def run(self, frames) -> dict:
        """Pace ``frames`` (arrival order) through the runtime and
        return the drained final report."""
        pending = []
        for f in frames:
            if self._stop:
                break
            if pending and (len(pending) >= self.chunk
                            and f.t_arrival != pending[-1].t_arrival):
                self._flush(pending, f.t_arrival)
                pending = []
            pending.append(f)
        if pending and not self._stop:
            self._flush(pending)
        return self.shutdown()

    def _flush(self, chunk, next_arrival=float("inf")):
        """Ingest ``chunk`` at its arrival time and advance the runtime
        to the clock, but never past ``next_arrival``, the arrival of the
        first frame not yet ingested: a clock that ran ahead of the trace
        (a slow host on the ``WallClock``) must not seal a micro-batch
        without frames that arrived meanwhile."""
        self.clock.sleep_until(chunk[-1].t_arrival)
        self.runtime.ingest(chunk)
        self.runtime.advance(min(self.clock.now(), next_arrival))
        self.frames_ingested += len(chunk)

    def shutdown(self) -> dict:
        """Drain in-flight frames and return the final report (bit-
        identical to a one-shot batch ``serve`` of everything
        ingested)."""
        return self.runtime.drain()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="always-on NVR detection daemon (incremental "
                    "serving core + event pipeline)")
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--frames", type=int, default=24,
                    help="frames per camera in the synthetic trace")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--n-replicas", type=int, default=2)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="per-camera arrival FPS")
    ap.add_argument("--clock", default="virtual",
                    choices=["virtual", "wall"],
                    help="virtual: replay instantly (tests/CI); wall: "
                         "pace ingest in real time")
    ap.add_argument("--chunk", type=int, default=1,
                    help="frames ingested per runtime call")
    ap.add_argument("--events", default=None, metavar="OUT.jsonl",
                    help="stream every trace event as one JSON line")
    ap.add_argument("--rebalance", action="store_true",
                    help="epoch-boundary rebalancing (shards >= 2)")
    ap.add_argument("--epoch-s", type=float, default=4.0)
    ap.add_argument("--watchdog", action="store_true",
                    help="supervise epoch boundaries with the Watchdog "
                         "(implies --rebalance)")
    ap.add_argument("--device", default="cuda",
                    help="where the trackers run (cuda or cpu)")
    args = ap.parse_args(argv)

    from ..core import proxy_detect_fn_streams
    from ..obs import audit_recorder
    from ..serving import (EventBus, JsonlSink, ServingRuntime,
                           ShardedDetectionEngine, Watchdog,
                           make_nvr_streams)
    from ..serving.pipeline import sorted_chunk  # arrival order

    if args.watchdog:
        args.rebalance = True

    frames, frame_of, videos, dets = make_nvr_streams(
        args.cameras, args.frames, args.rate)
    frames = sorted_chunk(frames)

    bus = EventBus()
    sink = None
    if args.events:
        sink = JsonlSink(args.events)
        bus.subscribe(sink)
    recorder = bus.recorder()

    eng = ShardedDetectionEngine(
        n_shards=args.shards,
        detect_fn=proxy_detect_fn_streams(videos, dets, frame_of),
        service_time=0.4, n_replicas=args.n_replicas,
        track_and_interpolate=True, rebalance=args.rebalance,
        epoch_s=args.epoch_s,
        supervisor=Watchdog() if args.watchdog else None,
        recorder=recorder, device=args.device)
    rt = ServingRuntime(eng, streams=range(args.cameras))
    clock = VirtualClock() if args.clock == "virtual" else WallClock()
    daemon = ServingDaemon(rt, clock=clock, chunk=args.chunk)

    if args.clock == "wall":
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: daemon.request_stop())

    out = daemon.run(frames)
    if sink is not None:
        sink.close()

    print(f"daemon clock={args.clock} cameras={args.cameras} "
          f"shards={out['n_shards']} ingested={daemon.frames_ingested} "
          f"pending={rt.frames_pending}")
    print(f"coverage={out['coverage']:.3f} dropped={len(out['dropped'])} "
          f"throughput={out['throughput_fps']:.2f} fps "
          f"p95_latency={out['p95_latency']*1e3:.1f} ms")
    print("events: " + "  ".join(
        f"{topic}={bus.counts.get(topic, 0)}"
        for topic in sorted(bus.counts)))
    if sink is not None:
        print(f"events -> {args.events} ({sink.n_written} lines)")

    res = audit_recorder(recorder)
    print(f"audit={'ok' if res.ok else 'FAIL'} "
          f"({len(recorder.events)} events)")
    if not res.ok:
        for v in res.violations[:5]:
            print(f"  audit violation: {v}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
