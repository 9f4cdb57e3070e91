"""Sharding rules for the detection-serving surface (the port of the
reference package's ``sharding/serving_rules.py``).

Logical layout
--------------
Every serving tensor is batch-major with the micro-batch (frame) dim
first, and that dim carries the ``replica`` axis — the paper's "n
parallel detection models".  In the port a *mesh* is a sequence of
torch devices (``("cuda:0",)``, ``("cuda:0", "cuda:1")``, or CPU
devices in the tests).  A micro-batch of B frames splits into
contiguous blocks of ``B / n`` frames, block ``i`` on ``mesh[i]``, when
the mesh's ``n`` devices divide B (the reference's NamedSharding block
layout, not round-robin); otherwise the divisibility fallback keeps the
whole batch on the first device, as the reference keeps it replicated.
All trailing dims (pixels, anchor slots, box coords) stay whole:
detection is embarrassingly parallel across frames.

``constrain_frames`` places a micro-batch of images on the mesh and
``constrain_detections`` gathers the detections back in block order, so
``serving.sharded.make_spmd_detect`` can run the unchanged
``detector.decode_detections`` on every block.

Camera partition
----------------
``shard_streams`` is the static assignment of camera ids to shards that
``ShardedDetectionEngine`` uses to split the NVR request trace.  It is
deterministic (sorted round-robin), so two hosts computing the
partition independently agree on it.

``rebalance_streams`` is the runtime correction to that static split —
the cross-shard work-stealing rule.  It consumes only *observations*
(per-shard drop counts, backlog horizons, per-stream frame counts from
one served epoch) and is a pure deterministic function of them, so
every host replaying the same epoch report computes the same
migration without coordinating.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from ..device import resolve_device


def mesh_devices(mesh) -> List[torch.device]:
    """The mesh's devices, each through ``device.resolve_device`` (None
    means ``cuda``; ``cuda`` raises where no CUDA device exists)."""
    devices = [resolve_device(d) for d in mesh]
    if not devices:
        raise ValueError("a serving mesh needs at least one device")
    return devices


def frame_blocks(B: int, n: int) -> List[Tuple[int, int]]:
    """The ``[start, stop)`` frame ranges of a micro-batch of ``B``
    frames over ``n`` mesh devices: ``n`` contiguous blocks of ``B / n``
    when ``n`` divides ``B``, else one block of all ``B`` (on the first
    device).

    >>> frame_blocks(8, 2)
    [(0, 4), (4, 8)]
    >>> frame_blocks(6, 4)
    [(0, 6)]
    """
    if n > 1 and B % n == 0:
        k = B // n
        return [(i * k, (i + 1) * k) for i in range(n)]
    return [(0, B)]


def constrain_frames(images: torch.Tensor, mesh) -> List[torch.Tensor]:
    """A micro-batch of images ``(B, S, S, 3)`` placed on the mesh: one
    tensor per block of ``frame_blocks``, block ``i`` on the mesh's
    ``i``-th device (all of it on the first device under the
    divisibility fallback)."""
    devices = mesh_devices(mesh)
    return [images[a:b].to(devices[i])
            for i, (a, b) in enumerate(frame_blocks(images.shape[0],
                                                    len(devices)))]


def constrain_detections(blocks) -> Tuple[torch.Tensor, ...]:
    """Per-block detection tuples ``(boxes (b,D,4), scores (b,D),
    classes (b,D), valid (b,D))`` gathered back into one batched tuple in
    block order, on the first block's device — the output side of
    ``constrain_frames``."""
    dev = blocks[0][0].device
    return tuple(torch.cat([blk[j].to(dev) for blk in blocks], 0)
                 for j in range(len(blocks[0])))


def shard_streams(stream_ids: Iterable[int],
                  n_shards: int) -> Dict[int, int]:
    """Deterministic partition of camera ids over ``n_shards`` shards.

    Sorted round-robin: camera ranks are assigned modulo the shard
    count, so shard loads differ by at most one camera and the mapping
    depends only on the *set* of ids (any two hosts agree on it
    without communicating).

    >>> shard_streams([3, 0, 2, 1], 2)
    {0: 0, 1: 1, 2: 0, 3: 1}
    >>> shard_streams([7], 4)
    {7: 0}
    >>> shard_streams([], 2)
    {}
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    sids = sorted(set(int(s) for s in stream_ids))
    return {sid: i % n_shards for i, sid in enumerate(sids)}


def streams_of_shard(shard_of: Dict[int, int], shard: int) -> List[int]:
    """The sorted camera ids assigned to ``shard`` by ``shard_streams``.

    >>> streams_of_shard({0: 0, 1: 1, 2: 0, 3: 1}, 0)
    [0, 2]
    """
    return sorted(s for s, h in shard_of.items() if h == shard)


def rebalance_streams(shard_of: Dict[int, int], loads: Sequence[Dict],
                      max_moves: int = 1, evacuate: Sequence[int] = ()
                      ) -> Tuple[Dict[int, int], List[Tuple[int, int, int]]]:
    """Cross-shard work stealing: migrate whole camera streams from the
    most pressured shard to the least pressured one, based on one served
    epoch's observations.

    ``loads[h]`` is shard ``h``'s observation for the epoch:

    * ``drops``     — frames shard ``h`` dropped (the primary pressure
      signal: the paper's rate-mismatch pathology made visible);
    * ``backlog_s`` — residual committed service at the epoch's end
      (``DetectionEngine.backlog_snapshot``: pressure that has not yet
      turned into drops — the early-warning signal);
    * ``frames``    — ``{stream_id: frames observed this epoch}``, the
      per-stream arrival-rate estimate migrations are sized by.

    Policy (rationale):

    1. *Donor* = lexicographically max ``(drops, backlog_s)`` shard,
       *receiver* = min; a move requires donor pressure STRICTLY above
       receiver pressure, so a balanced system never churns.
    2. Candidate streams are the donor's, heaviest observed first (the
       fastest camera is the one whose departure relieves the most
       rate mismatch), ties broken by lowest stream id.
    3. A candidate only moves if ``receiver_load + stream <
       donor_load`` in observed frames — the move must strictly shrink
       the maximum per-shard load, which rules out ping-ponging a hot
       stream between shards and refuses "moves" that just relocate
       the overload (e.g. a donor with a single hot stream).
    4. At most ``max_moves`` migrations per call (whole streams only —
       a stream's frames never split across shards inside an epoch, so
       per-stream ordering survives migration untouched).

    Forced evacuation (``evacuate=``): the watchdog's re-homing path.
    Shards listed in ``evacuate`` are treated as DEAD — every stream
    they own is re-homed before the stealing phase runs, heaviest
    observed first, each to the live shard with the least observed
    load at that point (ties by lowest shard id).  Unlike stealing,
    evacuation is unconditional: rule 3's strict-improvement gate does
    not apply (there is no "keeping it where it is" when the shard is
    down), evacuation moves do not count against ``max_moves``, and
    evacuated shards are excluded from the stealing phase entirely
    (their epoch observations describe a dead host — neither a
    credible donor nor a restart-fresh receiver this boundary).

    Deterministic: every choice is totally ordered (ties fall back to
    shard/stream ids), and only the observation values matter — not
    dict insertion order — so replicas that saw the same epoch report
    agree on the migration without communicating.

    Returns ``(new_shard_of, moves)`` with ``moves`` a list of
    ``(stream_id, src_shard, dst_shard)`` (evacuation moves first);
    the input mapping is not mutated.

    >>> of = {0: 0, 2: 0, 4: 0, 1: 1, 3: 1, 5: 1}
    >>> loads = [{"drops": 9, "backlog_s": 3.0,
    ...           "frames": {0: 16, 2: 16, 4: 16}},
    ...          {"drops": 0, "backlog_s": 0.0,
    ...           "frames": {1: 8, 3: 8, 5: 8}}]
    >>> rebalance_streams(of, loads)
    ({0: 1, 2: 0, 4: 0, 1: 1, 3: 1, 5: 1}, [(0, 0, 1)])
    >>> balanced = [{"drops": 0, "backlog_s": 0.0, "frames": {0: 8}},
    ...             {"drops": 0, "backlog_s": 0.0, "frames": {1: 8}}]
    >>> rebalance_streams({0: 0, 1: 1}, balanced)
    ({0: 0, 1: 1}, [])
    """
    n = len(loads)
    shard_of = dict(shard_of)
    moves: List[Tuple[int, int, int]] = []
    # per-stream observed frames (each stream served by exactly one
    # shard per epoch; the count rides along when the stream moves)
    stream_frames: Dict[int, int] = {}
    for load in loads:
        for sid, c in load["frames"].items():
            stream_frames[sid] = stream_frames.get(sid, 0) + int(c)
    pressure = [(int(load["drops"]), float(load["backlog_s"]))
                for load in loads]
    dead = set(int(h) for h in evacuate)
    live = [h for h in range(n) if h not in dead]
    if dead and not live:
        raise ValueError("cannot evacuate every shard: no live shard "
                         "left to re-home the streams onto")
    # -- phase 0: forced evacuation of dead shards (watchdog re-homing)
    for h in sorted(dead):
        doomed = sorted((sid for sid, hh in shard_of.items() if hh == h),
                        key=lambda sid: (-stream_frames.get(sid, 0), sid))
        for sid in doomed:
            shard_load = {r: sum(stream_frames.get(s, 0)
                                 for s, x in shard_of.items() if x == r)
                          for r in live}
            recv = min(live, key=lambda r: (shard_load[r], r))
            shard_of[sid] = recv
            moves.append((sid, h, recv))
    # -- stealing phase (live shards only)
    for _ in range(max_moves):
        shard_load = [sum(stream_frames.get(sid, 0)
                          for sid, h in shard_of.items() if h == hh)
                      for hh in range(n)]
        donor = max(live, key=lambda h: (pressure[h], shard_load[h],
                                         -h))
        recv = min(live, key=lambda h: (pressure[h], shard_load[h],
                                        h))
        if donor == recv or pressure[donor] <= pressure[recv]:
            break                        # no pressure gradient -> stable
        cands = sorted((sid for sid, h in shard_of.items()
                        if h == donor and stream_frames.get(sid, 0) > 0),
                       key=lambda sid: (-stream_frames[sid], sid))
        moved = None
        for sid in cands:
            if shard_load[recv] + stream_frames[sid] < shard_load[donor]:
                moved = sid
                break
        if moved is None:
            break                        # every move would just relocate it
        shard_of[moved] = recv
        moves.append((moved, donor, recv))
    return shard_of, moves
