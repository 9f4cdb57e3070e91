"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure exits non-zero and prints no result:

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a into ``build/kernels`` (one nvcc per source, in parallel,
   each with its own flags: ``kernels.build.flags``), print ptxas's
   registers and spills of every instance, and check the identity the
   flash kernel's bf16 bit check rests on: on the tensor cores, D = 0 . B
   + C returns C bit for bit (``check_mma_zero_identity``);
2. hold each kernel against its plain PyTorch version on the card, at
   the serving path's shapes and at edge cases: NMS ``keep``/``valid``,
   the assignment's ``match``, the ROI crops and the uncropped boxes
   must be exactly equal (tolerance 0); the NMS cases include the
   kernel's own candidate sort at score ties, -0.0 beside 0.0, NaN
   scores and A=2400; the crop cases a one-frame batch, rows that are not
   16-byte multiples, one-pixel windows and 70,000 windows; the uncrop
   cases rois read through partial broadcasts and the serve's views, and
   more than ``roi.MAX_ROI_RANK`` leading dims refused before launch.
   Times the kernel, its plain version, and works out the least time the
   card could take; the assignment (B=1, 4, 8), crop and uncrop (B=1, 8)
   also by the profiler's device time a call (``[profile assign]``,
   ``[profile roi]``), where each call must launch its one kernel;
3. serve an NVR trace (4 cameras x 32 frames of ``SyntheticVideo``
   pixels), with the process-wide TF32 settings left at PyTorch's
   defaults (printed; the port holds its convs in IEEE float32 itself),
   through ``repro_torch``'s ``DetectionEngine(
   track_and_interpolate=True)`` on ``cuda`` with the real mini-SSD
   (random weights from a seed): coverage must be 1.0 and the NMS and
   assignment launch counters, zeroed just before the serve, > 0;
4. serve the same frames through the transprecise cascade
   (``catalog=paper_catalog(CASCADE_HEAVY_S)``, ``roi=True``): coverage
   1.0, at least one model switch, ROI passes, crop and uncrop launches
   equal to the ROI micro-batches and NMS launches equal to the first-
   and second-pass micro-batches, all counted from zero just before the
   serve; the report must equal the same serve on ``device="cpu"``;
5. check the served paths against the CPU on the oracle detectors
   (NVR and cascade) and on a short mini-SSD NVR trace: the same
   schedule, detections and track ids; and batch-size invariance on the
   card: the same 20 frames at ``micro_batch`` 1 and 5 give equal
   ``valid``, classes, keep order and track ids, and boxes and scores
   within ``BATCH_ATOL`` (the largest difference is printed);
6. the seed NMS path: ``ops.nms_serial`` (IoU matrix kernel + A-step
   greedy loop) and ``ops.nms`` (batched NMS kernel at B=1) on each of
   8 frames of mini-SSD candidates (A=160), counted from zero; both
   must equal ``ops.batched_nms`` over the 8 frames and the same calls
   on ``device="cpu"`` exactly, and the IoU kernel must equal its plain
   version exactly at 160x160, 256x256, 300x17, 1x1, SSD300's
   8732x8732 anchors, and rows that do not start on 16 bytes (161x157,
   300x333) or a single row or column (1x5, 5x1); its device time a
   call at 160x160 and 8732x8732 (``[profile iou]``, one kernel a call);
7. the attention and scan kernels at the widths of models the repo
   supports, counted from zero: ``ops.flash_attention`` at qwen3-4b
   (H=32, D=128; T=S=2048 causal in bf16 and f32, a cached prefix
   T=128 S=2048 in bf16, non-causal T=256 S=128 in f32),
   ``ops.decode_attention`` at qwen3-4b (B=4, H=32, KV=8, S=32768,
   bf16) and in f32 MQA (2,8,1,512,128) and MHA (2,16,16,1024,64),
   ``ops.rwkv_scan`` at rwkv6-3b (B=4, H=40, hs=64, T=2048, bf16 and
   f32) and at T=100, hs=32, plus small bf16 cases for the template
   instances those do not reach (flash D=64, D=32 with S < T and D=36,
   decode D=256, S=100 and D=36 with G=16, the scan at hs=256, 128, 36
   and 16; D=36 takes the kernels' scalar loads), and flash float32's
   accuracy margin, not timed: a T=256 query block on a 32768 cache,
   checked like the others, and T=S=2048 with q scaled until |q.k.scale|
   reaches ``LARGE_LOGIT``, measured against the plain version and
   float64 but not held to 2e-5 (float32's own rounding of logits near
   60 exceeds it; PERF.md).  Each float32 result
   is within the reference's float32 kernel tolerance of the plain
   version on the same inputs (rtol = atol = 2e-5, five times that for
   the RWKV state).  A bf16 case is held before its one rounding: on the
   inputs widened to float32, the kernel's float32 instance must round
   to the bf16 results bit for bit and be within that tolerance of the
   plain version's float32 result.  Last, each width limit that remains
   (flash D <= 128, decode D <= 256, the scan hs <= 512) must raise a
   ValueError one past it, on CUDA tensors, with no launch counted;
   then ``[moe-experts]``: the routed-experts kernel (table row 9, no TPU
   kernel) at grok-1's (E=8, C=4, 6144 -> 32768) and DeepSeek-V3's
   (8 held experts, C=4, 7168 -> 2048) decode dispatch in bf16 with 0,
   1 and 2 touched experts, within ``MOE_RTOL`` + ``MOE_ATOL_SHARE`` of
   the plain version, every empty slot zero, two calls bit-equal, two
   launches a call; its wrapper and the kernel alone timed beside the
   bound (the touched experts' bytes), the plain version and the three
   ``torch.bmm`` products; and its launches counted inside a served
   decode (grok-1's smoke preset, graphs replayed: two a call at each MoE
   layer of every decode step, none in its prefill of 12 slots an
   expert); then ``[mla-decode]``: the MLA decode kernel (table row 10,
   no TPU kernel) at dsv3-decode's shapes (``MLA_SHAPE``: 128 heads,
   kv_lora 512, rope 64, a ring of 4,608 slots) with 1,000, 2,350 and
   4,608 filled, bf16, within ``MLA_RTOL`` + ``MLA_ATOL_SHARE`` of the
   plain version, two calls bit-equal, three launches a call, NaN in
   every slot outside the mask changing nothing; its wrapper, the kernel
   alone (replayed from a CUDA graph, cold after ``L2_FLUSH_BYTES``
   written and warm) and the plain version timed beside the least time
   (bytes at 3.35 TB/s against the operations as the kernel runs them:
   bf16 tensor-core products at 989 TFLOP/s, P's three pieces counted,
   and float32 multiply-adds at 67 TFLOP/s); and
   its launches counted inside a served decode (DeepSeek-V3's smoke
   preset, graphs replayed: three a call at each MLA layer of every
   decode step);
8. the fused tracker tick (``[fused]``), the only tick the engines
   have: the NVR serve of phase 3, each tick one CUDA-graph replay,
   counted from zero: one capture, a replay a tick, and
   ``greedy_assign`` launches equal to (1 warm-up + the replays) x the
   launches captured; its report equal exactly to the same serve with
   each tick run by the staged chain of the ``tracking`` functions on
   the card (``staged_chain``) and to a second fused serve, and the
   tracker's host wall (``stage_ms_track``) of each;
   ``pipeline.fused_window`` (K=8, B=4, D=32) equal to the staged chain
   on the card bit for bit in one replay, timed against K staged-chain
   ticks that return the same outputs to the host; under ``--profile``,
   the tracker stage of the serve replayed under the profiler (copies
   and device events a tick);
9. the paper's pipeline (``[parallel]``): ``ParallelDetector(
   "ETH-Sunnyday", "yolov3", ["ncs2"] * n).run(track=True)`` for n = 1..7
   on the card, counted from zero (one assignment launch a processed
   frame), each Table IV row printed and held against the same run on
   ``device="cpu"``: every field exact but ``map_tracked``, within 1e-6;
   the assignment calls of the n = 1 run recorded and the kernel held
   exactly against its plain version on them;
10. the detector's training (``[train]``): the SGD loop of
   ``examples/video_analytics_torch.py`` (loaded by path) at its own
   settings, ``SSDConfig()``, batch 8, 150 steps on ETH-Sunnyday from
   ``init_ssd`` seed 0, twice on the card (every loss and weight equal
   bit for bit: IEEE float32 and deterministic cuDNN inside each step)
   and once on the CPU (each step's loss and parts within
   ``TRAIN_RTOL``), ms a step printed, the TF32 switches as found and
   unchanged after; then on the card in chunks of 150 steps up to 600
   (after 150 every score can sit above the 0.4 threshold); each
   checkpoint's detector decodes 8 frames (valid detections a frame
   printed; the NMS kernel exact against its plain version on its
   candidates), and the example's per-frame inference time; NMS
   launches = a decode a checkpoint + 11 timed calls;
11. sharded serving (``[sharded]``) with the first checkpoint whose NMS
   ends on a score tail (0 < valid < max_out on a frame): 8 cameras x
   24 frames at 30 frames/s, 2 replicas a shard at the pinned 25 ms;
   ``ShardedDetectionEngine`` with 1, 2 and 4 static shards, each also
   with the one-device mesh (equal bit for bit), 1 shard equal to
   ``DetectionEngine`` exactly; rebalancing on the skewed trace
   (``make_skewed_streams``, 2 shards, 0.2 s epochs, a migration); a
   shard kill and a replica kill under ``Watchdog()`` (a restart, lost
   frames, retries); each against ``device="cpu"`` (``close_report``,
   floats within ``FORWARD_ATOL``), and the rebalancing serve equal
   exactly to the same serve with its ticks run by the staged chain on
   the card. Counted from zero for each serve: NMS launches = the
   recorder's micro-batches over shards and epochs; assignment launches
   = (1 warm-up + replays) x captured a graph (graphs printed); ticks +
   coasts = ``tracker_launches``; the host wall and the valid detections
   a detected frame of each serve printed;
12. after the profile passes, the three IoU kernels on boxes with NaN,
   +-inf and -0.0 coordinates (``[nan]``): the IoU matrix, NMS (the
   example of a NaN box beside two overlapping ones, and mini frames
   with such boxes) and the assignment (a NaN in a live pair, in a masked
   slot, infinite sides, -0.0 corners; iou_thr -1, 0, 0.3, 1), each
   equal to its plain version with NaN at the same places
   (``same_nan``); every case runs before the phase fails on any.
13. the always-on daemon (``[daemon]``, after ``[sharded]``, with its
   weights): ``launch.daemon.ServingDaemon`` over the rebalancing
   sharded engine with the fused tick (8 cameras of the skewed trace, 2
   shards, 0.2 s epochs, ``Watchdog()``), ``recorder=bus.recorder()`` of
   an ``EventBus`` with a ``JsonlSink``, on the ``VirtualClock`` at
   chunks of 1 and 4 frames: each report equal to one batch ``serve`` on
   the card exactly and to the same daemon on ``device="cpu"`` within
   ``FORWARD_ATOL``; bus counts by topic and JSONL lines equal to the
   CPU run's; ``audit_recorder`` ok, and the Chrome export, read back
   through ``events_from_chrome``, audits to the same stats; NMS
   launches = micro-batches, assignment launches = (1 warm-up + replays)
   x captured; the tick graphs (printed) no more than the distinct
   camera counts of the trace's (epoch, shard) segments, each graph's B
   one of them; then the same trace on a ``WallClock`` (chunk 4): the
   report equal to the virtual one, its wall printed; then
   ``launch.daemon``'s and ``launch.serve --payload frames --spmd
   --trace``'s ``main`` on the card, each ending with audit ok, and
   ``tools/check_trace_torch.py`` exiting 0 on the written trace;
14. token serving (``[llm]``): qwen3-4b at its full published
   configuration (36 layers, d_model 2560, 32 heads, 8 KV heads,
   head_dim 128, d_ff 9728, vocab 151936 padded to 152064, bf16), random
   weights from seed 0 drawn on the card; a ``ServingEngine`` (4
   replicas, fcfs, ``cache_len`` 256) serves 8 requests of 16-token
   prompts and 8 new tokens (parameter bytes, peak memory, ms a prefill
   and a decode token by CUDA events, req/s on the virtual clock and the
   first response's tokens printed); at each decode step of the first
   request the logits are held against a fresh prefill of the prompt
   plus the tokens so far, at its last position, within
   ``LLM_BF16_TOL``, the greedy token equal wherever the prefill's top-2
   margin exceeds it, and each of ``DECODE_FAULTS`` planted in the decode
   step (rope position off by one, the token's K/V not written to the
   ring, written one slot on) must read above it; then a 2-layer model
   of the same width in float32 on the card and on the CPU from the same
   weights: logits within ``LLM_F32_TOL``, decode against prefill on the
   card within it and each planted fault above it, and the served tokens
   equal unless the first difference sits at a top-2 margin below it
   (printed);
15. the other families at their published widths (``[llm-rwkv]``,
   ``[llm-jamba]``, ``[llm-deepseek]``, ``[llm-grok]``, in that order),
   each cut in depth only where one card cannot hold it
   (``FAMILY_CUTS``, printed as ``reduced``: rwkv6-3b whole, one
   8-layer period of jamba, deepseek-v3's 3 dense layers, 1 MoE layer
   and its MTP head, 2 layers of grok-1), bf16 weights drawn on the card
   from seed 0 (expert stacks one expert at a time): parameters, bytes
   and peak memory; ``[llm]``'s workload through ``ServingEngine`` (req/s
   on the virtual clock, ms a prefill and a decode token by CUDA
   events); the (token, expert) pairs the served prefills dropped at the
   published capacity factor (a one-token decode must drop none: the
   served requests decoded again eagerly, whose tokens must equal the
   graphed serve's, log one dispatch an MoE layer a step); decode
   against a fresh prefill at ``FAMILY_BF16_TOL`` with the capacity
   lifted to E / k (no drop) and the prefill routed as the served path
   was (``forced_routing``; the prefill's own routing printed per layer
   and step, its choice for the new token, a set of experts, agreeing in
   more than half of the steps, and in no more than half with deepseek's
   ``FAMILY_ROUTER_FAULTS`` planted), each of the family's
   ``FAMILY_FAULTS`` (the latent ring slot not written or one on, the
   Mamba state or conv window not carried, the RWKV state or token shift
   not carried, GQA's three) above it; after rwkv6-3b's serve, ``[rwkv-model]``: its layer 0's
   float32 r, k, v, w, u on a served prompt through ``ops.rwkv_scan``
   (table row 8's kernel, one launch, counted from zero), within
   ``F32_TOL`` of the model's own recurrence (five times that for the
   state); then the float32 cuts of ``FAMILY_F32`` at full width (two
   rwkv6-3b layers, deepseek-v3's first two layers with the MTP head, a
   Mamba layer and an attention layer of jamba, each with a dense ffn)
   on the card against the CPU from the same weights within
   ``LLM_F32_TOL`` (logits, MTP logits), and decode against prefill on
   the card within it with the faults above it.  A float32 copy of a
   full-width MoE layer is left out: it would take 11-45 GB on the host;
16. ``[llm-smoke]``: each family's smoke preset in float32 on the card
   against the CPU from the same weights, logits (and MTP logits) within
   ``LLM_F32_TOL``, every routing decision equal;
17. LLM training (``[llm-train]``): minicpm-2b at its published widths,
   all 40 layers (2,725,173,504 bf16 parameters, the reference's count;
   float32 AdamW moments), from ``train_state_init`` (seed 0 on the
   card), ``make_train_step(remat=True)`` with AdamW at its defaults and
   the WSD schedule over ``LLM_TRAIN_STEPS`` = 16 steps, on
   ``LMBatchIterator`` batches of 2 x 2048 tokens (T = S = 2048: the
   chunked attention, whose calls and recomputed tiles are counted in
   one step): each step's metrics, ms a step by CUDA events (the first
   apart), tokens a second and peak memory; every metric finite and the
   mean loss of the last 3 steps below the first step's; ``--profile``
   adds one step under the profiler (device busy share, largest rows);
18. ``[llm-train-f32]``: minicpm-2b at full width cut to 2 layers, in
   float32, two train steps on the card and on the CPU from the same
   state: metrics within ``TRAIN_F32_RTOL``, ``grad_fn``'s gradients at
   both steps within ``GRAD_RTOL`` + ``GRAD_ATOL``, the moments within
   ``PARAM_RTOL`` + ``MOMENT_ATOL``, the parameters under
   ``hold_adam_step``; then on the card whether two runs of ``grad_fn``
   are bit-equal, and remat on against off;
19. ``[train-smoke]``: the same on every architecture's smoke preset
   (all ten of ``ARCH_IDS``): MLA, MoE with drops, Mamba, RWKV, the MTP
   loss, audio and VLM batches through autograd on the card;
20. ``[train-ckpt]`` (last): minicpm-2b's smoke preset in bf16, 3 steps,
   saved, restored into a fresh state (every leaf bit for bit), 3 more,
   equal to 6 uninterrupted steps (bit for bit where the card repeated
   its gradients in 18); then ``launch.train --device cuda --preset
   smoke --steps 20 --checkpoint`` must print its round-trip line.  The
   ten kernels' launches are counted from zero over 17-20 and must all
   be 0: the reference's training reaches no Pallas kernel, and a
   product that records a gradient keeps ``torch.bmm`` (and MLA its
   expanded attention);
21. ``[mesh]``: ``launch.mesh.make_serving_mesh(1)`` is ``("cuda:0",)``,
   one shard more than there are cards raises ``ValueError``, and
   qwen3-4b's smoke decode logits inside ``mesh_context(
   make_host_mesh())`` equal those outside it bit for bit;
22. ``[dryrun-card]``: minicpm-2b whole at ``[llm-train]``'s batch of 2 x
   2048 with remat: the cost model's FLOPs, counted on ``meta`` at cut
   depths and extrapolated (``launch.dryrun.pair_cost``), equal
   ``FlopCounterMode`` over one real step on the card exactly, and the
   per-device argument bytes of a 1 x 1 host mesh equal the bytes of the
   state and batch on the card exactly; the achieved TFLOP/s printed
   (the counted FLOPs over ``[llm-train]``'s ms a step);
23. ``[examples]``: ``examples/quickstart_torch.py``,
   ``nvr_serving_torch.py``, ``sharded_serving_torch.py`` and
   ``fault_tolerant_serving_torch.py`` through their ``main`` on
   ``cuda`` (NMS and assignment launches counted from zero over the
   four) and on ``cpu``: the reports they return equal, everything
   discrete exactly, floats within rtol 1e-5 + atol 1e-4;
24. ``[dryrun]`` (last): ``python -m repro_torch.launch.dryrun`` in three
   processes started before ``[mesh]`` (they run on ``meta`` tensors and
   see no card): ``--shape decode_32k --mesh both`` for every
   architecture, and minicpm-2b at ``train_4k`` and ``prefill_32k`` on
   the single mesh; every process exits 0, no record has ``error``,
   hubert-xlarge's decode pairs are the reference's skip, every
   architecture's ``n_params`` and the phase's wall time are printed.

``--profile`` adds one more serve of each path under ``torch.profiler``
and prints the device time by kernel and the device's busy share (and
the time a launch of the NMS, assignment and ROI kernels, with the device
op run just before each uncrop, which must not be a copy), and the
kernels that the timed flash and decode calls and their SDPA yardsticks
launch.

Each kernel is timed with CUDA events (its wrapper and, where the
wrapper does more than launch, the kernel alone), beside its plain
version, the least time the card could take for the same work (bytes
at 3.35 TB/s; operations at 67 TFLOP/s for float32 inputs and at the
989 TFLOP/s dense bf16 tensor-core rate for bfloat16 inputs, except the
RWKV scan, whose recurrence is float32 arithmetic in either type), the
rate achieved (GB/s for decode, TFLOP/s for flash and the scan) and its
share of the bound,
and, where one PyTorch call computes the same function, that call's time
(SDPA for the two attention kernels; used for comparison only).

The token and training phases launch none of the eight kernels that
replace the reference's: the model code computes attention with
``models.attention.sdpa`` and its chunked online softmax, the Mamba scan
and the RWKV recurrence in plain tensor code, as the reference's does;
``[rwkv-model]``'s one scan launch is a check beside the model.  The
MoE families' decode (and a prefill of at most 4 slots an expert)
launches the routed-experts kernel, and MLA's absorbed decode the MLA
decode kernel, which replace none; each family's serve prints the
launches it counted (``[llm-deepseek]``'s MLA launches must be three a
layer and decode step).

The third-to-last line is a JSON object with one entry per kernel, the
second-to-last the card's name and power limit, the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import ParallelDetector, proxy_detect_fn_streams  # noqa: E402,E501
from repro_torch.core.stream import BENCHMARK_VIDEOS, SyntheticVideo  # noqa: E402,E501
from repro_torch.detector import (SSDConfig, decode_detections,  # noqa: E402,E501
                                  init_ssd, make_anchors, params_to,
                                  ssd_candidates)
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.data import LMBatchIterator, make_modality_batch  # noqa: E402,E501
from repro_torch.device import ieee_float32  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import daemon as launch_daemon  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.daemon import (ServingDaemon, VirtualClock,  # noqa: E402,E501
                                       WallClock)
from repro_torch.models import (LayerSpec, Stage,  # noqa: E402
                                dense_stages, init_model, model_apply,
                                param_shapes)
from repro_torch.models import attention as llm_attention  # noqa: E402
from repro_torch.models import layers as llm_layers  # noqa: E402
from repro_torch.models import mamba as llm_mamba  # noqa: E402
from repro_torch.models import moe as llm_moe  # noqa: E402
from repro_torch.models import rwkv as llm_rwkv  # noqa: E402
from repro_torch.models import transformer as llm_transformer  # noqa: E402,E501
from repro_torch.obs import (TraceRecorder, audit_events,  # noqa: E402
                             audit_recorder, events_from_chrome,
                             write_chrome_trace)
from repro_torch.optim import AdamWConfig, make_schedule  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.runtime import (grad_fn, make_decode_step,  # noqa: E402
                                 make_prefill_step, make_train_step,
                                 train_state_init)
from repro_torch.runtime.checkpoint import (checkpoint_step,  # noqa: E402
                                            restore_checkpoint,
                                            save_checkpoint)
from repro_torch.kernels import association as kassoc  # noqa: E402
from repro_torch.kernels import decode_attention as kdecode  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import iou as kiou  # noqa: E402
from repro_torch.kernels import mla_decode as kmla  # noqa: E402
from repro_torch.kernels import nms as knms  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import roi as kroi  # noqa: E402
from repro_torch.kernels import routed_experts as krouted  # noqa: E402
from repro_torch.kernels import rwkv_scan as krwkv  # noqa: E402
from repro_torch.serving import (DetectionEngine, EventBus,  # noqa: E402
                                 FaultSchedule, FrameRequest, JsonlSink,
                                 Request, ServingEngine, ServingRuntime,
                                 ShardedDetectionEngine, Watchdog,
                                 make_cascade_detect_fn, make_nvr_streams,
                                 make_skewed_streams, paper_catalog)
from repro_torch.serving import pipeline as tpipe  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.cost import step_cost  # noqa: E402
from repro_torch.launch import dryrun as launch_dryrun  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_serving_mesh)
from repro_torch.sharding import mesh_context  # noqa: E402
from repro_torch import tracking as trk  # noqa: E402

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # H100 SXM dense bf16 tensor cores
SEED = 0
DEV = "cuda"
# the engine's shapes on the serving path
NMS_KW = dict(iou_thr=0.5, score_thr=0.4, max_out=32, stop_at_zero=True)
ASSIGN_THR = 0.3
RATE_FPS = 30.0                 # per camera
SERVICE_S = 0.025               # per frame and replica: 80 of 120 frames/s
IOU_FLOPS = 15                  # 4 min/max, 3 sub, 2 clamp, 2 mul, add+sub, div
# cascade: 2 replicas x (1 / 0.01 s) of the medium model sustain the 120
# frames/s of 4 cameras with headroom, the heavy model's 100 do not, so
# the selector climbs once from fast to medium and every later batch
# takes the ROI second pass
CASCADE_HEAVY_S = 0.02
ROI_BOUNDS = (1.0, 1.0)         # the mini-SSD's boxes are normalized
CROP_INDEX_FLOPS = 9            # add, div, sub, mul, add, mul, floor, 2 clamp
UNCROP_FLOPS = 18               # 2 sub + 4 x (div, mul, add, mul)
FORWARD_ATOL = 1e-4             # cuDNN vs CPU conv sums; Kalman ULPs
FUSED_K = 8                     # the fused window: (K, B, D) = (8, 4, 32)
MAP_ATOL = 1e-6                 # map_tracked, cuda vs cpu (Kalman ULPs)
TABLE_IV_N = range(1, 8)        # the paper's Table IV: n = 1..7 NCS2s
# the same frames at micro_batch 1 and 5: conv sums in another order
# (1.2e-7 measured on the CPU), so boxes and scores within 1e-6
BATCH_ATOL = 1e-6
# hand-written kernels whose time a launch --profile prints for a serve
SERVE_KERNELS = ("nms_kernel", "assign_kernel", "crop_kernel",
                 "uncrop_kernel")
# traces a `[profile ...]` call may take when the profiler records no
# device event at all (it did so once in a run: 41 launches, no record)
PROFILE_TRIES = 3
PROFILE_MARGIN_S = 0.005        # idle host time at a traced step's edges
IOU_PAIR_FLOPS = 13             # 4 min/max, 2 sub, 2 clamp, mul, add, sub,
                                # max, div (+ 3 a box for its area)
SSD300_ANCHORS = 8732           # SSD300's default boxes (the SSD paper);
                                # ssd300 is a core/executor.py MODEL_PROFILES entry
# the last four: rows that do not start on 16 bytes (M % 4 != 0) and a
# single row or column
IOU_SIZES = ((160, 160), (256, 256), (300, 17), (1, 1),
             (SSD300_ANCHORS, SSD300_ANCHORS), (161, 157), (300, 333),
             (1, 5), (5, 1))
# (name, B, H, T, S, D, causal, dtype): qwen3-4b's 32 heads of 128
# (src/repro/configs/qwen3_4b.py); the first is the timed shape
FLASH_CASES = (
    ("qwen3-4b prefill T=S=2048 causal bf16", 1, 32, 2048, 2048, 128, True,
     torch.bfloat16),
    ("qwen3-4b prefill T=S=2048 causal f32", 1, 32, 2048, 2048, 128, True,
     torch.float32),
    ("qwen3-4b cached prefix T=128 S=2048 bf16", 1, 32, 128, 2048, 128,
     True, torch.bfloat16),
    ("non-causal T=256 S=128 f32", 1, 32, 256, 128, 128, False,
     torch.float32))
# (name, B, H, KV, S, D, dtype): qwen3-4b's GQA (32 query heads on 8 kv
# heads of 128) against a 32k cache, then MQA and MHA
DECODE_CASES = (
    ("qwen3-4b decode S=32768 bf16", 4, 32, 8, 32768, 128, torch.bfloat16),
    ("MQA (2,8,1,512,128) f32", 2, 8, 1, 512, 128, torch.float32),
    ("MHA (2,16,16,1024,64) f32", 2, 16, 16, 1024, 64, torch.float32))
# (name, B, H, T, hs, dtype): rwkv6-3b's 40 heads of 64
# (src/repro/configs/rwkv6_3b.py)
RWKV_CASES = (
    ("rwkv6-3b T=2048 bf16", 4, 40, 2048, 64, torch.bfloat16),
    ("rwkv6-3b T=2048 f32", 4, 40, 2048, 64, torch.float32),
    ("T=100 hs=32 f32", 2, 8, 100, 32, torch.float32))
# small cases, checked but not timed, that reach the template instances
# the model widths above do not: flash D <= 64 and D <= 32 (the second
# with the causal rows that see no key, S < T), decode at D = 256 and at
# S < 512, the scan at hs <= 128 and hs < 32; in bfloat16, so that the
# float32 instance of the same width is compared too (hold_to_plain)
FLASH_EDGE_CASES = (
    ("D=64 causal T=256 S=384 bf16", 1, 4, 256, 384, 64, True,
     torch.bfloat16),
    ("D=32 causal T=256 S=128 bf16", 2, 2, 256, 128, 32, True,
     torch.bfloat16),
    ("D=36 (scalar loads) causal T=128 S=256 bf16", 1, 2, 128, 256, 36,
     True, torch.bfloat16))
DECODE_EDGE_CASES = (
    ("D=256 (1,8,2,512,256) bf16", 1, 8, 2, 512, 256, torch.bfloat16),
    ("S=100 (1,4,2,100,32) bf16", 1, 4, 2, 100, 32, torch.bfloat16),
    ("D=36 (scalar loads) G=16 (1,16,1,512,36) bf16", 1, 16, 1, 512, 36,
     torch.bfloat16))
RWKV_EDGE_CASES = (
    ("hs=256 T=48 bf16", 1, 2, 48, 256, torch.bfloat16),
    ("hs=128 T=64 bf16", 1, 2, 64, 128, torch.bfloat16),
    ("hs=36 T=40 bf16", 2, 3, 40, 36, torch.bfloat16),
    ("hs=16 T=48 bf16", 1, 2, 48, 16, torch.bfloat16))
# flash float32's accuracy margin at qwen3-4b width (not timed): a long
# cache, held to the plain version at the unchanged tolerance like every
# case above; and logits |q.k.scale| up to LARGE_LOGIT (q scaled up),
# measured against the plain version and against float64 but not held
# to 2e-5: there the float32 rounding of logits near 60 puts the plain
# version itself farther than 2e-5 from float64 (PERF.md, PR 16)
FLASH_MARGIN_CASES = (
    ("qwen3-4b long cache T=256 S=32768 causal f32", 1, 32, 256, 32768,
     128, True, torch.float32),)
FLASH_LARGE_LOGITS = ("qwen3-4b large logits T=S=2048 causal f32", 1, 32,
                      2048, 2048, 128, True, torch.float32)
LARGE_LOGIT = 60.0
# [moe-experts]: (name, E, C, d, f) of an MoE layer's decode dispatch at
# C = 4 slots (capacity(1)): grok-1's 8 experts of 6144 -> 32768
# (src/repro_torch/configs/grok_1_314b.py) and the 8 DeepSeek-V3 experts
# of 7168 -> 2048 one card of an EP32 deployment holds; the experts that
# hold a token in each case (a decode token touches k of them or fewer)
MOE_CASES = (("grok-1 decode E=8 C=4 6144->32768 bf16", 8, 4, 6144, 32768),
             ("deepseek-v3 decode E=8 held C=4 7168->2048 bf16", 8, 4, 7168,
              2048))
MOE_TOUCHED = ((), (5,), (2, 7))
# the kernel against the plain version in bf16: each element within two
# ulps of its own value plus 1/256 of the output's largest magnitude (the
# float32 dot products add in other orders, so a gate or up value at a
# rounding boundary may round to its neighbour; y rounds once more);
# tests/test_torch_routed_experts.py holds the same
MOE_RTOL, MOE_ATOL_SHARE = 2.0 ** -7, 2.0 ** -8
# [mla-decode]: MLA's absorbed decode at dsv3-decode's shapes: DeepSeek-V3's
# 128 heads, kv_lora 512, rope 64, nope 128, v 128, the cell's ring of 4,608
# slots (bench/systems/mla_moe.py: feed.longest_total) with 1,000, 2,350 (a
# request's mean) and 4,608 of them filled, bf16, its YaRN softmax scale;
# the kernel against the plain version as tests/test_torch_mla_decode.py
# holds it (each element within two bf16 ulps of its value plus 1/256 of
# the largest: q_abs and the output may round to the neighbouring bf16)
MLA_SHAPE = dict(B=1, H=128, R=512, P=64, N=128, V=128, L=4608)
MLA_FILLED = (1000, 2350, 4608)
MLA_SCALE = 192 ** -0.5 * (0.1 * np.log(40.0) + 1) ** 2
MLA_RTOL, MLA_ATOL_SHARE = 2.0 ** -7, 2.0 ** -8
L2_FLUSH_BYTES = 64 << 20       # written before a cold call: > the 50 MB L2
# [train]: the example's SGD loop at its own settings (SSDConfig(),
# batch 8, 150 steps on ETH-Sunnyday); each step's loss and parts on the
# card within TRAIN_RTOL of the CPU run's, relative to the larger of the
# CPU value and TRAIN_FLOOR (box and cls are 0 on a batch without a
# positive anchor): cuDNN and the CPU sum the convs in other orders, and
# the difference carries through the SGD trajectory
EXAMPLE = ROOT / "examples" / "video_analytics_torch.py"
TRAIN_STEPS = 150
# the example's 150 steps leave every score above the 0.4 threshold (so
# NMS fills max_out), 600 steps can leave every one below it; training
# goes on in chunks of TRAIN_STEPS up to TRAIN_STEPS_LONG and the
# sharded phase serves the first checkpoint whose NMS ends on a tail
TRAIN_STEPS_LONG = 600
TRAIN_BATCH = 8
TRAIN_RTOL = 1e-3
TRAIN_FLOOR = 1e-2
# [sharded]: 8 cameras at RATE_FPS, SERVICE_S a frame and replica, 2
# replicas a shard; the rebalancing and fault serves cut the trace's
# 0.8 s into epochs of SHARD_EPOCH_S
SHARD_CAMS = 8
SHARD_FRAMES = 24
SHARD_COUNTS = (1, 2, 4)
SHARD_EPOCH_S = 0.2
SHARD_KILL_T = 0.3              # shard 0 dies inside its second epoch
REPLICA_KILL_T = 0.1            # shard 1's replica 1, back at 0.5 s
REPLICA_REVIVE_T = 0.5
DAEMON_CHUNKS = (1, 4)          # frames a daemon ingest; the last also paced
LLM_CACHE_LEN = 256             # ServingEngine's ring cache, as serve.py's
LLM_PROMPT = 16                 # tokens a prompt
LLM_NEW = 8                     # greedy tokens a request
LLM_REQUESTS = 8
LLM_RATE = 20.0                 # req/s: serve.py's default arrival rate
LLM_F32_REQUESTS = 2            # the 2-layer float32 model, cuda vs cpu
# |decode - prefill| logits in bf16 over 36 layers, between the sound
# decode's reading and the planted faults' (H100: sound 0.0547 at logits
# up to 4.06; each fault at least 0.340 at every step): 2.3x the sound one
LLM_BF16_TOL = 0.125
LLM_F32_TOL = 1e-4              # |cuda - cpu| logits, float32, 2 layers
#: the families after [llm], each at its published widths, cut in depth
#: only where one 80 GB card cannot hold it: the repeats of each stage
#: and what the cut leaves
FAMILY_CUTS = {
    "rwkv6-3b": ((32,), "nothing: all 32 layers"),
    "jamba-v0.1-52b": ((1,), "repeats 4 -> 1: one 8-layer period, 7 Mamba "
                       "+ 1 attention, 4 MoE + 4 dense ffns"),
    "deepseek-v3-671b": ((3, 1), "MoE stage 58 -> 1 layer; the dense "
                         "stage whole (3 layers); the MTP head kept"),
    "grok-1-314b": ((2,), "64 -> 2 layers"),
}
#: |decode - prefill| logits in bf16 for each family, by the rule fixed in
#: PERF.md (section 6) before the card's readings: qwen3-4b's 0.125
#: where the sound decode reads at most 0.0625 and every fault at least
#: 0.25, else the geometric mean of the sound reading and the least fault
#: (H100: rwkv6-3b 0 against 5.52, grok-1 0.0391 against 0.770; jamba
#: 0.118164 against 0.792969; deepseek-v3 with its published router and
#: YaRN 0.0698242 against 0.81543, so sqrt(0.0698242 * 0.81543); with the
#: plain top 8 and no YaRN it read 0.0469 against 0.426).  Jamba reads
#: the most: the reference's Mamba decode computes its conv in float32,
#: its prefill in bf16 (with the decode's conv as the prefill's,
#: ``VARIANTS``, its first layer reads 0), and its MoE expert products
#: round differently at C = 4 and C = T slots, over 8 layers
FAMILY_BF16_TOL = {"rwkv6-3b": 0.125, "jamba-v0.1-52b": 0.306,
                   "deepseek-v3-671b": 0.239, "grok-1-314b": 0.125}
#: the float32 card-against-CPU models at full width: a stage cut of the
#: published config (the MTP head kept where the config has one)
FAMILY_F32 = {
    "rwkv6-3b": (lambda c: (Stage(c.stages[0].pattern, 2),),
                 "2 layers (rwkv + channel mix)"),
    "jamba-v0.1-52b": (lambda c: (Stage((LayerSpec("mamba", "dense"),
                                         LayerSpec("attn", "dense")), 1),),
                       "a Mamba + dense ffn layer and an attention + dense "
                       "ffn layer"),
    "deepseek-v3-671b": (lambda c: (Stage(c.stages[0].pattern, 2),),
                         "the first 2 layers (MLA + dense ffn) and the MTP "
                         "head"),
}
# [llm-train]: minicpm-2b at its published widths (all 40 layers, bf16),
# the reference launcher's default architecture, with its WSD schedule
LLM_TRAIN_ARCH = "minicpm-2b"
LLM_TRAIN_PARAMS = 2725173504   # jax.eval_shape of the reference's init_model
LLM_TRAIN_BATCH = 2
LLM_TRAIN_SEQ = 2048            # T = S = 2048: the chunked attention path
LLM_TRAIN_STEPS = 16
# [llm-train-f32], [train-smoke], [train-ckpt]: float32 (the last bf16),
# two steps, cuda against cpu; tolerances as tests/test_torch_train*.py:
# metrics relative, gradients rtol + atol, the moments rtol + atol, the
# parameters by adam_step_tolerance (|g| > SMALL_GRAD) or 2 lr
TRAIN_F32_BATCH = 2
TRAIN_F32_SEQ = 64
TRAIN_F32_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
PARAM_RTOL = 1e-5
MOMENT_ATOL = 1e-7
SMALL_GRAD = 1e-5
CKPT_STEPS = (3, 3)             # steps before the save, steps after
# [dryrun]: the dry run's CLI, one process each, all started together:
# decode_32k of every architecture on both meshes, minicpm-2b's train_4k
# and prefill_32k on the single mesh
DRYRUN_RUNS = (("--shape", "decode_32k", "--mesh", "both"),
               ("--arch", "minicpm-2b", "--shape", "train_4k"),
               ("--arch", "minicpm-2b", "--shape", "prefill_32k"))
DRYRUN_TIMEOUT_S = 600
# [examples]: the four examples ported last, cuda against cpu; floats as
# tests/test_torch_serving.py holds interpolated boxes and scores
EXAMPLES = ("quickstart_torch.py", "nvr_serving_torch.py",
            "sharded_serving_torch.py", "fault_tolerant_serving_torch.py")
EXAMPLE_RTOL, EXAMPLE_ATOL = 1e-5, 1e-4
# the reference's float32 kernel tolerance (tests/test_kernels.py), rtol =
# atol, five times that for the RWKV state; a bfloat16 case is held to it
# before its one final rounding (hold_to_plain)
F32_TOL = 2e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters=200, warmup=20):
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ------------------------------------------------------------- inputs
def nvr_frames(n_cams, n_frames, rate, make=make_nvr_streams, **kw):
    """``make_nvr_streams`` (or ``make``'s) arrivals with real pixels:
    camera s renders benchmark video s (mod the catalogue) at its own
    frame index."""
    frames, frame_of, videos, dets = make(n_cams, n_frames, rate, **kw)
    vids = [SyntheticVideo(v) for v in BENCHMARK_VIDEOS.values()]
    out = []
    for f in frames:
        s, k = frame_of[f.rid]
        out.append(FrameRequest(f.rid, vids[s % len(vids)].pixels(k),
                                f.t_arrival, stream_id=s))
    return out, frame_of, videos, dets


def random_boxes(rng, shape, span=1.0, max_wh=0.3):
    xy = rng.uniform(0, span, shape + (2,))
    wh = rng.uniform(0, max_wh * span, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def nms_cases(rng, ssd_boxes, ssd_scores):
    """(name, boxes, scores, kwargs) on the card."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    cases = []
    for B in (1, 2, 4, 8):
        cases.append((f"ssd B={B} A=160", ssd_boxes[:B], ssd_scores[:B],
                      NMS_KW))
    b = random_boxes(rng, (8, 200))
    s = rng.uniform(0, 1, (8, 200)).astype(np.float32)
    s[:, 1::3] = s[:, ::3][:, :s[:, 1::3].shape[1]]          # score ties
    b[:, ::7, 2:] = b[:, ::7, :2]                            # zero area
    cases.append(("random A=200 ties zero-area", t(b), t(s), NMS_KW))
    cases.append(("random A=200 no thr", t(b), t(s),
                  dict(NMS_KW, score_thr=None, stop_at_zero=False)))
    cases.append(("random A=200 max_out=5", t(b), t(s),
                  dict(NMS_KW, max_out=5)))
    s2 = rng.uniform(0, 0.45, (3, 7)).astype(np.float32)
    cases.append(("random A=7", t(random_boxes(rng, (3, 7))), t(s2),
                  NMS_KW))
    # positives and zero scores in one tile: the tile is processed whole
    s3 = np.where(rng.uniform(size=(4, 160)) < 0.1,
                  rng.uniform(0.4, 1, (4, 160)), 0.1).astype(np.float32)
    cases.append(("mixed tile", t(random_boxes(rng, (4, 160), max_wh=.1)),
                  t(s3), NMS_KW))
    dense = random_boxes(rng, (2, 160), max_wh=0.9)
    cases.append(("dense overlap", t(dense),
                  t(rng.uniform(0.4, 1, (2, 160)).astype(np.float32)),
                  dict(NMS_KW, iou_thr=0.7)))
    # the kernel's own sort against torch.argsort(stable=True): runs of
    # equal scores across tiles, -0.0 beside 0.0 (they tie: index order),
    # NaN scores (last, in index order) with no threshold, and the
    # widest frame the launcher has been run at
    tb = random_boxes(rng, (4, 160), max_wh=0.15)
    ts = rng.choice(np.float32([0.9, 0.7, 0.5, 0.45, 0.3]), (4, 160))
    cases.append(("score ties in runs", t(tb), t(ts), NMS_KW))
    zs = np.where(rng.uniform(size=(4, 160)) < 0.5, np.float32(-0.0),
                  np.float32(0.0)).astype(np.float32)
    zs[:, ::9] = rng.uniform(0.5, 1, zs[:, ::9].shape)
    for thr in (None, 0.4):
        cases.append((f"+-0.0 scores, score_thr={thr}", t(tb), t(zs),
                      dict(NMS_KW, score_thr=thr, stop_at_zero=False,
                           max_out=64)))
    ns = rng.uniform(0, 1, (3, 160)).astype(np.float32)
    ns[rng.uniform(size=ns.shape) < 0.2] = np.nan
    ns[0, :40] = np.nan
    cases.append(("NaN scores, no threshold", t(tb[:3]), t(ns),
                  dict(NMS_KW, score_thr=None, stop_at_zero=False,
                       max_out=160)))
    cases.append(("NaN scores, score_thr=0.4", t(tb[:3]), t(ns), NMS_KW))
    wide = random_boxes(rng, (2, 2400), max_wh=0.05)
    ws = rng.uniform(0, 1, (2, 2400)).astype(np.float32)
    ws[:, 1::4] = ws[:, ::4]
    cases.append(("A=2400", t(wide), t(ws), dict(NMS_KW, max_out=300)))
    return cases


def assign_cases(rng):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    cases = []
    for name, B, T, D, p_t, p_d in (("engine B=4 T=64 D=32", 4, 64, 32,
                                     0.5, 0.8),
                                    ("T=13 D=11", 3, 13, 11, 0.8, 0.8),
                                    ("T<D", 2, 5, 40, 1.0, 0.7),
                                    ("all masked", 2, 64, 32, 0.0, 1.0)):
        tb = random_boxes(rng, (B, T), span=100.0, max_wh=0.4)
        db = tb[:, rng.integers(0, T, D)] + rng.normal(
            0, 3, (B, D, 4)).astype(np.float32)
        db[:, D // 2:D // 2 + 2] = db[:, :2]                   # ties
        tm = rng.uniform(size=(B, T)) < p_t
        dm = rng.uniform(size=(B, D)) < p_d
        tc = rng.integers(0, 3, (B, T)).astype(np.int32)
        dc = rng.integers(0, 3, (B, D)).astype(np.int32)
        cases.append((name, (t(tb), t(db), t(tm), t(dm), t(tc), t(dc))))
    return cases


def roi_windows(rng, B, R, span=0.5):
    """(B, R, 4) normalized xyxy windows inside the frame."""
    a = rng.uniform(0.0, 0.6, (B, R, 2)).astype(np.float32)
    b = np.minimum(a + rng.uniform(0.05, span, (B, R, 2)), 1.0)
    return np.concatenate([a, b.astype(np.float32)], -1)


def crop_cases(rng, frames_8):
    """(name, images, rois, C) on the card; the first is the serve's
    shapes on the serve's frames."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    cases = []
    rois = roi_windows(rng, 8, 4)
    n_rois = rng.integers(0, 5, 8)
    rois[np.arange(4)[None, :] >= n_rois[:, None]] = 0.0   # zero area
    cases.append(("serve B=8 R=4 64x64x3 C=64, zero-area rows past n_rois",
                  frames_8, t(rois), 64))
    edge = roi_windows(rng, 8, 4)
    edge[:, :, 2] = 1.0                        # x1 on the frame edge
    edge[:, 1::2, 3] = 1.0
    edge[0, 0] = [0.0, 0.0, 1.0, 1.0]
    cases.append(("frame edge x1=1.0", frames_8, t(edge), 64))
    cases.append(("downsample C=32", frames_8, t(roi_windows(rng, 8, 4)),
                  32))
    cases.append(("upsample C=96", frames_8,
                  t(roi_windows(rng, 8, 4, span=0.2)), 96))
    gray = rng.random((3, 48, 80, 1)).astype(np.float32)
    cases.append(("non-square 48x80 ch=1", t(gray),
                  t(roi_windows(rng, 3, 4)), 64))
    # window edges on pixel boundaries of a 60-pixel frame and C = w/2:
    # every source coordinate is an exact integer, so the floor decides
    # on the last bit (an FMA would move it)
    grid = rng.integers(0, 36, (4, 4, 2))
    edges = (np.concatenate([grid, grid + 24], -1) / np.float32(60))
    cases.append(("pixel-boundary windows 60x60 C=12",
                  t(rng.random((4, 60, 60, 3)).astype(np.float32)),
                  t(edges.astype(np.float32)), 12))
    cases.append(("serve B=1 R=4 64x64x3 C=64 (one-frame micro-batch)",
                  frames_8[:1], t(roi_windows(rng, 1, 4)), 64))
    cases.append(("C=13 ch=3: rows of 39 floats, not 16-byte multiples",
                  frames_8, t(roi_windows(rng, 8, 4)), 13))
    # each window a quarter pixel inside pixel k: every output reads k
    lo = (rng.integers(0, 64, (8, 4, 2)) + 0.5) / 64
    tiny = np.concatenate([lo, lo + 0.25 / 64], -1).astype(np.float32)
    cases.append(("windows of one source pixel", frames_8, t(tiny), 64))
    cases.append(("70000 windows C=4 16x16x1 (grid axes)",
                  t(rng.random((17500, 16, 16, 1)).astype(np.float32)),
                  t(roi_windows(rng, 17500, 4)), 4))
    return cases


def uncrop_cases(rng):
    """(name, boxes, rois, bounds, C) on the card; the first is the
    serve's shapes."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    cases = []
    for name, lead, rlead, bounds, C in (
            ("serve (8,4,32) rois (8,4,1) bounds (1,1)", (8, 4, 32),
             (8, 4, 1), ROI_BOUNDS, 64),
            ("bounds (640,480)", (8, 4, 32), (8, 4, 1), (640, 480), 64),
            ("N=105 ragged", (3, 5, 7), (3, 5, 7), (123.4, 55.5), 96),
            ("N=1000 flat", (1000,), (1000,), (1920, 1080), 32)):
        boxes = rng.uniform(0, C, lead + (4,)).astype(np.float32)
        rois = roi_windows(rng, 1, int(np.prod(rlead))).reshape(
            rlead + (4,))
        cases.append((name, t(boxes), t(rois), bounds, C))
    # rois read through their broadcast: a partial broadcast, the serve's
    # view of its (n, R, 4) windows over M boxes (also sliced from a wider
    # tensor, so no stride is a multiple of 4), one roi for every box
    boxes = rng.uniform(0, 96, (3, 5, 7, 4)).astype(np.float32)
    cases.append(("rois (1,5,1) against boxes (3,5,7)", t(boxes),
                  t(roi_windows(rng, 1, 5).reshape(1, 5, 1, 4)),
                  (123.4, 55.5), 96))
    boxes = t(rng.uniform(0, 64, (8, 4, 32, 4)).astype(np.float32))
    cases.append(("serve view norm[:, :, None, :]", boxes,
                  t(roi_windows(rng, 8, 4))[:, :, None, :], ROI_BOUNDS, 64))
    wide = np.zeros((8, 4, 6), np.float32)
    wide[:, :, 1:5] = roi_windows(rng, 8, 4)
    cases.append(("serve view sliced from (8,4,6)", boxes,
                  t(wide)[:, :, 1:5][:, :, None, :], (640, 480), 64))
    cases.append(("rois (4,) for every box", boxes,
                  t(roi_windows(rng, 1, 1).reshape(4)), (1920, 1080), 64))
    return cases


# ------------------------------------------------------------- bounds
def nms_iou_count(boxes, scores, iou_thr, score_thr, max_out,
                  stop_at_zero):
    """IoUs greedy NMS needs on these inputs: each survivor against the
    later candidates still alive when it is kept, over the tiles a frame
    enters (host replay of the greedy loop)."""
    boxes = boxes.cpu().numpy().astype(np.float64)
    s = scores.cpu().numpy().astype(np.float32)
    if score_thr is not None:
        s = np.where(s >= np.float32(score_thr), s, 0)
    n = 0
    for fb, fs in zip(boxes, s):
        order = np.argsort(-fs, kind="stable")
        bs, ss = fb[order], fs[order]
        A = len(ss)
        alive = np.ones(A, bool)
        found = 0
        for c0 in range(0, A, knms.TILE):
            if found >= max_out or (stop_at_zero and not ss[c0] > 0):
                break
            T = min(knms.TILE, A - c0)
            for i in range(c0, c0 + T):
                if not alive[i]:
                    continue
                found += 1
                n += int(alive[i + 1:].sum())
                rest = bs[i + 1:]
                ix = (np.clip(np.minimum(bs[i, 2], rest[:, 2]) -
                              np.maximum(bs[i, 0], rest[:, 0]), 0, None) *
                      np.clip(np.minimum(bs[i, 3], rest[:, 3]) -
                              np.maximum(bs[i, 1], rest[:, 1]), 0, None))
                ar = (rest[:, 2] - rest[:, 0]) * (rest[:, 3] - rest[:, 1])
                ai = (bs[i, 2] - bs[i, 0]) * (bs[i, 3] - bs[i, 1])
                iou = ix / np.maximum(ai + ar - ix, 1e-9)
                alive[i + 1:] &= ~(iou >= iou_thr)
    return n


def nms_bound_ms(boxes, scores, kw):
    B, A = scores.shape
    nbytes = B * A * (16 + 4) + B * kw["max_out"] * (4 + 1)
    ops_ = IOU_FLOPS * nms_iou_count(boxes, scores, **kw)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def assign_bound_ms(args, match):
    tb, db = args[0], args[1]
    B, T = tb.shape[:2]
    D = db.shape[1]
    nbytes = B * (T * 16 + D * 16 + T + D + 4 * T + 4 * D) + B * T * 4
    matches = (match >= 0).sum(-1).cpu().numpy()
    steps = np.minimum(matches + (matches < min(T, D)), min(T, D))
    ops_ = B * T * D * IOU_FLOPS + int(steps.sum()) * T * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def crop_bound_ms(images, rois, C):
    """Bytes: the rois, the output, and each source element the windows
    gather (the union over a frame's windows, read once)."""
    B, H, W, ch = images.shape
    R = rois.shape[1]
    ys = kroi.crop_indices(rois[..., 1], rois[..., 3], C, H).cpu().numpy()
    xs = kroi.crop_indices(rois[..., 0], rois[..., 2], C, W).cpu().numpy()
    src = 0
    for b in range(B):
        hit = np.zeros((H, W), bool)
        for r in range(R):
            hit[np.ix_(ys[b, r], xs[b, r])] = True
        src += int(hit.sum())
    nbytes = 4 * (src * ch + B * R * C * C * ch + rois.numel())
    ops_ = B * R * 2 * C * CROP_INDEX_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def uncrop_bound_ms(boxes, rois):
    """Bytes: the boxes and the rois as given, read once, and the
    output."""
    N = boxes.numel() // 4
    nbytes = 4 * (2 * boxes.numel() + rois.numel())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = N * UNCROP_FLOPS / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _bound(nbytes, ops_, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def iou_bound_ms(N, M):
    """Bytes: both box sets read once and the (N, M) float32 matrix
    written once; operations: 13 a pair and 3 a box (its area)."""
    return _bound(16 * (N + M) + 4 * N * M,
                  IOU_PAIR_FLOPS * N * M + 3 * (N + M), FP32_OPS_PER_S)


def _peak(dtype):
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S


def flash_bound_ms(B, H, T, S, D, causal, dtype):
    """Bytes: q, k, v read once and the output written once; operations:
    2 D for q.k and 2 D for p.v on every (query, seen key) pair (the
    causal mask's pairs only), at the peak rate of the inputs' type."""
    esize = torch.tensor([], dtype=dtype).element_size()
    return _bound(esize * B * H * (2 * T * D + 2 * S * D),
                  flash_flops(B, H, T, S, D, causal), _peak(dtype))


def flash_flops(B, H, T, S, D, causal):
    """4 D a (query, seen key) pair: 2 D for q.k and 2 D for p.v."""
    t = np.arange(T)
    seen = np.clip(t + (S - T) + 1, 0, S).sum() if causal else T * S
    return 4 * D * B * H * int(seen)


def decode_bytes(B, H, KV, S, D, dtype):
    """q, the K and V caches read once and the output written once."""
    esize = torch.tensor([], dtype=dtype).element_size()
    return esize * (2 * B * H * D + 2 * B * S * KV * D)


def decode_bound_ms(B, H, KV, S, D, dtype):
    """Bytes: ``decode_bytes``; operations: 4 D a (query head, cache
    row) pair."""
    return _bound(decode_bytes(B, H, KV, S, D, dtype), 4 * D * B * H * S,
                  _peak(dtype))


def rwkv_bound_ms(B, H, T, hs, dtype):
    """Bytes: r, k, v, w read and out written once in the inputs' type,
    u, s0 and the final state in float32; operations: 7 a state element
    a step (k v, u kv, S +, r x, sum, w S, + kv), at the float32 rate
    whatever the inputs' type: the recurrence is float32 arithmetic (the
    bf16 results must be the float32 instance's, rounded)."""
    esize = torch.tensor([], dtype=dtype).element_size()
    return _bound(esize * 5 * B * H * T * hs + 4 * (H * hs +
                                                   2 * B * H * hs * hs),
                  7 * B * H * T * hs * hs, FP32_OPS_PER_S)


# ------------------------------------------------------------- phases
def phase_build():
    t0 = time.perf_counter()
    paths = build.build()
    print(f"[build] {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in paths.values()))
    for name in paths:
        print(f"[build] {name}: flags {' '.join(build.flags(name))}")
        log = build.BUILD_DIR / f"{name}.log"
        if log.is_file():
            for line in ptxas_summary(log.read_text()):
                print(f"[build] {name}: {line}")


def ptxas_summary(log):
    """One line per kernel of an ``nvcc -Xptxas=-v`` log: its name and
    template arguments, registers, static shared memory and spill
    bytes."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?\d+([a-z_]+kernel)"
                      r"(?:I(\w+?)EEv)?", line)
        if m:
            args = [{"13__nv_bfloat16": "bf16", "f": "f32"}.get(a, n)
                    for a, n in re.findall(r"(13__nv_bfloat16|f)|Li(\d+)E",
                                           m.group(2) or "")]
            name = m.group(1) + (f"<{', '.join(args)}>" if args else "")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} bytes"
            continue
        m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, "
                       f"{m.group(2) or 0} bytes static smem, {spill}")
            name = None
    return out


def check_mma_zero_identity(n_tiles=512):
    """The identity the flash kernel's bf16 bit check rests on: on the
    tensor cores, as the kernel runs them (wgmma, bf16 in, float32
    accumulate; A from registers and from shared memory), D = 0 . B + C
    returns C bit for bit, for accumulators of every magnitude the kernel
    meets and a random bf16 operand beside the zero one."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 8)
    n = n_tiles * 2 * 128 * 32
    c = torch.randn(n, generator=g, device=DEV) * torch.exp2(
        torch.randint(-40, 40, (n,), generator=g, device=DEV).float())
    b = torch.randn(n_tiles * 64 * 64, generator=g, device=DEV).to(
        torch.bfloat16)
    d = torch.empty_like(c)
    probe = build.function("flash_attention", "flash_mma_zero_probe",
                           [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                    ctypes.c_void_p])
    build.check(probe(c.data_ptr(), b.data_ptr(), d.data_ptr(), n_tiles,
                      torch.cuda.current_stream().cuda_stream),
                "flash_mma_zero_probe")
    torch.cuda.synchronize()
    same = torch.equal(d.view(torch.int32), c.view(torch.int32))
    print(f"[mma-zero] D = 0 . B + C, wgmma m64n64k16 with the zero "
          f"operand in registers and in shared memory, {n} accumulators "
          f"(|C| from {float(c.abs().min()):.2e} to "
          f"{float(c.abs().max()):.2e}): bit-equal to C: {same}")
    check(same, "wgmma: 0 . B + C != C; the flash bit check cannot hold "
          "by construction")


def check_counters(b, s, assign_args, crop_args, uncrop_args):
    """Each wrapper counts one launch where it launches its kernel (the
    routed-experts wrapper two: its gate/up and down passes; the MLA
    decode wrapper three: absorb, attend, combine) and nothing where it
    launches none (an empty batch; no expert)."""
    imgs, rois, C = crop_args
    boxes, brois, bounds, bC = uncrop_args
    x = torch.ones((2, 2, 128, 32), device=DEV)
    cache = torch.ones((2, 64, 2, 32), device=DEV)
    seq = torch.full((2, 2, 16, 8), 0.5, device=DEV)
    u, s0 = torch.ones((2, 8), device=DEV), torch.zeros((2, 2, 8, 8),
                                                         device=DEV)
    xe, sw = torch.ones((2, 4, 8), device=DEV), torch.ones(8, device=DEV)
    wu, wd = torch.ones((2, 8, 16), device=DEV), torch.ones((2, 16, 8),
                                                            device=DEV)
    q = torch.ones((2, 1, 4, 48), dtype=torch.bfloat16, device=DEV)
    ring = [torch.ones((2, 24, w), dtype=torch.bfloat16, device=DEV)
            for w in (64, 16)]
    wkv = torch.ones((64, 4, 32), dtype=torch.bfloat16, device=DEV)
    calls = lambda k: (  # noqa: E731
        knms.batched_nms_cuda(b[:k], s[:k], **NMS_KW),
        kassoc.greedy_assign_cuda(*(a[:k] for a in assign_args),
                                  iou_thr=ASSIGN_THR),
        kroi.crop_resize_cuda(imgs[:k], rois[:k], out_size=C),
        kroi.uncrop_boxes_cuda(boxes[:k], brois[:k], bounds=bounds,
                               crop_size=bC),
        kiou.iou_matrix_cuda(b[0, :k], b[1]),
        kflash.flash_attention_cuda(x[:k], x[:k], x[:k]),
        kdecode.decode_attention_cuda(x[:k, :, 0], cache[:k], cache[:k]),
        krwkv.rwkv_scan_cuda(*(seq[:k],) * 4, u, s0[:k]),
        krouted.routed_expert_ffn_cuda(xe[:k], sw[:4 * (2 if k is None
                                                        else k)],
                                       wu[:k], wu[:k], wd[:k]),
        kmla.mla_decode_cuda(q[:k, ..., :32], q[:k, ..., 32:], ring[0][:k],
                             ring[1][:k], wkv, wkv, 5, scale=0.25))
    ops.reset_launches()
    calls(0)
    check(set(ops.launches().values()) == {0},
          f"launch counted for an empty batch: {ops.launches()}")
    calls(None)
    # the routed-experts wrapper launches its two passes a call, the MLA
    # decode wrapper its three
    check(ops.launches() == dict({k: 1 for k in ops.launches()},
                                 routed_experts=2, mla_decode=3),
          f"one launch each (two for routed_experts, three for mla_decode) "
          f"counted as {ops.launches()}")
    print("[counters] empty batch: no launch counted; one call: one each, "
          f"two for routed_experts, three for mla_decode "
          f"({', '.join(ops.launches())})")


def phase_kernels(params, cfg, anchors, frames):
    rng = np.random.default_rng(SEED)
    imgs = torch.from_numpy(np.stack([f.image for f in frames[:8]])).to(DEV)
    ssd_b, ssd_s, _ = ssd_candidates(params, cfg, imgs, anchors)
    entries = {}

    # NMS: exact against the plain version on every case
    worst = 0
    for name, b, s, kw in nms_cases(rng, ssd_b, ssd_s):
        kk, vk = knms.batched_nms_cuda(b, s, **kw)
        kp, vp = knms.batched_nms_torch(b, s, **kw)
        torch.cuda.synchronize()
        err = max(int((kk - kp).abs().max()), int((vk != vp).sum()))
        print(f"[nms] {name}: keep/valid equal={err == 0} "
              f"valid={int(vk.sum())}")
        check(err == 0, f"batched_nms kernel != plain version on {name}")
        worst = max(worst, err)
    b, s = ssd_b[:8].contiguous(), ssd_s[:8].contiguous()
    ms = cuda_ms(lambda: knms.batched_nms_cuda(b, s, **NMS_KW))
    plain_ms = cuda_ms(lambda: knms.batched_nms_torch(b, s, **NMS_KW),
                       iters=20, warmup=3)
    keep = torch.empty((8, 32), dtype=torch.int32, device=DEV)
    valid = torch.empty((8, 32), dtype=torch.bool, device=DEV)
    launch = build.function("nms", "batched_nms_launch", knms._LAUNCH_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    kernel_ms = cuda_ms(lambda: launch(
        b.data_ptr(), s.data_ptr(), 8, 160, 32, 1, NMS_KW["score_thr"],
        NMS_KW["iou_thr"], 1, keep.data_ptr(), valid.data_ptr(), stream))
    kp, vp = knms.batched_nms_torch(b, s, **NMS_KW)
    check(torch.equal(keep, kp) and torch.equal(valid, vp),
          "NMS kernel alone != the plain version")
    bound, by = nms_bound_ms(b, s, NMS_KW)
    entries["batched_nms"] = dict(
        name="batched_nms", route="cuda",
        source="src/repro_torch/kernels/csrc/nms.cu",
        replaces="src/repro/kernels/nms.py:166",
        max_abs_err=float(worst), ms=ms, kernel_only_ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        shape="B=8 A=160 max_out=32")
    print(f"[nms] B=8 A=160: wrapper {ms:.4f} ms (kernel alone "
          f"{kernel_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound:.2e} ms ({by})")
    for B in (1, 2, 4):                  # the engine's other buckets
        bb, sb = ssd_b[:B].contiguous(), ssd_s[:B].contiguous()
        t_k = cuda_ms(lambda: knms.batched_nms_cuda(bb, sb, **NMS_KW))
        t_p = cuda_ms(lambda: knms.batched_nms_torch(bb, sb, **NMS_KW),
                      iters=20, warmup=3)
        print(f"[nms-sweep] B={B} A=160: wrapper {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, bound {nms_bound_ms(bb, sb, NMS_KW)[0]:.2e} ms")

    # association: exact against the plain version on every case
    worst = 0
    eng_case = None
    for name, args in assign_cases(rng):
        mk = kassoc.greedy_assign_cuda(*args, iou_thr=ASSIGN_THR)
        mp = kassoc.greedy_assign_torch(*args, iou_thr=ASSIGN_THR)
        torch.cuda.synchronize()
        err = int((mk - mp).abs().max()) if mk.numel() else 0
        print(f"[assign] {name}: match equal={err == 0} "
              f"matches={int((mk >= 0).sum())}")
        check(err == 0, f"greedy_assign kernel != plain version on {name}")
        worst = max(worst, err)
        if eng_case is None:
            eng_case = (args, mk)
    args, mk = eng_case
    ms = cuda_ms(lambda: kassoc.greedy_assign_cuda(*args,
                                                   iou_thr=ASSIGN_THR))
    plain_ms = cuda_ms(lambda: kassoc.greedy_assign_torch(
        *args, iou_thr=ASSIGN_THR), iters=20, warmup=3)
    bound, by = assign_bound_ms(args, mk)
    entries["greedy_assign"] = dict(
        name="greedy_assign", route="cuda",
        source="src/repro_torch/kernels/csrc/association.cu",
        replaces="src/repro/kernels/association.py:103",
        max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None,
        shape="B=4 T=64 D=32")
    print(f"[assign] B=4 T=64 D=32: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.2e} ms ({by})")
    for B in (1, 8):                     # one camera / eight cameras
        sub = tuple(a[:1] if B == 1 else torch.cat([a, a]) for a in args)
        t_k = cuda_ms(lambda: kassoc.greedy_assign_cuda(
            *sub, iou_thr=ASSIGN_THR))
        t_p = cuda_ms(lambda: kassoc.greedy_assign_torch(
            *sub, iou_thr=ASSIGN_THR), iters=20, warmup=3)
        print(f"[assign-sweep] B={B} T=64 D=32: kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms")
    # device time a call (the event loops above are host-bound): one
    # camera, the engine's four, eight
    calls = [(f"B={B} T=64 D=32", "::assign_kernel",
              lambda sub=sub: kassoc.greedy_assign_cuda(
                  *sub, iou_thr=ASSIGN_THR))
             for B, sub in ((1, tuple(a[:1] for a in args)), (4, args),
                            (8, tuple(torch.cat([a, a]) for a in args)))]
    entries["greedy_assign"]["device_ms"] = device_ms_a_call("assign",
                                                             calls)
    entries.update(roi_kernels(rng, imgs))
    crop, unc = crop_cases(rng, imgs)[0], uncrop_cases(rng)[0]
    check_counters(b, s, args, crop[1:], unc[1:])
    return entries


def roi_kernels(rng, frames_8):
    """Crop and uncrop: exact against the plain versions (and the numpy
    oracles) on every case, then timed at the serve's shapes."""
    entries = {}
    worst = 0.0
    for name, imgs, rois, C in crop_cases(rng, frames_8):
        ck = kroi.crop_resize_cuda(imgs, rois, out_size=C)
        cp = kroi.crop_resize_torch(imgs, rois, out_size=C)
        torch.cuda.synchronize()
        err = float((ck - cp).abs().max())
        oracle = torch.equal(ck.cpu(), kref.crop_resize_ref(
            imgs.cpu(), rois.cpu(), out_size=C))
        print(f"[crop] {name}: equal={bool(torch.equal(ck, cp))} "
              f"oracle={oracle} out {tuple(ck.shape)}")
        check(torch.equal(ck, cp) and oracle,
              f"crop_resize kernel != plain version on {name}")
        worst = max(worst, err)
    _, imgs, rois, C = crop_cases(rng, frames_8)[0]
    crop_in = (imgs, rois, C)
    ms = cuda_ms(lambda: kroi.crop_resize_cuda(imgs, rois, out_size=C))
    plain_ms = cuda_ms(lambda: kroi.crop_resize_torch(imgs, rois,
                                                      out_size=C),
                       iters=50, warmup=5)
    out = torch.empty((8, 4, C, C, 3), dtype=torch.float32, device=DEV)
    launch = build.function("roi", "crop_resize_launch", kroi._CROP_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    split = kroi.crop_split(8, 4, C, 3)
    kernel_ms = cuda_ms(lambda: launch(imgs.data_ptr(), rois.data_ptr(), 8,
                                       4, 64, 64, 3, C, *split,
                                       out.data_ptr(), stream))
    check(torch.equal(out, kroi.crop_resize_torch(imgs, rois, out_size=C)),
          "crop kernel alone != the plain version")
    for B in (1, 8):
        rows, threads = kroi.crop_split(B, 4, C, 3)
        print(f"[crop] split B={B} R=4 C=64: {rows} rows and {threads} "
              f"threads a CTA, {B * 4 * -(-C // rows)} CTAs")
    bound, by = crop_bound_ms(imgs, rois, C)
    entries["crop_resize"] = dict(
        name="crop_resize", route="cuda",
        source="src/repro_torch/kernels/csrc/roi.cu",
        replaces="src/repro/kernels/roi.py:70",
        max_abs_err=worst, ms=ms, kernel_only_ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        shape="B=8 R=4 H=W=64 ch=3 C=64")
    print(f"[crop] B=8 R=4 C=64: wrapper {ms:.4f} ms (kernel alone "
          f"{kernel_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound:.2e} ms ({by})")
    for B in (1, 2, 4, 8):
        ib, rb = imgs[:B].contiguous(), rois[:B].contiguous()
        t_k = cuda_ms(lambda: kroi.crop_resize_cuda(ib, rb, out_size=C))
        t_p = cuda_ms(lambda: kroi.crop_resize_torch(ib, rb, out_size=C),
                      iters=50, warmup=5)
        print(f"[crop-sweep] B={B} R=4 C=64: wrapper {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, bound {crop_bound_ms(ib, rb, C)[0]:.2e} ms")

    worst = 0.0
    for name, boxes, rois, bounds, C in uncrop_cases(rng):
        kw = dict(bounds=bounds, crop_size=C)
        uk = kroi.uncrop_boxes_cuda(boxes, rois, **kw)
        up = kroi.uncrop_boxes_torch(boxes, rois, **kw)
        torch.cuda.synchronize()
        err = float((uk - up).abs().max())
        oracle = torch.equal(uk.cpu(), kref.uncrop_boxes_ref(
            boxes.cpu(), rois.cpu(), **kw))
        print(f"[uncrop] {name}: equal={bool(torch.equal(uk, up))} "
              f"oracle={oracle} N={boxes.numel() // 4}")
        check(torch.equal(uk, up) and oracle,
              f"uncrop_boxes kernel != plain version on {name}")
        worst = max(worst, err)
    _, boxes, rois, bounds, C = uncrop_cases(rng)[0]
    kw = dict(bounds=bounds, crop_size=C)
    ms = cuda_ms(lambda: kroi.uncrop_boxes_cuda(boxes, rois, **kw))
    plain_ms = cuda_ms(lambda: kroi.uncrop_boxes_torch(boxes, rois, **kw),
                       iters=50, warmup=5)
    r, lead, strides = kroi.uncrop_layout(boxes.shape, rois)
    layout = kroi.uncrop_launch_layout(lead, strides)
    out = torch.empty_like(boxes)
    N = boxes.numel() // 4
    launch = build.function("roi", "uncrop_boxes_launch",
                            kroi._UNCROP_ARGS)
    kernel_ms = cuda_ms(lambda: launch(boxes.data_ptr(), r.data_ptr(), N,
                                       len(lead), layout, float(C),
                                       float(bounds[0]), float(bounds[1]),
                                       out.data_ptr(), stream))
    check(torch.equal(out, kroi.uncrop_boxes_torch(boxes, rois, **kw)),
          "uncrop kernel alone != the plain version")
    bound, by = uncrop_bound_ms(boxes, rois)
    entries["uncrop_boxes"] = dict(
        name="uncrop_boxes", route="cuda",
        source="src/repro_torch/kernels/csrc/roi.cu",
        replaces="src/repro/kernels/roi.py:130",
        max_abs_err=worst, ms=ms, kernel_only_ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        shape="boxes (8,4,32,4) rois (8,4,1,4)")
    print(f"[uncrop] N={N}: wrapper {ms:.4f} ms (kernel alone "
          f"{kernel_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound:.2e} ms ({by})")
    for B in (1, 2, 4, 8):
        bb, rb = boxes[:B].contiguous(), rois[:B].contiguous()
        t_k = cuda_ms(lambda: kroi.uncrop_boxes_cuda(bb, rb, **kw))
        t_p = cuda_ms(lambda: kroi.uncrop_boxes_torch(bb, rb, **kw),
                      iters=50, warmup=5)
        print(f"[uncrop-sweep] B={B} N={bb.numel() // 4}: wrapper "
              f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{uncrop_bound_ms(bb, rb)[0]:.2e} ms")
    deep = torch.zeros((1,) * (kroi.MAX_ROI_RANK + 1) + (4,), device=DEV)
    before = ops.launches()
    try:
        kroi.uncrop_boxes_cuda(deep, rois[0, 0, 0], **kw)
        raised = None
    except ValueError as e:
        raised = e
    check(raised is not None and ops.launches() == before,
          "uncrop_boxes_cuda: no ValueError before launching at rank "
          f"{kroi.MAX_ROI_RANK + 1}")
    print(f"[limits] uncrop_boxes_cuda at {kroi.MAX_ROI_RANK + 1} leading "
          f"dims: ValueError before any launch: {raised}")
    # a row of 4000 x 16 floats: its gather map passes a CTA's shared memory
    wide = torch.zeros((1, 8, 8, 16), device=DEV)
    before = ops.launches()
    try:
        kroi.crop_resize_cuda(wide, torch.zeros((1, 1, 4), device=DEV),
                              out_size=4000)
        raised = None
    except ValueError as e:
        raised = e
    check("shared memory" in str(raised) and ops.launches() == before,
          "crop_resize_cuda: no ValueError before launching a C=4000 ch=16 "
          "crop")
    print(f"[limits] crop_resize_cuda at C=4000 ch=16: ValueError before "
          f"any launch: {raised}")
    roi_device_times(entries, *crop_in, uncrop_cases(rng), kw)
    return entries


def roi_device_times(entries, imgs, rois, C, uncrop, kw):
    """Device time a call of crop and uncrop at the serve's shapes, B=1
    and B=8 (the uncrop on the serve's view of its rois), from the
    profiler: the CUDA-event loops above are host-bound near 0.004 ms a
    call.  The uncrop also at B=8 on the view sliced from (8, 4, 6),
    whose roi rows do not start on 16 bytes."""
    _, boxes, view, _, _ = next(c for c in uncrop
                                if c[0].startswith("serve view norm"))
    _, _, sliced, _, _ = next(c for c in uncrop
                              if c[0].startswith("serve view sliced"))
    calls = []
    for B in (1, 8):
        calls += [(f"crop B={B}", "::crop_kernel",
                   lambda B=B: kroi.crop_resize_cuda(imgs[:B], rois[:B],
                                                     out_size=C)),
                  (f"uncrop B={B}", "::uncrop_kernel",
                   lambda B=B: kroi.uncrop_boxes_cuda(boxes[:B], view[:B],
                                                      **kw))]
    calls.append(("uncrop B=8 sliced view", "::uncrop_kernel",
                  lambda: kroi.uncrop_boxes_cuda(boxes, sliced, **kw)))
    for name, ms in device_ms_a_call("roi", calls).items():
        entry = entries["crop_resize" if name.startswith("crop")
                        else "uncrop_boxes"]
        entry.setdefault("device_ms", {})[name.split(" ", 1)[1]] = ms


def device_ms_a_call(label, calls, reps=20):
    """Device time a launch of each ``(name, kernel, fn)`` from the
    profiler (``[profile <label>]`` lines), each call launching its one
    ``kernel`` and nothing else: the launch counters must rise by one a
    call, and the profiler must record that kernel and no other.  The
    profiler can drop some of a trace's kernel records (as few as 1 of
    20 recorded, once), so the time is the recorded kernel time over the
    recorded launches.  It has also recorded no device event at all in
    one trace of a run: a trace with none is taken again, at most
    ``PROFILE_TRIES`` times, each with its launches counted exactly.
    Returns ``{name: ms}``."""
    out = {}
    for name, kernel, fn in calls:
        for attempt in range(1, PROFILE_TRIES + 1):
            before = ops.launches()
            got = profile_calls(label, [(name, fn)], reps=reps)[name]
            after = ops.launches()
            grew = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
            # profile_calls makes 2 * reps + 1 calls (one untraced, a
            # dropped warm-up step, the counted step)
            check(list(grew.values()) == [2 * reps + 1],
                  f"{name}: launches counted {grew} for {2 * reps + 1} "
                  f"calls; not one {kernel} a call")
            if got or attempt == PROFILE_TRIES:
                break
            print(f"[profile {label}] {name}: trace {attempt} recorded no "
                  f"device event; tracing again")
        check(len(got) == 1 and kernel in got[0][2],
              f"{name}: launches counted {grew} for {2 * reps + 1} calls, "
              f"kernels recorded {[(r[1], r[2]) for r in got]} in trace "
              f"{attempt} of {PROFILE_TRIES}; not one {kernel} a call")
        out[name] = got[0][0] / got[0][1] / 1e3
        print(f"[profile {label}] {name}: {out[name]:.4f} ms a launch, one "
              f"{kernel[2:]} a call ({2 * reps + 1} calls counted, "
              f"{got[0][1]} of the last {reps} recorded)")
    return out


def nvr_engine(params, cfg, recorder=None):
    """The NVR serve's engine: a pinned service time below the arrival
    rate (the paper's drop regime, so the tracker both associates and
    interpolates)."""
    return DetectionEngine(cfg=cfg, params=params, n_replicas=2,
                           service_time=SERVICE_S, recorder=recorder,
                           track_and_interpolate=True, device=DEV)


def phase_serve(params, cfg, frames):
    rec = TraceRecorder()
    eng = nvr_engine(params, cfg, recorder=rec)
    eng.warmup()
    ops.reset_launches()
    t0 = time.perf_counter()
    rep = eng.serve(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    n = len(frames)
    n_interp = rep["interpolated"]
    print(f"[serve] {n} frames ({rep['n_streams']} cameras): coverage "
          f"{rep['coverage']}, detected {n - n_interp}, interpolated "
          f"{n_interp}, tracker ticks {rep['tracker_ticks']}, wall "
          f"{wall:.3f} s ({n / wall:.1f} frames/s)")
    print(f"[serve] launches: {launches}; mean micro-batch "
          f"{(n - n_interp) / max(launches['batched_nms'], 1):.2f} frames")
    det_ms = [v for _, v in rec.series.get("stage_ms_detect/0", [])]
    trk_ms = [v for _, v in rec.series.get("stage_ms_track/0", [])]
    print(f"[serve] host wall: detect {sum(det_ms):.2f} ms over "
          f"{len(det_ms)} micro-batches (median "
          f"{float(np.median(det_ms)) if det_ms else 0.0:.3f} ms), tracker "
          f"{sum(trk_ms):.2f} ms over {rep['tracker_ticks']} ticks")
    check(rep["coverage"] == 1.0, "NVR serve coverage != 1.0")
    check(len(rep["responses"]) == n, "a frame got no response")
    for r in rep["responses"]:
        rows = eng.tracker_cfg.capacity if r.interpolated else 32
        check(r.boxes.shape == (rows, 4) and np.isfinite(r.boxes).all()
              and np.isfinite(r.scores).all(), f"bad response {r.rid}")
    check(launches["batched_nms"] > 0, "NMS kernel never launched")
    check(launches["greedy_assign"] > 0, "assign kernel never launched")
    check(launches["crop_resize"] == launches["uncrop_boxes"] == 0,
          f"ROI kernels launched without a cascade: {launches}")
    return launches


def cascade_engine(params, cfg, device, recorder=None):
    return DetectionEngine(cfg=cfg, params=params, n_replicas=2,
                           catalog=paper_catalog(CASCADE_HEAVY_S), roi=True,
                           roi_bounds=ROI_BOUNDS, track_and_interpolate=True,
                           recorder=recorder, device=device)


def phase_cascade(params, cfg, frames):
    """The cascade path on the card, its launch counts against the
    schedule the recorder saw, and its report against the CPU's."""
    rec = TraceRecorder()
    eng = cascade_engine(params, cfg, DEV, rec)
    eng.warmup()
    ops.reset_launches()
    t0 = time.perf_counter()
    rep = eng.serve(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    stages = [e["stage"] for e in rec.events if e["kind"] == "stage"]
    n_det, n_roi = stages.count("detect"), stages.count("roi")
    n = len(frames)
    px = rep["roi_pixels"]
    print(f"[cascade] {n} frames ({rep['n_streams']} cameras), "
          f"paper_catalog({CASCADE_HEAVY_S}): coverage {rep['coverage']}, "
          f"models {rep['models']}, switches {rep['model_switches']}, "
          f"map_estimate {rep['map_estimate']:.4f}, ROI passes "
          f"{px['passes']} frames in {n_roi} micro-batches, pixel "
          f"reduction {rep['roi_pixel_reduction']:.4f}, interpolated "
          f"{rep['interpolated']}, wall {wall:.3f} s ({n / wall:.1f} "
          f"frames/s)")
    print(f"[cascade] launches: {launches}; first-pass micro-batches "
          f"{n_det}, ROI micro-batches {n_roi}")
    for key in ("detect", "roi", "track"):
        ms = [v for _, v in rec.series.get(f"stage_ms_{key}/0", [])]
        print(f"[cascade] host wall stage_ms_{key}: {sum(ms):.2f} ms over "
              f"{len(ms)} samples (median "
              f"{float(np.median(ms)) if ms else 0.0:.3f} ms)")
    check(rep["coverage"] == 1.0, "cascade serve coverage != 1.0")
    check(rep["model_switches"] >= 1, "the selector never switched")
    check(px["passes"] > 0 and n_roi > 0, "no ROI second pass ran")
    check(launches["crop_resize"] == launches["uncrop_boxes"] == n_roi,
          f"crop/uncrop launches != ROI micro-batches ({n_roi})")
    check(launches["batched_nms"] == n_det + n_roi,
          f"NMS launches != first-pass + ROI micro-batches "
          f"({n_det} + {n_roi})")
    check(launches["greedy_assign"] > 0, "assign kernel never launched")
    for r in rep["responses"]:
        rows = eng.tracker_cfg.capacity if r.interpolated else 32
        check(r.boxes.shape == (rows, 4) and np.isfinite(r.boxes).all()
              and np.isfinite(r.scores).all(), f"bad response {r.rid}")
    cpu = cascade_engine(params, cfg, "cpu").serve(frames)
    close_report(rep, cpu, "cascade mini-SSD cuda vs cpu", FORWARD_ATOL)
    print(f"[cascade] report cuda == cpu (discrete exact, floats within "
          f"{FORWARD_ATOL}): {len(cpu['responses'])} responses, models "
          f"{cpu['models']}")
    return launches


def phase_profile(label, eng, frames):
    """One more serve under ``torch.profiler``: device time by kernel
    and the device's busy share of the serve's wall time."""
    from torch.profiler import ProfilerActivity, profile
    eng.warmup()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"[profile {label}] serve wall {wall_ms:.2f} ms (profiled), "
          f"device busy {busy_ms:.2f} ms = {busy_ms / wall_ms:.3f} of "
          f"wall, {sum(r[1] for r in rows)} device events, copies "
          f"{copies(rows)}")
    for dev_us, count, key in rows[:15]:
        print(f"[profile {label}] {dev_us / 1e3:9.3f} ms {count:6d}x  "
              f"{key[:90]}")
    for dev_us, count, key in rows:
        if any(re.search(rf"::{k}[<(]", key) for k in SERVE_KERNELS):
            print(f"[profile {label}] {_short(key)}: "
                  f"{dev_us / count / 1e3:.4f} ms a launch over {count}")
    before = _device_ops_before(prof, "::uncrop_kernel")
    if before:
        print(f"[profile {label}] device ops just before each "
              f"uncrop_kernel on its stream: {before}")
        check(not any("direct_copy" in k for k in before),
              f"{label}: a copy kernel runs beside uncrop_kernel: {before}")
    sorts = [r for r in rows if "sort" in r[2].lower()]
    print(f"[profile {label}] sort kernels: {len(sorts)} names, "
          f"{sum(r[1] for r in sorts)} launches, "
          f"{sum(r[0] for r in sorts) / 1e3:.3f} ms; device events a frame "
          f"{sum(r[1] for r in rows) / len(frames):.1f}")


def copies(rows):
    """{"DtoH": n, "HtoD": n, "DtoD": n}: the copies among a profile's
    device rows (``_device_rows``)."""
    return {d: sum(c for _, c, k in rows if d in k)
            for d in ("DtoH", "HtoD", "DtoD")}


def profile_calls(label, calls, reps=5):
    """``reps`` calls of each ``(name, fn)`` under ``torch.profiler``:
    device time a call by kernel, to name what each call launches (ours:
    one kernel; SDPA: the library's own).  Returns each name's
    ``_device_rows``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    out = {}
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        # a warm-up step is traced and dropped before the step that counts:
        # a trace's first launches can go unrecorded (one of 20 was lost
        # once), and the callers hold the counts exactly; each step's
        # launches stand PROFILE_MARGIN_S clear of the step's edges, since
        # the profiler drops device records that it places outside the
        # traced window
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                time.sleep(PROFILE_MARGIN_S)
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                time.sleep(PROFILE_MARGIN_S)
                prof.step()
        out[name] = _device_rows(prof)
        for dev_us, count, key in out[name][:4]:
            print(f"[profile {label}] {name}: {dev_us / reps / 1e3:.4f} ms "
                  f"a call, {count // reps}x  {key[:80]}")
    return out


def _short(key):
    """A kernel's name without its namespace and parameter list (the
    innermost name called with arguments), else the key."""
    m = re.search(r"(\w+(?:<[^<>()]*>)?)\(", key)
    return m.group(1) if m else key


def _device_ops_before(prof, needle):
    """{name: count} of the device op that ran just before each launch
    of the kernel named by ``needle``, on that kernel's stream."""
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    streams = {e.device_resource_id for e in evs if needle in e.name}
    evs = sorted((e for e in evs if e.device_resource_id in streams),
                 key=lambda e: e.time_range.start)
    out = {}
    for a, b in zip(evs, evs[1:]):
        if needle in b.name:
            out[_short(a.name)] = out.get(_short(a.name), 0) + 1
    return out


def _device_rows(prof):
    """(device us, count, kernel name) of a profile's device-side
    events, largest first."""
    rows = []
    for e in prof.key_averages():
        # device-side events only: an aten op's row repeats the time of
        # the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.key.startswith("ProfilerStep"):     # a schedule's step span
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def assert_same_report(a, b, what):
    """Schedule, discrete fields and track ids equal; float fields of a
    response within 1e-4 (cuDNN vs CPU conv sums; ULPs in the tracker's
    Kalman arithmetic)."""
    check(set(a) == set(b), f"{what}: report keys differ")
    check(len(a["responses"]) == len(b["responses"]),
          f"{what}: response count")
    for ra, rb in zip(a["responses"], b["responses"]):
        for f in ("rid", "replica", "t_start", "t_done", "service_s",
                  "interpolated", "stream_id", "seq"):
            check(getattr(ra, f) == getattr(rb, f), f"{what}: {f}")
        for f in ("classes", "valid"):
            check(np.array_equal(getattr(ra, f), getattr(rb, f)),
                  f"{what}: rid {ra.rid} {f}")
        check(np.array_equal(ra.track_ids, rb.track_ids),
              f"{what}: rid {ra.rid} track_ids")
        for f in ("boxes", "scores"):
            check(np.allclose(getattr(ra, f), getattr(rb, f), rtol=0,
                              atol=1e-4), f"{what}: rid {ra.rid} {f}")


def close_report(a, b, what, atol, rtol=0.0, nan_equal=False):
    """Recursive report comparison: floats (virtual clock, boxes,
    scores, pixel tallies) of ``a`` within ``atol`` + ``rtol`` times
    those of ``b``, everything discrete (keys, lengths, ints, bools,
    strings, class ids, track ids) exact.  With ``nan_equal`` a NaN
    float must face a NaN (a field a run leaves undefined)."""
    def walk(x, y, path):
        if hasattr(x, "__dataclass_fields__"):
            x, y = vars(x), vars(y)
        if isinstance(x, dict):
            check(set(x) == set(y), f"{what}: keys of {path}")
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif isinstance(x, (list, tuple)):
            check(len(x) == len(y), f"{what}: length of {path}")
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(x, np.ndarray) or np.ndim(x):
            u, v = np.asarray(x), np.asarray(y)
            check(u.shape == v.shape and u.dtype == v.dtype,
                  f"{what}: {path} shape/dtype")
            if np.issubdtype(u.dtype, np.floating):
                if nan_equal:
                    check(np.array_equal(np.isnan(u), np.isnan(v)),
                          f"{what}: {path} NaN places differ")
                    u, v = np.nan_to_num(u), np.nan_to_num(v)
                excess = np.abs(u - v) - rtol * np.abs(v)
                err = float(excess.max()) if u.size else 0.0
                check(err <= atol, f"{what}: {path} differs by {err} "
                      f"beyond rtol {rtol}")
            else:
                check(np.array_equal(u, v), f"{what}: {path} "
                      f"{u.tolist()} != {v.tolist()}")
        elif isinstance(x, float):
            check((nan_equal and x != x and y != y)
                  or abs(x - y) <= atol + rtol * abs(y),
                  f"{what}: {path} {x} != {y}")
        else:
            check(x == y, f"{what}: {path} {x!r} != {y!r}")
    walk(a, b, "report")


def phase_parity(params, cfg):
    # oracle detector: the schedule is pure Python, the tracker runs on
    # the card (association kernel) and on the CPU (plain version)
    frames, frame_of, videos, dets = make_nvr_streams(4, 24, rate=4.0)
    kw = dict(n_replicas=2, service_time=0.4, track_and_interpolate=True)
    reps = [DetectionEngine(detect_fn=proxy_detect_fn_streams(
                videos, dets, frame_of), device=d, **kw).serve(frames)
            for d in (DEV, "cpu")]
    assert_same_report(*reps, "oracle path cuda vs cpu")
    print(f"[parity] oracle NVR report, cuda == cpu: "
          f"{len(reps[0]['responses'])} responses, "
          f"{reps[0]['interpolated']} interpolated")
    # oracle cascade: selection, ROI windows and the crop kernel on the
    # card (its crops unread by the oracle), the tracker on the card;
    # 16 frames/s fit the medium model's 40 with headroom, not the
    # heavy model's 20
    cat = paper_catalog(0.1)
    bounds = (videos[0].spec.width, videos[0].spec.height)
    kw = dict(n_replicas=2, catalog=cat, roi=True, roi_bounds=bounds,
              track_and_interpolate=True)
    reps = [DetectionEngine(detect_fn=make_cascade_detect_fn(
                videos, frame_of, cat), device=d, **kw).serve(frames)
            for d in (DEV, "cpu")]
    assert_same_report(*reps, "oracle cascade cuda vs cpu")
    for k in ("models", "model_of_frame", "model_switches", "roi_pixels",
              "roi_pixel_reduction", "map_estimate"):
        check(reps[0][k] == reps[1][k], f"oracle cascade cuda vs cpu: {k}")
    check(reps[0]["roi_pixels"]["passes"] > 0, "oracle cascade: no ROI pass")
    print(f"[parity] oracle cascade report, cuda == cpu: models "
          f"{reps[0]['models']}, switches {reps[0]['model_switches']}, "
          f"ROI passes {reps[0]['roi_pixels']['passes']}")
    # real mini-SSD + NMS kernel + tracker on a short trace
    frames, *_ = nvr_frames(2, 8, rate=8.0)
    kw = dict(cfg=cfg, n_replicas=2, micro_batch=4, service_time=0.05,
              track_and_interpolate=True)
    reps = [DetectionEngine(params=params, device=d, **kw).serve(frames)
            for d in (DEV, "cpu")]
    assert_same_report(*reps, "mini-SSD path cuda vs cpu")
    n_det = sum(int(r.valid.sum()) for r in reps[0]["responses"])
    print(f"[parity] mini-SSD NVR report, cuda == cpu: "
          f"{len(reps[0]['responses'])} responses, {n_det} detections")
    batch_invariance(params, cfg)


def batch_invariance(params, cfg):
    """The same frames served with micro_batch 1 and 5 on the card (the
    real mini-SSD, NMS kernel and tracker; cuDNN may pick another
    algorithm for each batch size): every discrete output equal, boxes
    and scores within ``BATCH_ATOL``; prints the largest difference."""
    frames, *_ = nvr_frames(2, 10, rate=50.0)
    reps = {}
    for mb in (1, 5):
        rec = TraceRecorder()
        reps[mb] = DetectionEngine(
            cfg=cfg, params=params, n_replicas=2, micro_batch=mb,
            service_time=0.001, track_and_interpolate=True, recorder=rec,
            device=DEV).serve(frames)
        n_mb = sum(1 for e in rec.events if e["kind"] == "stage"
                   and e["stage"] == "detect")
        check(n_mb == len(frames) // mb,
              f"micro_batch={mb}: {n_mb} micro-batches")
    worst = 0.0
    for a, b in zip(reps[1]["responses"], reps[5]["responses"]):
        for f in ("rid", "interpolated", "stream_id", "seq"):
            check(getattr(a, f) == getattr(b, f), f"mb 1 vs 5: {f}")
        for f in ("valid", "classes", "track_ids"):
            check(np.array_equal(getattr(a, f), getattr(b, f)),
                  f"mb 1 vs 5: rid {a.rid} {f}")
        for f in ("boxes", "scores"):
            worst = max(worst, float(np.abs(getattr(a, f) -
                                            getattr(b, f)).max()))
    n_det = sum(int(r.valid.sum()) for r in reps[1]["responses"])
    print(f"[parity] micro_batch 1 vs 5 on {DEV}, {len(frames)} frames, "
          f"{n_det} detections: valid, classes, keep order and track ids "
          f"equal; largest box/score difference {worst:.3e} (atol "
          f"{BATCH_ATOL})")
    check(worst <= BATCH_ATOL, f"micro_batch 1 vs 5 differ by {worst}")


def _close(got, want, tol):
    """Max |got - want| in float32, and whether it is within the
    reference's ``assert_allclose(rtol=tol, atol=tol)``."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    return err, bool(torch.allclose(g, w, rtol=tol, atol=tol))


def hold_to_plain(tag, name, got, x, kernel, plain, tols):
    """Hold a kernel's results ``got`` (a tuple) on inputs ``x`` against
    its plain version; print the differences and return the largest one
    in float32 (before a bf16 rounding), the largest between the results
    themselves, and whether every check held.

    Float32 inputs: each result within ``tols`` (rtol = atol, one a
    result) of the plain version's.  Bfloat16 inputs: kernel and plain
    version both compute in float32 and round once, and widening bf16 to
    float32 is exact, so on the widened inputs the kernel's float32
    instance does the same arithmetic.  Its results must round to ``got``
    bit for bit, and must be within ``tols`` of the plain version's
    float32 results: the bf16 results are held to the plain version
    before the last rounding, not to the bf16 grid."""
    wide = tuple(t.float() for t in x)
    want = plain(*wide)
    bf16 = x[0].dtype == torch.bfloat16
    k32 = kernel(*wide) if bf16 else got
    k32, want = ((r,) if torch.is_tensor(r) else r for r in (k32, want))
    exact = all(torch.equal(g, k.to(g.dtype)) for g, k in zip(got, k32))
    errs = [_close(k, w, tol) for k, w, tol in zip(k32, want, tols)]
    shapes = all(g.shape == k.shape == w.shape and k.dtype == w.dtype
                 for g, k, w in zip(got, k32, want))
    ok = exact and shapes and all(o for _, o in errs)
    msg = "; ".join(f"float32 max |kernel - plain| {e:.3e} within {tol}: "
                    f"{o}" for (e, o), tol in zip(errs, tols))
    direct = max(_close(g, w.to(g.dtype), 0.0)[0]
                 for g, w in zip(got, want))
    if bf16:
        msg += (f"; bf16 result == float32 instance rounded: {exact}; "
                f"bf16 max |kernel - plain| {direct:.3e}")
    print(f"[{tag}] {name}: {msg}")
    return max(e for e, _ in errs), direct, ok


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)


def tick_rows(rng, B, D):
    """One tick's random detection rows (pixel boxes, three classes,
    about four in five valid)."""
    tl = rng.uniform(0, 400, (B, D, 2)).astype(np.float32)
    wh = rng.uniform(10, 60, (B, D, 2)).astype(np.float32)
    return (np.concatenate([tl, tl + wh], -1),
            rng.uniform(0.5, 1.0, (B, D)).astype(np.float32),
            rng.integers(0, 3, (B, D)).astype(np.int32),
            rng.random((B, D)) > 0.2)


def track_ms(rec):
    return sum(v for _, v in rec.series.get("stage_ms_track/0", []))


class StagedTicks(tpipe.TickPipeline):
    """``TickPipeline`` with each tick run by the staged chain of the
    ``tracking`` functions on the pipeline's device: ``trk.step`` (or
    ``trk.coast`` on a detection-free tick), then ``trk.output``.  What
    a serve's fused ticks are held to bit for bit."""

    def tick(self, state, boxes, scores, classes, valid):
        self.launches += 1
        state, tid = trk.step(
            state, *(torch.from_numpy(np.asarray(a)).to(self.device)
                     for a in (boxes, scores, classes, valid)), self.cfg)
        return state, tid.cpu().numpy(), self._output(state)

    def coast(self, state, det_width=1):
        self.launches += 1
        state = trk.coast(state, self.cfg)
        return state, self._output(state)

    def _output(self, state):
        return tuple(a.cpu().numpy() for a in trk.output(state, self.cfg))


@contextlib.contextmanager
def staged_chain():
    """Engines serving inside run their tracker ticks as ``StagedTicks``."""
    from repro_torch.serving import engine as eng_mod
    fused = eng_mod.TickPipeline
    eng_mod.TickPipeline = StagedTicks
    try:
        yield
    finally:
        eng_mod.TickPipeline = fused


def timed_serve(params, cfg, frames):
    """One NVR serve on the card: (report, its tracker host wall ms, the
    serve's launches counted from zero)."""
    rec = TraceRecorder()
    eng = nvr_engine(params, cfg, recorder=rec)
    eng.warmup()
    ops.reset_launches()
    rep = eng.serve(frames)
    torch.cuda.synchronize()
    return rep, track_ms(rec), ops.launches()


def phase_fused(params, cfg, frames, profile=False):
    """The NVR serve's fused ticks: the graphs' launch accounting, the
    report against the staged chain's on the card, and the fused window
    against the staged chain."""
    tpipe.clear_tick_graphs()
    rep, first_ms, launches = timed_serve(params, cfg, frames)
    graphs = tpipe.tick_graphs()
    ticks = rep["tracker_ticks"]
    check(len(graphs) == 1, f"fused serve captured {len(graphs)} graphs")
    g = graphs[0]
    per = g.captured.get("greedy_assign", 0)
    print(f"[fused] NVR serve, fused tick: {len(graphs)} capture (K, B, "
          f"D) = {g.shape}, {g.replays} replays for {ticks} ticks, a replay "
          f"launches {g.captured}; greedy_assign launches "
          f"{launches['greedy_assign']} = (1 warm-up + {g.replays} replays)"
          f" x {per}; all launches {launches}")
    check(g.shape == (1, rep["n_streams"], 32), f"graph shape {g.shape}")
    check(g.captured == {"greedy_assign": 1},
          f"a replay should launch one assignment, captured {g.captured}")
    check(g.replays == ticks == rep["tracker_launches"],
          f"{g.replays} replays for {ticks} ticks")
    check(launches["greedy_assign"] == (1 + g.replays) * per,
          f"greedy_assign launches {launches['greedy_assign']} != (1 + "
          f"{g.replays}) x {per}")
    check(launches["batched_nms"] > 0, "NMS kernel never launched")
    check(rep["coverage"] == 1.0 and rep["interpolated"] > 0,
          "fused serve: coverage != 1.0 or nothing interpolated")
    with staged_chain():
        chain, chain_ms, _ = timed_serve(params, cfg, frames)
    close_report(chain, rep, "NVR serve: staged chain vs fused ticks", 0.0)
    again, again_ms, _ = timed_serve(params, cfg, frames)
    close_report(again, rep, "NVR serve: a second fused serve", 0.0)
    check(len(tpipe.tick_graphs()) == 1, "a later fused serve recaptured")
    print(f"[fused] report == the staged chain's serve on the card and a "
          f"second fused serve's, exactly; tracker host wall "
          f"(stage_ms_track, {ticks} ticks): fused {first_ms:.2f} ms with "
          f"its capture, {again_ms:.2f} ms replayed ({again_ms / ticks:.3f}"
          f" ms a tick); staged chain {chain_ms:.2f} ms "
          f"({chain_ms / ticks:.3f} ms a tick)")
    fused_window_check()
    if profile:
        profile_tracker_stage(params, cfg, frames, rep)
    return launches


def fused_window_check():
    """``fused_window`` at (K, B, D) = (8, 4, 32) against the staged
    chain on the card, bit for bit, in one replay; then each timed."""
    rng = np.random.default_rng(SEED + 19)
    K, B, D = FUSED_K, 4, 32
    tcfg = trk.TrackerConfig()
    ticks = [tick_rows(rng, B, D) for _ in range(K)]
    ticks[3] = tuple(np.zeros_like(a) for a in ticks[3])   # no detection
    stacked = tuple(np.stack([t[i] for t in ticks]) for i in range(4))
    state = trk.init_state(B, tcfg, device=DEV)
    tids, outs = [], []
    for t in ticks:
        state, tid = trk.step(state, *(torch.from_numpy(a).to(DEV)
                                       for a in t), tcfg)
        tids.append(tid.cpu().numpy())
        outs.append([a.cpu().numpy() for a in trk.output(state, tcfg)])
    before = {gr.shape: gr.replays for gr in tpipe.tick_graphs()}
    wstate, wtid, wout = tpipe.fused_window(
        trk.init_state(B, tcfg, device=DEV), *stacked, tcfg)
    gw = [gr for gr in tpipe.tick_graphs() if gr.shape == (K, B, D)]
    check(len(gw) == 1 and gw[0].replays - before.get((K, B, D), 0) == 1,
          "the window did not run as one replay of one graph")
    check(all(torch.equal(a, b) for a, b in zip(state, wstate)),
          "fused window: final table != the staged chain's")
    for k in range(K):
        check(np.array_equal(wtid[k], tids[k]), f"window det_tid tick {k}")
        for i, a in enumerate(wout):
            check(np.array_equal(a[k], outs[k][i]),
                  f"window output {i} tick {k}")
    print(f"[fused] fused_window K={K} B={B} D={D}: one replay, det_tid, "
          f"outputs and final table equal to the staged chain bit for bit;"
          f" a replay launches {gw[0].captured}")
    held = {"staged": trk.init_state(B, tcfg, device=DEV), "window": wstate}

    def staged_ticks():
        st = held["staged"]
        for t in ticks:
            st, tid = trk.step(st, *(torch.from_numpy(a).to(DEV)
                                     for a in t), tcfg)
            tid.cpu().numpy()
            [a.cpu().numpy() for a in trk.output(st, tcfg)]
        held["staged"] = st

    def window():
        held["window"] = tpipe.fused_window(held["window"], *stacked,
                                            tcfg)[0]

    t_staged = cuda_ms(staged_ticks, iters=20, warmup=3)
    t_window = cuda_ms(window, iters=20, warmup=3)
    print(f"[fused] {K} ticks B={B} D={D} with their outputs on the host "
          f"(CUDA events, 20 after 3): staged {t_staged:.4f} ms, one "
          f"window replay {t_window:.4f} ms ({t_staged / t_window:.1f}x)")


def profile_tracker_stage(params, cfg, frames, rep):
    """The fused serve's tracker stage (``_interpolate`` over its
    detections) replayed under ``torch.profiler``: copies, device
    events and device time a tick."""
    from torch.profiler import ProfilerActivity, profile
    det = [r for r in rep["responses"] if not r.interpolated]
    seq_of = {r.rid: r.seq for r in rep["responses"]}
    frames = sorted(frames, key=lambda f: f.t_arrival)
    ticks = rep["tracker_ticks"]
    eng = nvr_engine(params, cfg)
    eng._interpolate(frames, det, seq_of, {})       # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._interpolate(frames, det, seq_of, {})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    cp = copies(rows)
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[profile track] {ticks} ticks: wall {wall_ms:.2f} ms "
          f"(profiled), device busy {busy:.3f} ms, "
          f"{sum(r[1] for r in rows) / ticks:.1f} device events a tick;"
          f" a tick: DtoH {cp['DtoH'] / ticks:.2f}, HtoD "
          f"{cp['HtoD'] / ticks:.2f}, DtoD {cp['DtoD'] / ticks:.2f}")
    for dev_us, count, key in rows[:6]:
        print(f"[profile track] {dev_us / 1e3:9.3f} ms "
              f"{count:6d}x  {key[:80]}")


def phase_parallel():
    """Table IV (ETH-Sunnyday, YOLOv3 on n NCS2s, n = 1..7) with the
    tracker on the card, each row against the same run on the CPU."""
    recorded = []
    wrapper = ops.greedy_assign_cuda

    def recording(*args, **kw):
        if len(recorded) < 64:
            recorded.append(([a.clone() for a in args], dict(kw)))
        return wrapper(*args, **kw)

    ops.reset_launches()
    reports, processed = {}, 0
    for n in TABLE_IV_N:
        ops.greedy_assign_cuda = recording if n == 1 else wrapper
        try:
            t0 = time.perf_counter()
            r = ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"] * n,
                                 device=DEV).run(track=True)
            torch.cuda.synchronize()
            reports[n] = (r, time.perf_counter() - t0)
        finally:
            ops.greedy_assign_cuda = wrapper
        processed += round(BENCHMARK_VIDEOS["ETH-Sunnyday"].n_frames
                           * (1 - r.drop_rate))
    launches = ops.launches()
    print(f"[parallel] launches over n = 1..7: {launches}; processed "
          f"frames {processed}")
    check(launches["greedy_assign"] == processed > 0,
          f"greedy_assign launches {launches['greedy_assign']} != one a "
          f"processed frame ({processed})")
    for n, (r, wall) in reports.items():
        cpu = ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"] * n,
                               device="cpu").run(track=True)
        for f in ("video", "model", "scheduler", "n", "sigma", "map_score",
                  "drop_rate", "drops_per_processed", "offline",
                  "track_coverage", "id_switches"):
            check(getattr(r, f) == getattr(cpu, f),
                  f"Table IV n={n}: {f} cuda {getattr(r, f)} != cpu "
                  f"{getattr(cpu, f)}")
        check(abs(r.map_tracked - cpu.map_tracked) <= MAP_ATOL,
              f"Table IV n={n}: map_tracked cuda {r.map_tracked} vs cpu "
              f"{cpu.map_tracked}")
        check(np.isfinite(r.map_tracked) and 0 < r.track_coverage <= 1,
              f"Table IV n={n}: map_tracked / coverage out of range")
        print(f"[parallel] {r.row()}, map_tracked "
              f"{r.map_tracked * 100:.1f}, coverage {r.track_coverage:.3f},"
              f" id_switches {r.id_switches:.0f}; cuda {wall:.2f} s; == cpu"
              f" (map_tracked within "
              f"{abs(r.map_tracked - cpu.map_tracked):.1e})")
    check(recorded, "no assignment call recorded on the Table IV path")
    shapes = sorted({tuple(a[1].shape) for a, _ in recorded})
    for args, kw in recorded:
        mk = kassoc.greedy_assign_cuda(*args, **kw)
        mp = kassoc.greedy_assign_torch(*args, **kw)
        check(torch.equal(mk, mp), "assignment kernel != plain version on "
              "a recorded Table IV call")
    print(f"[parallel] {len(recorded)} recorded assignment calls of the "
          f"n=1 run (detection boxes {shapes}): kernel == plain version")
    return launches


# ------------------------------------------------------- training (PR 20)
def load_example():
    """``examples/video_analytics_torch.py``, loaded by path (it is a
    script beside the reference's example, not a package module)."""
    spec = importlib.util.spec_from_file_location("video_analytics_torch",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_run(ex, video, params0, device, steps, record=True):
    """``steps`` SGD steps of the example's ``train_detector`` on
    ``device`` from ``params0``; returns (params, per-step history, wall
    seconds).  ``record`` reads every step's loss (a sync a step);
    without it only the example's print points are read."""
    hist = [] if record else None
    t0 = time.perf_counter()
    _, params, _ = ex.train_detector(
        video, steps, batch=TRAIN_BATCH, device=device,
        params=params_to(params0, device), history=hist,
        log=lambda line: print(f"[train] {device}: {line.strip()}"))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return params, hist, time.perf_counter() - t0


def phase_train(cfg, anchors, profile=False):
    """The mini-SSD trained on the card by the example's SGD loop (full
    width, batch 8, 150 steps, ETH-Sunnyday), twice on ``cuda`` (losses
    and weights bit-equal) and once on the CPU (each step's loss and
    parts within ``TRAIN_RTOL``); then trained on in chunks of 150 steps
    (each chunk the example's loop from the last weights) up to
    ``TRAIN_STEPS_LONG``.  Each checkpoint's detector decodes 8 frames
    (valid detections a frame; the NMS kernel exact against its plain
    version on those candidates); the 150-step one gives the example's
    per-frame inference time.  Returns the NMS launches of the path and
    the weights the sharded phase serves: the first checkpoint with a
    frame whose valid count lies strictly between 0 and ``max_out`` (NMS
    ending on a real score tail), else the 150-step ones."""
    ex = load_example()
    video = SyntheticVideo(BENCHMARK_VIDEOS["ETH-Sunnyday"])
    params0 = init_ssd(cfg, torch.Generator().manual_seed(SEED),
                       device="cpu")
    found = tf32_settings()
    print(f"[train] TF32 switches as found: {found}; cudnn deterministic "
          f"{torch.backends.cudnn.deterministic}, benchmark "
          f"{torch.backends.cudnn.benchmark}")
    ops.reset_launches()
    runs = [train_run(ex, video, params0, DEV, TRAIN_STEPS)
            for _ in range(2)]
    check(tf32_settings() == found, "a training step left TF32 changed")
    (pa, ha, wa), (pb, hb, wb) = runs
    check(ha == hb, "two cuda trainings: the losses differ")
    check(all(torch.equal(x, y) for x, y in zip(ex.leaves(pa),
                                                ex.leaves(pb))),
          "two cuda trainings: the weights differ")
    make = ex.make_batch_fn(video, cfg, TRAIN_BATCH)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        make(rng)
    batch_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    print(f"[train] {TRAIN_STEPS} steps, batch {TRAIN_BATCH}, on {DEV}: "
          f"{wa / TRAIN_STEPS * 1e3:.3f} and {wb / TRAIN_STEPS * 1e3:.3f} ms "
          f"a step (host wall, a loss read a step included; of which the "
          f"numpy batch making {batch_ms:.3f} ms); the two runs bit-equal "
          f"(losses and weights)")
    pc, hc, wc = train_run(ex, video, params0, "cpu", TRAIN_STEPS)
    worst = 0.0
    for i, (g, c) in enumerate(zip(ha, hc)):
        for j, name in enumerate(("loss", "box", "obj", "cls")):
            err = abs(g[j] - c[j]) / max(abs(c[j]), TRAIN_FLOOR)
            worst = max(worst, err)
            check(err <= TRAIN_RTOL, f"train step {i} {name}: cuda {g[j]} "
                  f"vs cpu {c[j]} (relative {err:.2e} > {TRAIN_RTOL})")
    werr = max(float((x.cpu() - y).abs().max())
               for x, y in zip(ex.leaves(pa), ex.leaves(pc)))
    print(f"[train] cpu: {wc / TRAIN_STEPS * 1e3:.3f} ms a step; every "
          f"step's loss and parts cuda vs cpu within {worst:.2e} relative "
          f"(held to {TRAIN_RTOL}); trained weights differ by {werr:.2e}; "
          f"loss {ha[0][0]:.4f} -> {ha[-1][0]:.4f}")
    checkpoints = {TRAIN_STEPS: pa}
    p, wl = pa, 0.0
    for steps in range(2 * TRAIN_STEPS, TRAIN_STEPS_LONG + 1, TRAIN_STEPS):
        p, _, w = train_run(ex, video, p, DEV, TRAIN_STEPS, record=False)
        checkpoints[steps] = p
        wl += w
    n_long = TRAIN_STEPS_LONG - TRAIN_STEPS
    print(f"[train] {n_long} more steps on {DEV} in chunks of "
          f"{TRAIN_STEPS}: {wl / n_long * 1e3:.3f} ms a step (host wall, "
          f"losses read at the print points only)")
    idx = np.linspace(0, video.spec.n_frames - 1, 8).astype(int)
    imgs = torch.from_numpy(np.stack([video.pixels(int(i))
                                      for i in idx])).to(DEV)
    valid = {n: decode_detections(p, cfg, imgs, anchors)[3].sum(1).tolist()
             for n, p in checkpoints.items()}
    per_frame = ex.inference_ms(pa, cfg, anchors, video)
    torch.cuda.synchronize()
    launches = ops.launches()
    mo = NMS_KW["max_out"]
    for n, counts in valid.items():
        print(f"[train] {n}-step detector on frames {idx.tolist()}: valid "
              f"detections a frame {counts} (max_out {mo})")
    print(f"[train] inference {per_frame * 1e3:.3f} ms a frame (the "
          f"example's step 2, {TRAIN_STEPS}-step weights, one frame a "
          f"call); launches {launches}")
    check(launches["batched_nms"] == len(checkpoints) + 11,
          f"NMS launches {launches['batched_nms']} != "
          f"{len(checkpoints)} decodes + 11 timed")
    for n, p in checkpoints.items():
        boxes, scores, _ = ssd_candidates(p, cfg, imgs, anchors)
        kk, kv = knms.batched_nms_cuda(boxes, scores, **NMS_KW)
        pk, pv = knms.batched_nms_torch(boxes, scores, **NMS_KW)
        check(torch.equal(kk, pk) and torch.equal(kv, pv),
              f"NMS kernel != plain version on the {n}-step candidates")
        q = torch.quantile(scores.flatten().cpu(),
                           torch.tensor([0.01, 0.5, 0.99])).tolist()
        print(f"[train] NMS kernel == plain version on the {n}-step "
              f"detector's 8 x {boxes.shape[1]} candidates (keep and valid "
              f"exact); scores 1/50/99th percentile "
              f"{', '.join(f'{x:.4f}' for x in q)}, max "
              f"{float(scores.max()):.4f}")
    if profile:
        profile_train(pa, cfg)
    tail = [n for n, c in valid.items() if any(0 < v < mo for v in c)]
    served = tail[0] if tail else TRAIN_STEPS
    print(f"[train] the sharded phase serves the {served}-step weights"
          + ("" if tail else " (no checkpoint ended NMS on a score tail)"))
    return launches, checkpoints[served]


def profile_train(params, cfg, steps=20):
    """``steps`` SGD steps of the example's loop under ``torch.profiler``
    (after one untraced step): host wall and device busy a step, device
    events a step, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    ex = load_example()
    video = SyntheticVideo(BENCHMARK_VIDEOS["ETH-Sunnyday"])
    ex.train_detector(video, 1, batch=TRAIN_BATCH, device=DEV,
                      params=params, log=lambda line: None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.train_detector(video, steps, batch=TRAIN_BATCH, device=DEV,
                          params=params, log=lambda line: None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"[profile train] {steps} steps: wall {wall_ms / steps:.3f} ms a "
          f"step (profiled), device busy {busy_ms / steps:.3f} ms a step = "
          f"{busy_ms / wall_ms:.3f} of wall, "
          f"{sum(r[1] for r in rows) / steps:.1f} device events a step, "
          f"copies {copies(rows)}")
    for dev_us, count, key in rows[:8]:
        print(f"[profile train] {dev_us / steps / 1e3:9.4f} ms a step "
              f"{count // steps:4d}x  {key[:90]}")


# ------------------------------------------------- sharded serving (PR 20)
class TickCount:
    """Counts ``TickPipeline.tick`` (a detection tick) and ``coast``
    calls while installed."""

    def __init__(self):
        self.n = {"tick": 0, "coast": 0}
        self._orig = {}

    def __enter__(self):
        for name in self.n:
            fn = getattr(tpipe.TickPipeline, name)
            self._orig[name] = fn

            def counted(pipe, *a, _fn=fn, _name=name, **k):
                self.n[_name] += 1
                return _fn(pipe, *a, **k)
            setattr(tpipe.TickPipeline, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(tpipe.TickPipeline, name, fn)


def sharded_engine(params, cfg, device, **kw):
    return ShardedDetectionEngine(cfg=cfg, params=params, n_replicas=2,
                                  service_time=SERVICE_S,
                                  track_and_interpolate=True, device=device,
                                  **kw)


def sharded_serve(label, params, cfg, frames, **kw):
    """One sharded serve on the card, its launch accounting against the
    recorder's micro-batches and the tracker's ticks' graphs, and its
    host wall.  Returns (report, launches)."""
    rec = TraceRecorder()
    eng = sharded_engine(params, cfg, DEV, recorder=rec, **kw)
    eng.warmup()
    tpipe.clear_tick_graphs()
    ops.reset_launches()
    with TickCount() as tc:
        t0 = time.perf_counter()
        rep = eng.serve(frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = ops.launches()
    n_mb = sum(1 for e in rec.events
               if e["kind"] == "stage" and e["stage"] == "detect")
    n = len(frames)
    det = [int(r.valid.sum()) for r in rep["responses"]
           if not r.interpolated]
    mo = NMS_KW["max_out"]
    print(f"[sharded] {label}: {n} frames, {rep['n_streams']} cameras, "
          f"{rep['n_shards']} shards: coverage {rep['coverage']}, "
          f"interpolated {rep['interpolated']}, dropped "
          f"{len(rep['dropped'])}, micro-batches {n_mb}, ticks {tc.n}, "
          f"migrations {len(rep.get('migrations', []))}; valid a detected "
          f"frame min/median/max {min(det)}/{int(np.median(det))}/"
          f"{max(det)}, {det.count(mo)} of {len(det)} at max_out; host "
          f"wall {wall * 1e3:.2f} ms; launches {launches}")
    # every frame answered (detected or interpolated) but the frames a
    # dead shard lost, which no engine saw
    lost = rep.get("faults", {}).get("frames_lost_shard", 0)
    check(len(rep["responses"]) + lost == n,
          f"{label}: {len(rep['responses'])} responses + {lost} lost != "
          f"{n} frames")
    check(launches["batched_nms"] == n_mb > 0,
          f"{label}: NMS launches {launches['batched_nms']} != "
          f"micro-batches {n_mb}")
    check(tc.n["tick"] + tc.n["coast"] == rep["tracker_launches"] > 0,
          f"{label}: ticks {tc.n} != tracker_launches "
          f"{rep['tracker_launches']}")
    graphs = tpipe.tick_graphs()
    want = sum((1 + g.replays) * g.captured.get("greedy_assign", 0)
               for g in graphs)
    print(f"[sharded] {label}: {len(graphs)} graphs captured (K, B, D)"
          f" = {sorted(g.shape for g in graphs)}, "
          f"{sum(g.replays for g in graphs)} replays")
    check(sum(g.replays for g in graphs) == rep["tracker_launches"],
          f"{label}: graph replays != tracker ticks")
    check(launches["greedy_assign"] == want,
          f"{label}: assignment launches {launches['greedy_assign']} "
          f"!= warm-ups + replays x captured ({want})")
    return rep, launches


def phase_sharded(params, cfg):
    """``ShardedDetectionEngine`` on the card with the trained mini-SSD:
    static 1, 2 and 4 shards with and without a one-device mesh,
    rebalancing on the skewed trace, a shard kill and a replica kill
    under the watchdog, every serve against ``device="cpu"``, and the
    rebalancing serve against the staged chain's on the card.  Returns
    the launches summed over the serves."""
    total = {k: 0 for k in ops.launches()}

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    cpu_params = params_to(params, "cpu")

    def against_cpu(rep, label, frames, **kw):
        cpu = sharded_engine(cpu_params, cfg, "cpu", **kw).serve(frames)
        close_report(rep, cpu, f"sharded {label} cuda vs cpu",
                     FORWARD_ATOL)

    frames, *_ = nvr_frames(SHARD_CAMS, SHARD_FRAMES, rate=RATE_FPS)
    mesh = (f"{DEV}:0",)                # one device: bit for bit
    for n in SHARD_COUNTS:
        rep, launches = sharded_serve(f"static n_shards={n}", params, cfg,
                                      frames, n_shards=n)
        add(launches)
        mrep, launches = sharded_serve(f"static n_shards={n} mesh {mesh}",
                                       params, cfg, frames, n_shards=n,
                                       mesh=mesh)
        add(launches)
        close_report(mrep, rep, f"n_shards={n}: mesh vs meshless", 0.0)
        against_cpu(rep, f"n_shards={n}", frames, n_shards=n)
        if n == 1:
            base = DetectionEngine(cfg=cfg, params=params, n_replicas=2,
                                   service_time=SERVICE_S,
                                   track_and_interpolate=True,
                                   device=DEV).serve(frames)
            close_report(base, {k: rep[k] for k in base},
                         "n_shards=1 vs DetectionEngine", 0.0)
        print(f"[sharded] n_shards={n}: mesh == meshless bit for bit, cuda "
              f"== cpu (floats within {FORWARD_ATOL})"
              + ("; == DetectionEngine exactly" if n == 1 else ""))
    skewed, *_ = nvr_frames(SHARD_CAMS, SHARD_FRAMES, RATE_FPS,
                            make=make_skewed_streams, n_shards=2)
    kw = dict(n_shards=2, rebalance=True, epoch_s=SHARD_EPOCH_S)
    steal, launches = sharded_serve("rebalance, skewed", params, cfg,
                                    skewed, **kw)
    add(launches)
    check(steal["migrations"], "rebalancing serve: no migration")
    against_cpu(steal, "rebalance", skewed, **kw)
    print(f"[sharded] rebalance: migrations {steal['migrations']}, "
          f"{steal['n_epochs']} epochs; cuda == cpu")
    faults = (FaultSchedule.shard_kill(SHARD_KILL_T, shard=0)
              + FaultSchedule.replica_kill(REPLICA_KILL_T, replica=1,
                                           shard=1,
                                           revive_t=REPLICA_REVIVE_T))
    fkw = dict(n_shards=2, rebalance=True, epoch_s=SHARD_EPOCH_S)
    frep, launches = sharded_serve("shard kill + replica kill, watchdog",
                                   params, cfg, frames, faults=faults,
                                   supervisor=Watchdog(), **fkw)
    add(launches)
    fl = frep["faults"]
    check(fl["frames_lost_shard"] > 0 and fl["restarts"],
          f"fault serve: no frame lost or no restart: {fl}")
    check(sum(frep["retries"].values()) > 0, "fault serve: no retry")
    cpu = sharded_engine(cpu_params, cfg, "cpu", faults=faults,
                         supervisor=Watchdog(), **fkw).serve(frames)
    close_report(frep, cpu, "sharded faults cuda vs cpu", FORWARD_ATOL)
    print(f"[sharded] faults: {fl}, recovered_coverage "
          f"{frep['recovered_coverage']}, retries {frep['retries']}, "
          f"failovers {frep['failovers']}, migrations "
          f"{frep['migrations']}; cuda == cpu")
    with staged_chain():
        chain = sharded_engine(params, cfg, DEV, **kw).serve(skewed)
    close_report(steal, chain, "sharded rebalance: fused ticks vs the "
                 "staged chain", 0.0)
    print("[sharded] rebalance: report == the same serve with its ticks run "
          "by the staged chain on the card, exactly")
    return total


def phase_seed_nms(params, cfg, anchors, frames):
    """The seed's per-image NMS path on the card: ``ops.nms_serial`` and
    ``ops.nms`` on each of 8 frames of mini-SSD candidates, counted from
    zero; both equal to the fused ``ops.batched_nms`` over the 8 frames
    and to the CPU; the IoU kernel exact against its plain version."""
    imgs = torch.from_numpy(np.stack([f.image for f in frames[:8]])).to(DEV)
    b, s, _ = ssd_candidates(params, cfg, imgs, anchors)
    b, s = b.contiguous(), s.contiguous()
    kw = dict(iou_thr=NMS_KW["iou_thr"], max_out=NMS_KW["max_out"])
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    serial = [ops.nms_serial(b[f], s[f], **kw) for f in range(8)]
    single = [ops.nms(b[f], s[f], **kw) for f in range(8)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    print(f"[seed-nms] 8 frames A={b.shape[1]}: nms_serial + nms per frame "
          f"in {wall * 1e3:.2f} ms host wall; launches {launches}")
    check(launches["iou_matrix"] == 8 and launches["batched_nms"] == 8,
          f"seed NMS path: expected 8 IoU and 8 NMS launches: {launches}")
    check(all(n == 0 for k, n in launches.items()
              if k not in ("iou_matrix", "batched_nms")),
          f"seed NMS path launched other kernels: {launches}")
    kb, vb = ops.batched_nms(b, s, **kw)
    for f in range(8):
        kc, vc = ops.nms_serial(b[f].cpu(), s[f].cpu(), **kw)
        for name, (k, v) in (("nms_serial", serial[f]), ("nms", single[f])):
            check(torch.equal(k, kb[f]) and torch.equal(v, vb[f]),
                  f"{name} != batched_nms on frame {f}")
            check(torch.equal(k.cpu(), kc) and torch.equal(v.cpu(), vc),
                  f"{name} on cuda != nms_serial on cpu, frame {f}")
    print(f"[seed-nms] nms_serial == nms == batched_nms (no score_thr) == "
          f"cpu on all 8 frames; valid {[int(v.sum()) for _, v in serial]}")
    t_serial = cuda_ms(lambda: [ops.nms_serial(b[f], s[f], **kw)
                                for f in range(8)], iters=3, warmup=1)
    t_fused = cuda_ms(lambda: ops.batched_nms(b, s, **kw), iters=50,
                      warmup=5)
    print(f"[seed-nms] 8 frames: nms_serial {t_serial:.3f} ms, "
          f"batched_nms {t_fused:.4f} ms")

    rng = np.random.default_rng(SEED + 6)
    worst = 0.0
    for N, M in IOU_SIZES:
        if (N, M) == (160, 160):
            a, c = b[0], b[1]
        else:
            a = _t(random_boxes(rng, (N,)))
            c = _t(random_boxes(rng, (M,)))
        got = kiou.iou_matrix_cuda(a, c)
        want = kiou.iou_matrix_torch(a, c)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"[iou] {N}x{M}: equal={bool(torch.equal(got, want))} "
              f"max |err| {err}")
        check(torch.equal(got, want), f"iou_matrix kernel != plain {N}x{M}")
        worst = max(worst, err)
    a, c = b[0], b[1]
    out = torch.empty((160, 160), dtype=torch.float32, device=DEV)
    launch = build.function("iou", "iou_matrix_launch", kiou._LAUNCH_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    ms = cuda_ms(lambda: kiou.iou_matrix_cuda(a, c))
    kernel_ms = cuda_ms(lambda: launch(a.data_ptr(), c.data_ptr(), 160, 160,
                                       out.data_ptr(), stream))
    plain_ms = cuda_ms(lambda: kiou.iou_matrix_torch(a, c), iters=50,
                       warmup=5)
    bound, by = iou_bound_ms(160, 160)
    print(f"[iou] 160x160: wrapper {ms:.4f} ms (kernel alone "
          f"{kernel_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound:.2e} ms ({by}); library: none (no PyTorch call computes "
          f"pairwise IoU)")
    N = SSD300_ANCHORS
    big = _t(random_boxes(rng, (N,)))
    t_k = cuda_ms(lambda: kiou.iou_matrix_cuda(big, big), iters=20,
                  warmup=3)
    t_p = cuda_ms(lambda: kiou.iou_matrix_torch(big, big), iters=5,
                  warmup=1)
    print(f"[iou-sweep] {N}x{N}: wrapper {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"bound {iou_bound_ms(N, N)[0]:.4f} ms ({iou_bound_ms(N, N)[1]})")
    device_ms = device_ms_a_call("iou", [
        ("160x160", "::iou_kernel", lambda: kiou.iou_matrix_cuda(a, c)),
        (f"{N}x{N}", "::iou_kernel", lambda: kiou.iou_matrix_cuda(big, big))])
    entry = dict(
        name="iou_matrix", route="cuda",
        source="src/repro_torch/kernels/csrc/iou.cu",
        replaces="src/repro/kernels/iou.py:42",
        max_abs_err=worst, ms=ms, kernel_only_ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        shape="160x160 (one frame's candidates)",
        ssd300_ms=t_k, ssd300_plain_ms=t_p, device_ms=device_ms,
        ssd300_bound_ms=iou_bound_ms(N, N)[0])
    return launches, entry


# boxes with a NaN, +-inf or -0.0 coordinate (an overflowed box decode or
# Kalman prediction): the first three are a NaN box and two boxes whose
# IoU with it is NaN in the reference
NAN, INF = float("nan"), float("inf")
ODD_BOXES = np.float32([
    [NAN, 0, 10, 10], [1, 1, 9, 9], [0, 0, 10, 10], [-INF, 0, INF, 10],
    [INF, INF, INF, INF], [0, 0, INF, 10], [-0.0, -0.0, 0.0, 0.0],
    [-0.0, -0.0, 10, 10], [NAN, NAN, NAN, NAN], [0, -INF, 10, -INF],
    [5, 5, 5, NAN], [-INF, -INF, -INF, -INF]])


def same_nan(got, want):
    """Equal shapes and types, NaN at the same places and equal values
    elsewhere (a NaN's sign and payload aside; -0.0 == 0.0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if not got.is_floating_point():
        return torch.equal(got, want)
    gn, wn = torch.isnan(got), torch.isnan(want)
    return torch.equal(gn, wn) and torch.equal(got[~gn], want[~wn])


def odd_frames(rng, B, A, span=100.0):
    """(B, A, 4) random boxes with one box in six replaced by one of
    ``ODD_BOXES`` scaled to ``span``."""
    b = random_boxes(rng, (B, A), span=span, max_wh=0.3)
    pick = rng.uniform(size=(B, A)) < 1 / 6
    b[pick] = ODD_BOXES[rng.integers(0, len(ODD_BOXES), int(pick.sum()))] * (
        span / 10)
    return b


def phase_nan():
    """The three IoU kernels on boxes with NaN, +-inf and -0.0
    coordinates, held exactly (NaN-aware: ``same_nan``) to their plain
    versions, which carry NaN through every max and min as the reference
    does.  A frame whose live assignment cost holds a NaN commits no
    match; NMS does not suppress with a NaN IoU.  Every case is run and
    printed before the phase fails on any that differ."""
    differ = []
    rng = np.random.default_rng(SEED + 18)
    a = _t(np.concatenate([ODD_BOXES, random_boxes(rng, (25,), 10.0)]))
    c = _t(np.concatenate([random_boxes(rng, (17,), 10.0), ODD_BOXES]))
    for name, x, y in (("IoU example", a[:1], a[1:3]), ("37x29", a, c),
                       ("29x37", c, a), ("37x37", a, a)):
        got, want = kiou.iou_matrix_cuda(x, y), kiou.iou_matrix_torch(x, y)
        torch.cuda.synchronize()
        print(f"[nan] iou {name}: equal={same_nan(got, want)}, NaN "
              f"{int(want.isnan().sum())} of {want.numel()}"
              + (f", {got.tolist()}" if want.numel() < 4 else ""))
        if not same_nan(got, want):
            differ.append(f"iou {name}")
    check(bool(kiou.iou_matrix_torch(a[:1], a[1:3]).isnan().all()),
          "plain IoU of the NaN box is not NaN")

    ex = _t(np.float32([[NAN, 0, 10, 10], [0, 0, 10, 10], [1, 1, 10, 10],
                        [50, 50, 60, 60]])[None])
    exs = _t(np.float32([[0.9, 0.8, 0.7, 0.6]]))
    nms_in = [("example", ex, exs, dict(iou_thr=0.5, max_out=4))]
    ob = _t(odd_frames(rng, 4, 160, span=1.0))
    os_ = _t(rng.uniform(0, 1, (4, 160)).astype(np.float32))
    nms_in += [("A=160 odd boxes", ob, os_, NMS_KW),
               ("A=160 odd boxes no thr", ob, os_,
                dict(NMS_KW, score_thr=None, stop_at_zero=False,
                     max_out=160))]
    for name, b, s, kw in nms_in:
        kk, vk = knms.batched_nms_cuda(b, s, **kw)
        kp, vp = knms.batched_nms_torch(b, s, **kw)
        torch.cuda.synchronize()
        ok = torch.equal(kk, kp) and torch.equal(vk, vp)
        print(f"[nan] nms {name}: keep/valid equal={ok}, valid "
              f"{vp.sum(-1).tolist()}"
              + (f", keep {kk[0].tolist()}" if name == "example" else ""))
        if not ok:
            differ.append(f"nms {name}")
    check(knms.batched_nms_torch(ex, exs, iou_thr=0.5, max_out=4)[0][
        0, :3].tolist() == [0, 1, 3], "plain NMS example keep != [0, 1, 3]")

    # frame 0: the NaN box in a live pair; 1: in a masked track slot;
    # 2: tracks with an infinite side (IoU 0 against finite boxes); 3: a
    # -0.0 track box on a detection equal to it but for the zeros
    B, T, D = 4, 64, 32
    tb = random_boxes(rng, (B, T), span=100.0, max_wh=0.4)
    db = tb[:, rng.integers(0, T, D)] + rng.normal(0, 3, (B, D, 4)).astype(
        np.float32)
    tm = rng.uniform(size=(B, T)) < 0.8
    dm = rng.uniform(size=(B, D)) < 0.9
    tc = rng.integers(0, 2, (B, T)).astype(np.int32)
    dc = rng.integers(0, 2, (B, D)).astype(np.int32)
    tb[:2, 0] = ODD_BOXES[0]
    tm[0, 0], tm[1, 0], dm[0, 0], dc[0, 0] = True, False, True, tc[0, 0]
    tb[2, ::5] = ODD_BOXES[3] * 10
    tb[2, 1::5] = ODD_BOXES[5] * 10
    tb[3, :4], db[3, :4] = ODD_BOXES[7] * 10, ODD_BOXES[2] * 10
    tm[3, :4], dm[3, :4], dc[3, :4] = True, True, tc[3, :4]
    args = tuple(_t(x) for x in (tb, db, tm, dm, tc, dc))
    for thr in (-1.0, 0.0, ASSIGN_THR, 1.0):
        mk = kassoc.greedy_assign_cuda(*args, iou_thr=thr)
        mp = kassoc.greedy_assign_torch(*args, iou_thr=thr)
        torch.cuda.synchronize()
        ok = torch.equal(mk, mp)
        print(f"[nan] assign B=4 T=64 D=32 iou_thr={thr}: match equal={ok}, "
              f"matches a frame {(mp >= 0).sum(-1).tolist()}")
        if not ok:
            differ.append(f"assign iou_thr={thr}")
        check(not bool((mp[0] >= 0).any()),
              "plain assignment committed a match beside a live NaN")
    check(not differ, f"kernel != plain version on: {', '.join(differ)}")


def _randn(g, shape, dtype=torch.float32):
    return torch.randn(shape, generator=g, device=DEV).to(dtype)


def _sdpa_causal(T, S):
    from torch.nn.attention.bias import causal_lower_right
    return causal_lower_right(T, S)


def phase_attention(profile=False):
    """The attention and scan kernels at model widths (and small cases
    for the other template instances): every case through ``ops`` with
    the counters zeroed first, then each result against the plain
    version (``hold_to_plain``), then times at the model widths;
    ``profile`` adds ``torch.profiler``'s kernels for the timed
    flash and decode calls and their SDPA yardsticks."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 7)
    flash_in = [(c, tuple(_randn(g, (B, H, n, D), c[-1])
                          for n in (T, S, S)))
                for c in FLASH_CASES + FLASH_EDGE_CASES + FLASH_MARGIN_CASES
                + (FLASH_LARGE_LOGITS,)
                for B, H, T, S, D in [c[1:6]]]
    c, (q, k, v) = flash_in.pop()
    large = (c, (q * (LARGE_LOGIT / max_logit(q, k)), k, v))
    decode_in = [(c, (_randn(g, (B, H, D), c[-1]),
                      _randn(g, (B, S, KV, D), c[-1]),
                      _randn(g, (B, S, KV, D), c[-1])))
                 for c in DECODE_CASES + DECODE_EDGE_CASES
                 for B, H, KV, S, D in [c[1:6]]]
    rwkv_in = []
    for c in RWKV_CASES + RWKV_EDGE_CASES:
        _, B, H, T, hs, dt = c
        r, k, v = (_randn(g, (B, H, T, hs), dt) for _ in range(3))
        w = (torch.sigmoid(_randn(g, (B, H, T, hs))) * 0.5 + 0.45).to(dt)
        rwkv_in.append((c, (r, k, v, w, _randn(g, (H, hs)),
                            _randn(g, (B, H, hs, hs)) * 0.1)))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    flash_out = [ops.flash_attention(*x, causal=c[6]) for c, x in flash_in]
    large_out = ops.flash_attention(*large[1], causal=True)
    decode_out = [ops.decode_attention(*x) for _, x in decode_in]
    rwkv_out = [ops.rwkv_scan(*x) for _, x in rwkv_in]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    print(f"[attention] {len(flash_in)} flash, {len(decode_in)} decode, "
          f"{len(rwkv_in)} rwkv calls in {wall * 1e3:.1f} ms host wall; "
          f"launches {launches}")
    check(launches["flash_attention"] == len(flash_in) + 1
          and launches["decode_attention"] == len(decode_in)
          and launches["rwkv_scan"] == len(rwkv_in),
          f"attention path: one launch a call expected: {launches}")
    check(all(launches[k] == 0 for k in ("batched_nms", "greedy_assign",
                                         "crop_resize", "uncrop_boxes",
                                         "iou_matrix")),
          f"attention path launched other kernels: {launches}")

    worst = {"flash": 0.0, "decode": 0.0, "rwkv": 0.0}
    worst32 = dict(worst)
    err32_of = {}
    failed = []
    for tag, ins, outs, kernel, plain, tols in (
            ("flash", flash_in, flash_out, kflash.flash_attention_cuda,
             kflash.flash_attention_torch, (F32_TOL,)),
            ("decode", decode_in, decode_out,
             kdecode.decode_attention_cuda,
             kdecode.decode_attention_torch, (F32_TOL,)),
            ("rwkv", rwkv_in, rwkv_out, krwkv.rwkv_scan_cuda,
             krwkv.rwkv_scan_torch, (F32_TOL, 5 * F32_TOL))):
        for (c, x), got in zip(ins, outs):
            got = (got,) if torch.is_tensor(got) else got
            kw = dict(causal=c[6]) if tag == "flash" else {}
            check(got[0].dtype == x[0].dtype
                  and all(g.dtype == torch.float32 for g in got[1:])
                  and all(bool(torch.isfinite(g.float()).all())
                          for g in got), f"{tag} {c[0]}: dtype/finite")
            err32, err, ok = hold_to_plain(
                tag, c[0], got, x, lambda *a: kernel(*a, **kw),
                lambda *a: plain(*a, **kw), tols)
            worst[tag] = max(worst[tag], err)
            worst32[tag] = max(worst32[tag], err32)
            err32_of[c[0]] = err32
            if not ok:
                failed.append(f"{tag} {c[0]}")
    check(not failed, f"kernels != plain versions on {failed}")
    for c in FLASH_MARGIN_CASES:
        err = err32_of[c[0]]
        side = "within" if err <= 1e-5 else "above"
        print(f"[flash-margin] {c[0]}: float32 max |kernel - plain| "
              f"{err:.3e}, held to {F32_TOL} ({side} 1e-5)")
    measure_large_logits(*large, large_out)
    for c, _ in decode_in:
        _, B, H, KV, S, D, _ = c
        n, rows = kdecode.split_rows(B, KV, S, D)
        print(f"[decode] {c[0]}: {n} splits of {rows} rows, "
              f"{B * KV * -(-(H // KV) // 8) * n} CTAs")

    import torch.nn.functional as F
    stream = torch.cuda.current_stream().cuda_stream
    entries = {}
    for i, (c, x) in enumerate(flash_in[:len(FLASH_CASES)]):
        name, B, H, T, S, D, causal, dt = c
        q, k, v = x
        ms = cuda_ms(lambda: kflash.flash_attention_cuda(q, k, v,
                                                         causal=causal),
                     iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: kflash.flash_attention_torch(
            q, k, v, causal=causal), iters=5, warmup=1)
        mask = _sdpa_causal(T, S) if causal else None
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask)
        lib_err = _close(lib(), flash_out[i], F32_TOL)[0]
        lib_ms = cuda_ms(lib, iters=20, warmup=3)
        bound, by = flash_bound_ms(B, H, T, S, D, causal, dt)
        tflops = flash_flops(B, H, T, S, D, causal) / ms * 1e-9
        print(f"[flash] {name}: wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms,"
              f" SDPA {lib_ms:.4f} ms (|SDPA - kernel| {lib_err:.2e}), "
              f"bound {bound:.4f} ms ({by}); {tflops:.1f} TFLOP/s, "
              f"{bound / ms:.3f} of the bound; kernel / SDPA "
              f"{ms / lib_ms:.2f}")
        if i == 0:
            out = torch.empty_like(q)
            launch = build.function("flash_attention",
                                    "flash_attention_launch",
                                    kflash._LAUNCH_ARGS)
            kernel_ms = cuda_ms(lambda: launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), B, H, T, S, D,
                D ** -0.5, int(causal), kflash._DTYPES[dt], out.data_ptr(),
                stream), iters=20, warmup=3)
            check(torch.equal(out, flash_out[i]),
                  "flash kernel alone != the wrapper's result")
            print(f"[flash] {name}: kernel alone {kernel_ms:.4f} ms")
            entries["flash_attention"] = dict(
                name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:71",
                max_abs_err=worst["flash"],
                max_abs_err_f32=worst32["flash"], ms=ms,
                kernel_only_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by,
                library_ms=lib_ms, shape=name)
    for i, (c, x) in enumerate(decode_in[:len(DECODE_CASES)]):
        name, B, H, KV, S, D, dt = c
        q, k, v = x
        ms = cuda_ms(lambda: kdecode.decode_attention_cuda(q, k, v),
                     iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: kdecode.decode_attention_torch(q, k, v),
                           iters=10, warmup=2)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)    # (B, KV, S, D)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], kt, vt, enable_gqa=True)[:, :, 0]
        lib_err = _close(lib(), decode_out[i], F32_TOL)[0]
        lib_ms = cuda_ms(lib, iters=20, warmup=3)
        bound, by = decode_bound_ms(B, H, KV, S, D, dt)
        gbs = decode_bytes(B, H, KV, S, D, dt) / ms * 1e-6
        print(f"[decode] {name}: wrapper {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, SDPA(enable_gqa) {lib_ms:.4f} ms (|SDPA - kernel| "
              f"{lib_err:.2e}), bound {bound:.4f} ms ({by}); {gbs:.0f} GB/s,"
              f" {bound / ms:.3f} of the bound; kernel / SDPA "
              f"{ms / lib_ms:.2f}")
        if i == 0:
            out = torch.empty_like(q)
            launch = build.function("decode_attention",
                                    "decode_attention_launch",
                                    kdecode._LAUNCH_ARGS)
            n_split, rows = kdecode.split_rows(B, KV, S, D)
            part = torch.empty(B * H * n_split * (D + 2), device=DEV)
            # the kernel leaves its tickets at zero again
            tickets = torch.zeros(B * H, dtype=torch.int32, device=DEV)
            kernel_ms = cuda_ms(lambda: launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), B, H, KV, S, D,
                D ** -0.5, kdecode._DTYPES[dt], rows, n_split,
                part.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                stream), iters=20, warmup=3)
            check(torch.equal(out, decode_out[i]),
                  "decode kernel alone != the wrapper's result")
            print(f"[decode] {name}: kernel alone {kernel_ms:.4f} ms")
            entries["decode_attention"] = dict(
                name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:54",
                max_abs_err=worst["decode"],
                max_abs_err_f32=worst32["decode"], ms=ms,
                kernel_only_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms, shape=name)
    if profile:
        calls = []
        for c, (q, k, v) in flash_in[:2]:
            T, S = c[3], c[4]
            calls += [(c[0], lambda q=q, k=k, v=v: ops.flash_attention(
                q, k, v)), (f"SDPA {c[0]}",
                           lambda q=q, k=k, v=v, T=T, S=S:
                           F.scaled_dot_product_attention(
                               q, k, v, attn_mask=_sdpa_causal(T, S)))]
        q, k, v = decode_in[0][1]
        calls += [(decode_in[0][0][0], lambda: ops.decode_attention(q, k, v)),
                  (f"SDPA {decode_in[0][0][0]}",
                   lambda: F.scaled_dot_product_attention(
                       q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                       enable_gqa=True))]
        profile_calls("attention", calls)
    for i, (c, x) in enumerate(rwkv_in[:len(RWKV_CASES)]):
        name, B, H, T, hs, dt = c
        ms = cuda_ms(lambda: krwkv.rwkv_scan_cuda(*x), iters=20, warmup=3)
        plain_ms = cuda_ms(lambda: krwkv.rwkv_scan_torch(*x), iters=2,
                           warmup=1)
        bound, by = rwkv_bound_ms(B, H, T, hs, dt)
        print(f"[rwkv] {name}: wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms,"
              f" bound {bound:.4f} ms ({by}), {bound / ms:.3f} of the bound;"
              f" {7 * B * H * T * hs * hs / ms * 1e-9:.1f} TFLOP/s; split "
              f"{krwkv.scan_split(hs)} (columns a CTA, rows a thread); "
              f"library: none (no PyTorch call computes the RWKV-6 "
              f"recurrence)")
        if i == 0:
            r, k, v, w, u, s0 = x
            out = torch.empty_like(r)
            sf = torch.empty_like(s0)
            launch = build.function("rwkv_scan", "rwkv_scan_launch",
                                    krwkv._LAUNCH_ARGS)
            kernel_ms = cuda_ms(lambda: launch(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), B, H, T, hs,
                *krwkv.scan_split(hs), krwkv._DTYPES[dt], out.data_ptr(),
                sf.data_ptr(), stream), iters=20, warmup=3)
            check(torch.equal(out, rwkv_out[i][0])
                  and torch.equal(sf, rwkv_out[i][1]),
                  "rwkv kernel alone != the wrapper's result")
            print(f"[rwkv] {name}: kernel alone {kernel_ms:.4f} ms")
            entries["rwkv_scan"] = dict(
                name="rwkv_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/rwkv_scan.cu",
                replaces="src/repro/kernels/rwkv_scan.py:57",
                max_abs_err=worst["rwkv"],
                max_abs_err_f32=worst32["rwkv"], ms=ms,
                kernel_only_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by,
                library_ms=None, shape=name)
    check_width_limits()
    return launches, entries


def moe_slots(g, E, C, d, touched):
    """A decode's dispatch slots: each expert of ``touched`` holds a token
    in its first slot (combine weight 0.5), every other slot is empty
    and its row zero.  Returns (x (E, C, d) bf16, slot_w (E * C,))."""
    slot_w = torch.zeros(E * C, device=DEV)
    for e in touched:
        slot_w[e * C] = 0.5
    x = _randn(g, (E, C, d), torch.bfloat16)
    return x * (slot_w.reshape(E, C, 1) > 0).to(x.dtype), slot_w


def moe_bound_ms(n_touched, d, f):
    """The least time of a call: the touched experts' three matrices
    read once at 3.35 TB/s (the slots' rows are a few KB)."""
    return n_touched * 3 * d * f * 2 / HBM_BYTES_PER_S * 1e3


def phase_moe_experts():
    """``[moe-experts]``: the routed-experts kernel (table row 9) at
    ``MOE_CASES``' decode shapes with 0, 1 and 2 touched experts
    (``MOE_TOUCHED``): within ``MOE_RTOL`` + ``MOE_ATOL_SHARE`` of the
    plain version, zero on every empty slot, two calls bit-equal and
    counted as two launches each from zero; then the wrapper and the
    kernel alone (its two launches over fixed scratch: the device's
    time) by CUDA events over 200 calls after 20 warm-ups, beside the
    bound (the touched experts' bytes at 3.35 TB/s), the plain version
    and the library yardstick (its three ``torch.bmm`` products alone,
    which read every expert); then the launches inside a served decode
    (``moe_served_launches``).  Returns those launches and the table's
    entry (grok-1, two touched experts)."""
    g = torch.Generator(device=DEV).manual_seed(SEED + 9)
    launch = build.function("routed_experts", "routed_experts_launch",
                            krouted._LAUNCH_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entry = None
    for name, E, C, d, f in MOE_CASES:
        free_cuda()
        stacks = tuple(_randn(g, shape).mul_(shape[1] ** -0.5)
                       .to(torch.bfloat16)
                       for shape in ((E, d, f), (E, d, f), (E, f, d)))
        for touched in MOE_TOUCHED:
            x, slot_w = moe_slots(g, E, C, d, touched)
            args = (x, slot_w, *stacks)
            torch.cuda.synchronize()
            ops.reset_launches()
            got = ops.routed_expert_ffn(*args)
            again = ops.routed_expert_ffn(*args)
            torch.cuda.synchronize()
            launches = ops.launches()
            check(launches == dict({k: 0 for k in launches},
                                   routed_experts=4),
                  f"[moe-experts] {name}: launches {launches} for two "
                  "calls; not two a call")
            want = krouted.routed_expert_ffn_torch(*args).float()
            diff = (got.float() - want).abs()
            top = float(want.abs().max())
            ok = bool((diff <= MOE_RTOL * want.abs()
                       + MOE_ATOL_SHARE * top).all())
            empty = slot_w.reshape(E, C) <= 0
            err = float(diff.max())
            print(f"[moe-experts] {name}, touched {list(touched)}: max "
                  f"|kernel - plain| {err:.4e} (max |plain| {top:.4e}; "
                  f"within {MOE_RTOL:.4g} x |plain| + {MOE_ATOL_SHARE:.4g} "
                  f"x max: {ok}); empty slots zero: "
                  f"{not got[empty].any()}; two calls bit-equal: "
                  f"{torch.equal(got, again)}")
            check(ok and not got[empty].any() and torch.equal(got, again),
                  f"[moe-experts] {name}, touched {list(touched)}: kernel "
                  "!= plain version")
            ms = cuda_ms(lambda: krouted.routed_expert_ffn_cuda(*args))
            tw = krouted.tile_cols(torch.bfloat16)
            grid = krouted.BLOCKS_PER_SM * sms
            part = torch.empty(grid * 4 * C * tw, device=DEV)
            n_tk = E * (-(-f // tw) + -(-d // tw))
            tickets = torch.zeros(n_tk, dtype=torch.int32, device=DEV)
            h = torch.empty((E, C, f), dtype=torch.bfloat16, device=DEV)
            y = torch.empty((E, C, d), dtype=torch.bfloat16, device=DEV)
            ptrs = [t.data_ptr() for t in args]
            # the tickets zeroed before each call, as the wrapper does
            kernel_ms = cuda_ms(lambda: (tickets.zero_(), build.check(launch(
                *ptrs, E, C, d, f, 1, grid, part.data_ptr(), part.numel(),
                tickets.data_ptr(), n_tk, h.data_ptr(), y.data_ptr(),
                stream), "routed_experts_launch")))
            check(torch.equal(y, got),
                  "[moe-experts] kernel alone != the wrapper's result")
            plain_ms = cuda_ms(lambda: krouted.routed_expert_ffn_torch(
                *args), iters=50, warmup=5)
            lib_ms = cuda_ms(lambda: (torch.bmm(x, stacks[0]),
                                      torch.bmm(x, stacks[1]),
                                      torch.bmm(h, stacks[2])),
                             iters=50, warmup=5)
            bound = moe_bound_ms(len(touched), d, f)
            share = (f"{bound / kernel_ms:.3f} of the bound, "
                     f"{len(touched) * 6 * d * f / kernel_ms * 1e-6:.0f} "
                     "GB/s" if touched else "nothing to read")
            print(f"[moe-experts] {name}, touched {list(touched)}: wrapper "
                  f"{ms:.4f} ms, kernel alone {kernel_ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, torch.bmm x3 {lib_ms:.4f} ms, bound "
                  f"{bound:.4f} ms (bytes); kernel {share}; grid {grid}, "
                  f"tile {tw} columns")
            if len(touched) == 2 and entry is None:
                entry = dict(
                    name="routed_experts", route="cuda",
                    source="src/repro_torch/kernels/csrc/routed_experts.cu",
                    replaces=None, max_abs_err=err, ms=ms,
                    kernel_only_ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by="bytes", library_ms=lib_ms,
                    shape=f"{name}, 2 touched")
        del stacks, args, x, slot_w, got, again, want, diff, h, y, part
    free_cuda()
    return moe_served_launches(), entry


def moe_served_launches():
    """The kernel's launches inside a served decode: grok-1's smoke
    preset in bf16 through ``ServingEngine`` on the card (one replica;
    the warm-up captures the decode graphs), 2 requests of
    ``LLM_PROMPT`` tokens and ``LLM_NEW`` new ones, counted from zero
    over the serve: two a call at each MoE layer in every decode step,
    the graphs' replays counted by ``MoEGraph``, and none in a prefill
    (C = capacity(``LLM_PROMPT``) = 12 takes ``torch.bmm``); the tokens
    equal to the eager decode's (``eager_serve``)."""
    cfg = get_config("grok-1-314b", preset="smoke").replace(
        dtype="bfloat16", param_dtype="bfloat16")
    check(llm_moe.capacity(LLM_PROMPT, cfg.moe) > krouted.MAX_SLOTS,
          "[moe-experts] the served prefill is decode-shaped")
    params = init_model(cfg, torch.Generator(device=DEV).manual_seed(SEED),
                        device=DEV)
    rng = np.random.default_rng(SEED)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size - 1, LLM_PROMPT)
                    .astype(np.int32), LLM_NEW, 0.0) for i in range(2)]
    eng = ServingEngine(cfg, params=params, n_replicas=1,
                        cache_len=LLM_CACHE_LEN, device=DEV)
    eng.warmup(LLM_PROMPT)
    torch.cuda.synchronize()
    ops.reset_launches()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    launches = ops.launches()
    n_moe = sum(spec.ffn == "moe" for spec in cfg.layer_specs())
    want = 2 * n_moe * len(reqs) * LLM_NEW
    eager = eager_serve(cfg, params, reqs)
    same = all(eager[r.rid] == r.tokens.tolist() for r in out["responses"])
    print(f"[moe-experts] served decode (grok-1 smoke, bf16, {n_moe} MoE "
          f"layers, {len(reqs)} requests of {LLM_PROMPT} + {LLM_NEW} "
          f"tokens): launches {launches}, {want} expected (2 a call, "
          f"{LLM_NEW} decode steps a request, none in a prefill); tokens "
          f"equal to the eager decode's: {same}")
    check(launches == dict({k: 0 for k in launches}, routed_experts=want)
          and same, f"[moe-experts] served decode: launches {launches}, "
          f"tokens equal {same}")
    return launches


def mla_inputs(g, B, H, R, P, N, V, L):
    """bf16 inputs of the absorbed decode: q_nope as the layer slices it
    (a view of q), q_pe, the ring, and W_kb, W_vb of N(0, 1/r) entries."""
    q = _randn(g, (B, 1, H, N + P), torch.bfloat16)
    return (q[..., :N], q[..., N:].contiguous(),
            _randn(g, (B, L, R), torch.bfloat16),
            _randn(g, (B, L, P), torch.bfloat16),
            _randn(g, (R, H * N)).mul_(R ** -0.5).to(torch.bfloat16)
            .reshape(R, H, N),
            _randn(g, (R, H * V)).mul_(R ** -0.5).to(torch.bfloat16)
            .reshape(R, H, V))


def mla_bound_ms(n, B, H, R, P, N, V):
    """The least time of a call with n filled slots: the larger of its
    bytes (W_kb and W_vb, the filled slots, the query and the output, each
    read or written once, bf16) at 3.35 TB/s and its operations as the
    kernel runs them: the scores' 2 H n (r + rope) and the context's 2 H n
    r, the latter three times (P's three bf16 pieces), at the bf16
    tensor-core rate (989 TFLOP/s), then the absorb's and the combine's 2
    H r (nope + v) float32 multiply-adds at 67 TFLOP/s.  Returns (ms, what
    bounds it)."""
    nbytes = 2 * (R * H * (N + V) + B * n * (R + P) + B * H * (N + P + V))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (2 * B * H * n * (R + P + 3 * R) / BF16_OPS_PER_S
             + 2 * B * H * R * (N + V) / FP32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def replay_ms(fn, before=None, iters=200):
    """Device ms a call of ``fn``: captured in a CUDA graph (after
    ``before``, whose own graph's time is then taken off) and replayed,
    CUDA events over ``iters`` replays after 5.  No host time enters."""
    def graph(body):
        body()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            body()
        return g

    def timed(g):
        for _ in range(5):
            g.replay()
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(iters):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    both = timed(graph(lambda: (before and before(), fn())))
    return both - (timed(graph(before)) if before else 0.0)


def phase_mla_decode():
    """``[mla-decode]``: the MLA decode kernel (table row 10) at
    ``MLA_SHAPE`` with ``MLA_FILLED`` slots filled: within ``MLA_RTOL`` +
    ``MLA_ATOL_SHARE`` of the plain version, two calls bit-equal and
    counted as three launches each from zero, NaN in every slot outside
    the mask changing nothing; then the wrapper (eager, its host time
    included: CUDA events over 200 calls after 20 warm-ups), the kernel
    alone over fixed scratch and the plain version, both replayed from
    CUDA graphs, the kernel with the weights in L2 (warm) and after
    ``L2_FLUSH_BYTES`` written before each call (cold, as a decode step
    finds them), beside the least time (``mla_bound_ms``); then the
    launches inside a served decode (``mla_served_launches``).  Returns
    those launches and the table's entry (2,350 filled, cold)."""
    sh = MLA_SHAPE
    g = torch.Generator(device=DEV).manual_seed(SEED + 11)
    args = mla_inputs(g, **sh)
    launch = build.function("mla_decode", "mla_decode_launch",
                            kmla._LAUNCH_ARGS)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEV)
    B, H, R, P, N, V, L = (sh[k] for k in "BHRPNVL")
    entry = None
    for n in MLA_FILLED:
        free_cuda()
        pos = torch.tensor(n - 1, device=DEV)
        torch.cuda.synchronize()
        ops.reset_launches()
        got = ops.mla_decode(*args, pos, scale=MLA_SCALE)
        again = ops.mla_decode(*args, pos, scale=MLA_SCALE)
        torch.cuda.synchronize()
        launches = ops.launches()
        check(launches == dict({k: 0 for k in launches}, mla_decode=6),
              f"[mla-decode] {n} filled: launches {launches} for two calls;"
              " not three a call")
        want = kmla.mla_decode_torch(*args, pos, scale=MLA_SCALE).float()
        diff = (got.float() - want).abs()
        top = float(want.abs().max())
        ok = bool((diff <= MLA_RTOL * want.abs() + MLA_ATOL_SHARE * top)
                  .all())
        err = float(diff.max())
        nan_same = True
        if n < L:
            dirty = list(args)
            for t in (2, 3):
                dirty[t] = args[t].clone()
                dirty[t][:, n:] = float("nan")
            nan_same = torch.equal(
                ops.mla_decode(*dirty, pos, scale=MLA_SCALE), got)
            del dirty
        print(f"[mla-decode] H={H} r={R} rope={P} L={L}, {n} filled: max "
              f"|kernel - plain| {err:.4e} (max |plain| {top:.4e}; within "
              f"{MLA_RTOL:.4g} x |plain| + {MLA_ATOL_SHARE:.4g} x max: {ok})"
              f"; two calls bit-equal: {torch.equal(got, again)}; NaN in "
              f"the {L - n} slots outside the mask changes nothing: "
              f"{nan_same}")
        check(ok and torch.equal(got, again) and nan_same,
              f"[mla-decode] {n} filled: kernel != plain version")
        ms = cuda_ms(lambda: kmla.mla_decode_cuda(*args, pos,
                                                  scale=MLA_SCALE))
        (clusters, sms), = [v for k, v in kmla._FITS.items()
                            if k[1:] == (R, P, 8)]
        S, cs = kmla.splits(B, H, L, clusters, 8), 8
        q_abs = torch.empty((B, R, H), dtype=torch.bfloat16, device=DEV)
        part = torch.empty(B * H * S * R, device=DEV)
        part_ml = torch.empty(B * H * S * 2, device=DEV)
        out = torch.empty((B, 1, H, V), dtype=torch.bfloat16, device=DEV)
        qn, qp, ckv, kpe, wk, wv = args

        def kernel():
            build.check(launch(
                qn.data_ptr(), qp.data_ptr(), ckv.data_ptr(), kpe.data_ptr(),
                wk.data_ptr(), wv.data_ptr(), pos.data_ptr(), qn.stride(0),
                qn.stride(2), qp.stride(0), qp.stride(2), 0, B, H, N, R, P,
                V, L, S, 0, sms, cs, MLA_SCALE, q_abs.data_ptr(),
                part.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "mla_decode_launch")

        warm_ms = replay_ms(kernel)
        cold_ms = replay_ms(kernel, before=flush.zero_)
        check(torch.equal(out, got),
              "[mla-decode] kernel alone != the wrapper's result")
        plain_ms = replay_ms(lambda: kmla.mla_decode_torch(
            *args, pos, scale=MLA_SCALE), iters=50)
        bound, by = mla_bound_ms(n, B, H, R, P, N, V)
        print(f"[mla-decode] {n} filled: wrapper {ms:.4f} ms (eager), "
              f"kernel alone {cold_ms:.4f} ms cold ({L2_FLUSH_BYTES >> 20} "
              f"MB written before each) and {warm_ms:.4f} ms warm (weights "
              f"in L2), plain {plain_ms:.4f} ms (replayed, every slot), "
              f"bound {bound:.4f} ms ({by}): kernel cold {cold_ms / bound:.2f}"
              f"x the bound, warm {warm_ms / bound:.2f}x; splits {S} in "
              f"clusters of {cs} ({clusters} fit at once), {sms} SMs")
        if n == 2350:
            entry = dict(
                name="mla_decode", route="cuda",
                source="src/repro_torch/kernels/csrc/mla_decode.cu",
                replaces=None, max_abs_err=err, ms=ms,
                kernel_only_ms=cold_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None,
                shape=f"H={H} r={R} rope={P} L={L}, {n} filled, bf16, cold")
        del got, again, want, diff, q_abs, part, part_ml, out
    del args, flush
    free_cuda()
    return mla_served_launches(), entry


def mla_served_launches():
    """The kernel's launches inside a served decode: DeepSeek-V3's smoke
    preset in bf16 through ``ServingEngine`` on the card (one replica;
    the warm-up captures the decode graphs), 2 requests of ``LLM_PROMPT``
    tokens and ``LLM_NEW`` new ones, counted from zero over the serve:
    three a call at each MLA layer of every decode step (the graphs'
    replays counted by ``ops.CountedGraph``), none in a prefill; the
    tokens equal to the eager decode's (``eager_serve``)."""
    cfg = get_config("deepseek-v3-671b", preset="smoke").replace(
        dtype="bfloat16", param_dtype="bfloat16")
    params = init_model(cfg, torch.Generator(device=DEV).manual_seed(SEED),
                        device=DEV)
    rng = np.random.default_rng(SEED)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size - 1, LLM_PROMPT)
                    .astype(np.int32), LLM_NEW, 0.0) for i in range(2)]
    eng = ServingEngine(cfg, params=params, n_replicas=1,
                        cache_len=LLM_CACHE_LEN, device=DEV)
    eng.warmup(LLM_PROMPT)
    torch.cuda.synchronize()
    ops.reset_launches()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    launches = ops.launches()
    layers = len(cfg.layer_specs())
    want = 3 * layers * len(reqs) * LLM_NEW
    eager = eager_serve(cfg, params, reqs)
    same = all(eager[r.rid] == r.tokens.tolist() for r in out["responses"])
    print(f"[mla-decode] served decode (deepseek-v3 smoke, bf16, {layers} "
          f"MLA layers, {len(reqs)} requests of {LLM_PROMPT} + {LLM_NEW} "
          f"tokens): launches {launches}, mla_decode {want} expected (3 a "
          f"call, {LLM_NEW} decode steps a request, none in a prefill); "
          f"tokens equal to the eager decode's: {same}")
    check(launches["mla_decode"] == want and same,
          f"[mla-decode] served decode: launches {launches}, tokens equal "
          f"{same}")
    return launches


def flash_f64(q, k, v):
    """Causal attention in float64, a head at a time: the function with
    no float32 rounding, to measure both float32 versions against."""
    T, S, D = q.shape[2], k.shape[2], q.shape[3]
    seen = (torch.arange(S, device=q.device)[None, :] <=
            torch.arange(T, device=q.device)[:, None] + (S - T))
    out = []
    for h in range(q.shape[1]):
        s = torch.einsum("btd,bsd->bts", q[:, h].double(),
                         k[:, h].double()) * D ** -0.5
        p = torch.softmax(torch.where(seen, s, -1e300), -1)
        out.append(torch.einsum("bts,bsd->btd", p, v[:, h].double()))
    return torch.stack(out, 1)


def measure_large_logits(c, x, got):
    """Flash float32 at logits up to ``LARGE_LOGIT``: the kernel against
    the plain version, and both against float64.  Printed, not held to
    2e-5: near 60 a logit's float32 ulp is 3.8e-6 and its sum's
    rounding, in either version, moves the result by more than that
    (PERF.md, PR 16); both must stay finite and of the right shape."""
    check(got.shape == x[0].shape and bool(torch.isfinite(got).all()),
          f"flash {c[0]}: shape/finite")
    plain = kflash.flash_attention_torch(*x, causal=True)
    exact = flash_f64(*x)
    def err(a, b):
        return float((a.double() - b.double()).abs().max())
    print(f"[flash-margin] {c[0]}, max |q.k.scale| {max_logit(*x[:2]):.2f}: "
          f"max |kernel - plain| {err(got, plain):.3e}, |kernel - float64| "
          f"{err(got, exact):.3e}, |plain - float64| {err(plain, exact):.3e}"
          f" (measured, not held to {F32_TOL})")


def max_logit(q, k):
    """max |q.k.scale| over the causal pairs of one flash case."""
    T, S, D = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhtd,bhsd->bhts", q, k) * D ** -0.5
    seen = (torch.arange(S, device=q.device)[None, :] <=
            torch.arange(T, device=q.device)[:, None] + (S - T))
    return float(torch.where(seen, s, 0.0).abs().max())


def check_width_limits():
    """Each CUDA wrapper refuses the first width past its limit with a
    ValueError, before any launch (the counters do not move): the
    kernels have no caller at those widths, and the port does not fall
    back to a plain version on the card."""
    z = lambda *shape: torch.zeros(shape, device=DEV)  # noqa: E731
    D, Dd, hs = kflash.MAX_D + 1, kdecode.MAX_D + 1, krwkv.MAX_HS + 1
    x, q, kv, seq = z(1, 1, 128, D), z(1, 1, Dd), z(1, 512, 1, Dd), z(
        1, 1, 16, hs)
    for what, call in (
            (f"flash_attention_cuda at D={D}",
             lambda: kflash.flash_attention_cuda(x, x, x)),
            (f"decode_attention_cuda at D={Dd}",
             lambda: kdecode.decode_attention_cuda(q, kv, kv)),
            (f"rwkv_scan_cuda at hs={hs}",
             lambda: krwkv.rwkv_scan_cuda(seq, seq, seq, seq, z(1, hs),
                                          z(1, 1, hs, hs)))):
        before = ops.launches()
        try:
            call()
            raised = None
        except ValueError as e:
            raised = e
        check(raised is not None and ops.launches() == before,
              f"{what}: no ValueError before launching")
        print(f"[limits] {what}: ValueError before any launch: {raised}")


# ------------------------------------------------------------- daemon
def _daemon_engine(params, cfg, device, recorder):
    return sharded_engine(params, cfg, device, n_shards=2, rebalance=True,
                          epoch_s=SHARD_EPOCH_S, supervisor=Watchdog(),
                          recorder=recorder)


def segment_cameras(events):
    """The camera count B of every (epoch window, shard) segment the
    trace served: the distinct streams of its ``arrive`` events.  A
    segment's tracker is B rows wide, so these are the B a fused tick
    graph can be captured at."""
    seen, epoch = {}, 0
    for e in sorted(events, key=lambda e: e["i"]):
        if e["kind"] == "epoch":
            epoch = e["epoch"]
        elif e["kind"] == "arrive":
            seen.setdefault((epoch, e.get("shard", 0)),
                            set()).add(e["stream"])
    return sorted({len(s) for s in seen.values()})


def daemon_run(params, cfg, device, frames, chunk, clock, tmp):
    """One ``ServingDaemon`` run of the rebalancing, fused-tick sharded
    engine behind an ``EventBus`` with a ``JsonlSink``.  Returns (report,
    recorder, bus counts, JSONL lines, launches, graphs, host wall)."""
    bus = EventBus()
    path = tmp / f"events-{device}-{chunk}-{clock.__name__}.jsonl"
    rec = bus.recorder()
    eng = _daemon_engine(params, cfg, device, rec)
    eng.warmup()
    tpipe.clear_tick_graphs()
    # the clock starts after the warm-up: a WallClock paces from here
    daemon = ServingDaemon(ServingRuntime(eng, streams=range(SHARD_CAMS)),
                           clock=clock(), chunk=chunk)
    with JsonlSink(str(path)) as sink:
        bus.subscribe(sink)
        ops.reset_launches()
        t0 = time.perf_counter()
        rep = daemon.run(frames)
        if device == DEV:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launches()
    graphs = [g for g in tpipe.tick_graphs()
              if g.device.type == torch.device(device).type]
    check(daemon.frames_ingested == len(frames) and
          daemon.runtime.frames_pending == 0,
          f"daemon chunk {chunk}: {daemon.frames_ingested} ingested, "
          f"{daemon.runtime.frames_pending} pending")
    lines = path.read_text().splitlines()
    return rep, rec, dict(bus.counts), lines, launches, graphs, wall


def run_main_quietly(main, argv):
    """``main(argv)`` of a launcher with its standard output captured;
    returns the output.  A launcher whose audit fails exits non-zero."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def phase_daemon(params, cfg):
    """The always-on daemon on the card: ``ServingDaemon`` over the
    rebalancing, fused-tick sharded engine (the trained mini-SSD, 8
    cameras on the skewed trace, 2 shards, ``Watchdog()``), the bus and a
    JSONL sink, on the ``VirtualClock`` at chunks 1 and 4: each report
    identical to one batch ``serve`` on the card and close to the same
    daemon on ``cpu``, bus counts and JSONL lines equal to the CPU run's,
    the audit clean and equal through the Chrome export, NMS and
    assignment launches counted, the tick graphs within their bound; one
    ``WallClock`` run equal to the virtual one; then the two launchers'
    ``main`` on the card with their traces checked by
    ``tools/check_trace_torch.py``.  Returns the launches summed over the
    card's runs."""
    total = {k: 0 for k in ops.launches()}
    frames, *_ = nvr_frames(SHARD_CAMS, SHARD_FRAMES, RATE_FPS,
                            make=make_skewed_streams, n_shards=2)
    cpu_params = params_to(params, "cpu")
    batch = _daemon_engine(params, cfg, DEV, None).serve(frames)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="daemon-", dir=ROOT / "build"))
    virtual = None
    try:
        for chunk in DAEMON_CHUNKS:
            rep, rec, counts, lines, launches, graphs, wall = daemon_run(
                params, cfg, DEV, frames, chunk, VirtualClock, tmp)
            for k, v in launches.items():
                total[k] += v
            close_report(rep, batch, f"daemon chunk {chunk} vs batch "
                         "serve", 0.0)
            crep, _, ccounts, clines, *_ = daemon_run(
                cpu_params, cfg, "cpu", frames, chunk, VirtualClock, tmp)
            close_report(rep, crep, f"daemon chunk {chunk} cuda vs cpu",
                         FORWARD_ATOL)
            check(counts == ccounts, f"daemon chunk {chunk}: bus counts "
                  f"{counts} != cpu {ccounts}")
            check(len(lines) == len(clines) == len(rec.events)
                  == sum(counts.values()),
                  f"daemon chunk {chunk}: JSONL lines {len(lines)} / cpu "
                  f"{len(clines)} / events {len(rec.events)}")
            res = audit_recorder(rec)
            check(res.ok, f"daemon chunk {chunk}: audit "
                  f"{res.violations[:3]}")
            trace = tmp / f"daemon-{chunk}.json"
            write_chrome_trace(str(trace), rec)
            back = events_from_chrome(json.loads(trace.read_text()))
            check(audit_events(back).stats == res.stats,
                  f"daemon chunk {chunk}: Chrome export audits otherwise")
            n_mb = sum(1 for e in rec.events
                       if e["kind"] == "stage" and e["stage"] == "detect")
            want = sum((1 + g.replays) * g.captured.get("greedy_assign", 0)
                       for g in graphs)
            check(launches["batched_nms"] == n_mb > 0,
                  f"daemon chunk {chunk}: NMS launches "
                  f"{launches['batched_nms']} != micro-batches {n_mb}")
            check(launches["greedy_assign"] == want > 0,
                  f"daemon chunk {chunk}: assignment launches "
                  f"{launches['greedy_assign']} != warm-ups + replays x "
                  f"captured ({want})")
            check(sum(g.replays for g in graphs) == rep["tracker_launches"],
                  f"daemon chunk {chunk}: graph replays != tracker ticks")
            bs = segment_cameras(rec.events)
            shapes = sorted(g.shape for g in graphs)
            check(len(graphs) <= len(bs)
                  and all(s[1] in bs for s in shapes),
                  f"daemon chunk {chunk}: {len(graphs)} tick graphs "
                  f"{shapes} for segment camera counts {bs}")
            print(f"[daemon] chunk {chunk}: {len(frames)} frames, "
                  f"coverage {rep['coverage']}, migrations "
                  f"{rep['migrations']}, bus {counts}, {len(lines)} JSONL "
                  f"lines (== cpu), audit ok {res.stats}, Chrome export "
                  f"audits the same; micro-batches {n_mb}, launches "
                  f"{launches}; tick graphs {len(graphs)} (K, B, D) = "
                  f"{shapes} for segment camera counts {bs}; host wall "
                  f"{wall * 1e3:.2f} ms; == batch serve exactly, == cpu "
                  f"within {FORWARD_ATOL}")
            virtual = rep
        rep, rec, counts, lines, launches, graphs, wall = daemon_run(
            params, cfg, DEV, frames, DAEMON_CHUNKS[-1], WallClock, tmp)
        for k, v in launches.items():
            total[k] += v
        close_report(rep, virtual, "daemon WallClock vs VirtualClock", 0.0)
        span = frames[-1].t_arrival - frames[0].t_arrival
        check(wall >= span, f"WallClock run took {wall} s < trace span "
              f"{span} s")
        print(f"[daemon] WallClock, chunk {DAEMON_CHUNKS[-1]}: report == "
              f"the VirtualClock run's; wall {wall:.3f} s for a trace "
              f"spanning {span:.3f} s")
        ops.reset_launches()
        events = tmp / "cli.jsonl"
        out = run_main_quietly(launch_daemon.main, [
            "--cameras", str(SHARD_CAMS), "--frames", str(SHARD_FRAMES),
            "--shards", "2", "--watchdog", "--chunk", "4",
            "--device", DEV, "--events", str(events)])
        cli = ops.launches()
        check("audit=ok" in out and "pending=0" in out,
              f"launch.daemon: {out}")
        check(cli["greedy_assign"] > 0, f"launch.daemon launched {cli}")
        print("[daemon] launch.daemon --device cuda: " +
              " | ".join(out.strip().splitlines()) + f"; launches {cli}")
        trace = tmp / "serve.json"
        ops.reset_launches()
        out = run_main_quietly(launch_serve.main, [
            "--payload", "frames", "--spmd", "--shards", "1",
            "--cameras", "4", "--frames", "8", "--device", DEV,
            "--trace", str(trace)])
        srv = ops.launches()
        check("spmd=True" in out and "audit=ok" in out,
              f"launch.serve: {out}")
        check(srv["batched_nms"] > 0 and srv["greedy_assign"] > 0,
              f"launch.serve --spmd launched {srv}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = load_tool("check_trace_torch").main([str(trace)])
        check(rc == 0, f"check_trace_torch: {buf.getvalue()}")
        print("[daemon] launch.serve --payload frames --spmd --device cuda: "
              + " | ".join(out.strip().splitlines()) + f"; launches {srv}; "
              f"check_trace_torch: {buf.getvalue().strip()}")
        for launches in (cli, srv):
            for k, v in launches.items():
                total[k] += v
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[daemon] launches over the card's runs: {total}")
    return total


def load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- llm
def _leaves(p):
    if isinstance(p, dict):
        for v in p.values():
            yield from _leaves(v)
    elif isinstance(p, (list, tuple)):
        for v in p:
            yield from _leaves(v)
    else:
        yield p


def top2_margin(logits):
    top = torch.topk(logits.float(), 2, dim=-1).values
    return float(top[..., 0] - top[..., 1])


#: faults planted in the decode step, one name of a model module replaced
#: around the decode calls only (the prefills stay sound): (module, name,
#: the replacement made from the sound function).  Decode against prefill
#: must read each above its tolerance.  The GQA ring: the rope at the
#: position before the token's, the token's K/V never written to the
#: ring, and written one ring slot on
DECODE_FAULTS = {
    "rope at decode_pos - 1": (
        llm_attention, "apply_rope",
        lambda f: lambda x, pos, *a: f(x, pos - 1, *a)),
    "K/V not written to the ring": (
        llm_attention, "_write_ring", lambda f: lambda cache, k, v, slot: {
            "k": cache["k"].clone(), "v": cache["v"].clone()}),
    "K/V written one slot on": (
        llm_attention, "_write_ring", lambda f: lambda cache, k, v, slot: f(
            cache, k, v, (slot + 1) % cache["k"].shape[1])),
}
#: multi-head latent attention: the latent ring slot not written, and
#: written one slot on (with the rope fault above)
MLA_FAULTS = {
    "latent not written": (
        llm_attention, "_write_latent",
        lambda f: lambda cache, ckv, kpe, slot: {
            "ckv": cache["ckv"].clone(), "kpe": cache["kpe"].clone()}),
    "latent written one slot on": (
        llm_attention, "_write_latent",
        lambda f: lambda cache, ckv, kpe, slot: f(
            cache, ckv, kpe, (slot + 1) % cache["ckv"].shape[1])),
}
#: Mamba: the SSM state not carried (the prefill's stays), and the conv
#: window not shifted (the new token never enters it)
MAMBA_FAULTS = {
    "SSM state not carried": (
        llm_mamba, "_carry",
        lambda f: lambda cache, window, h: f(cache, window, cache["ssm"])),
    "conv window not shifted": (
        llm_mamba, "_carry",
        lambda f: lambda cache, window, h: {"conv": cache["conv"],
                                            "ssm": h}),
}
#: RWKV-6: the wkv state not carried, and the token shift not carried
RWKV_FAULTS = {
    "wkv state not carried": (
        llm_rwkv, "_carry",
        lambda f: lambda cache, xt, S: f(cache, xt, cache["wkv"])),
    "token shift not carried": (
        llm_rwkv, "_carry",
        lambda f: lambda cache, xt, S: f(cache, cache["tm_shift"], S)),
}
#: a fault of the decode step's router, which ``forced_routing`` hides
#: from the logits (the fresh prefill follows the served choices): the
#: decode routes DeepSeek-V3's tokens by the top k of all experts, the
#: group limit dropped.  Decode against prefill must find the prefill's
#: own router choosing otherwise at no more than half of the steps
ROUTER_FAULTS = {
    "group limit dropped in decode": (
        llm_moe, "route",
        lambda f: lambda x, w, m, bias=None: f(
            x, w, dataclasses.replace(m, n_group=1, topk_group=1),
            **_bias(bias))),
}
FAULTS = {**DECODE_FAULTS, **MLA_FAULTS, **MAMBA_FAULTS, **RWKV_FAULTS}


def _mamba_decode_conv_as_prefill(sound):
    """The Mamba decode step with its conv as the prefill computes it:
    ``_causal_conv`` over the window in the activation dtype, its last
    position, the silu in that dtype; the reference's decode computes the
    conv and silu in float32 and casts after.  The rest of the step as
    the port's."""
    silu = torch.nn.functional.silu

    def step(p, cfg, x, cache):
        m = cfg.mamba
        x_in, z = torch.chunk(x[:, 0] @ p["in_proj"], 2, dim=-1)
        window = torch.cat([cache["conv"], x_in[:, None]], 1)
        x_c = silu(llm_mamba._causal_conv(window, p["conv_w"], p["conv_b"],
                                          m.d_conv)[:, -1])
        A_bar, Bx, C = llm_mamba._ssm_inputs(p, cfg, x_c)
        h = A_bar * cache["ssm"] + Bx
        y = torch.einsum("bds,bs->bd", h, C).to(x.dtype)
        y = (y + p["Dskip"].to(x.dtype) * x_c) * silu(z)
        return (y @ p["out_proj"])[:, None], llm_mamba._carry(cache, window,
                                                              h)
    return step


#: not faults: variants of the decode step that decode against prefill
#: reads to find where a sound gap comes from.  The Mamba conv's only
#: difference between the modes is its dtype, so this one reads how much
#: of jamba's bf16 gap that makes
VARIANTS = {
    "Mamba decode conv in bf16, as the prefill's": (
        llm_mamba, "_decode_step", _mamba_decode_conv_as_prefill),
}
#: the faults each family's decode must catch
FAMILY_FAULTS = {
    "rwkv6-3b": tuple(RWKV_FAULTS),
    "jamba-v0.1-52b": tuple(MAMBA_FAULTS),
    "deepseek-v3-671b": ("rope at decode_pos - 1", *MLA_FAULTS),
    "grok-1-314b": tuple(DECODE_FAULTS),
}
#: the router faults each family's decode must catch
FAMILY_ROUTER_FAULTS = {"deepseek-v3-671b": tuple(ROUTER_FAULTS)}


@contextlib.contextmanager
def planted(fault):
    """The model module of ``fault`` (a ``FAULTS``, ``ROUTER_FAULTS`` or
    ``VARIANTS`` key, or None for none) with the fault planted inside."""
    if fault is None:
        yield
        return
    mod, name, make = {**FAULTS, **ROUTER_FAULTS, **VARIANTS}[fault]
    sound = getattr(mod, name)
    setattr(mod, name, make(sound))
    try:
        yield
    finally:
        setattr(mod, name, sound)


def _bias(bias):
    """``route``'s keyword for a correction bias, none without one."""
    return {} if bias is None else {"bias": bias}


def route_choice(x_flat, router_w, m, bias=None):
    """The scores ``models.moe.route`` takes its top k from."""
    scores = llm_moe.router_scores(x_flat.float() @ router_w, m)
    if llm_moe.published(m, bias):
        return llm_moe.choice_scores(scores, m, bias)
    return scores


@contextlib.contextmanager
def moe_log():
    """Record every MoE routing inside: ``log["route"]`` gets, per call of
    ``models.moe.route`` (one an MoE layer and batch row, in execution
    order), the experts ``idx`` (T, k) and each token's margin between
    its k-th and (k+1)-th router score; ``log["drops"]`` gets, per
    dispatch, (tokens, (token, expert) pairs dropped for capacity)."""
    log = {"route": [], "drops": []}
    route, dispatch = llm_moe.route, llm_moe._dispatch_tables

    def logged_route(x_flat, router_w, m, bias=None):
        w, idx, aux = route(x_flat, router_w, m, **_bias(bias))
        top = torch.sort(route_choice(x_flat, router_w, m, bias),
                         -1, descending=True).values
        log["route"].append((idx.cpu(), (top[:, m.top_k - 1]
                                         - top[:, m.top_k]).cpu()))
        return w, idx, aux

    def logged_dispatch(w, idx, T, E, k, C, first=None):
        slot_tok, slot_w, pair_slot = dispatch(w, idx, T, E, k, C, first)
        # a pair whose expert another card holds takes the overflow slot
        # too, and is no drop
        held = True if first is None else (idx >= first) & (idx < first + E)
        log["drops"].append((T, int(((pair_slot == E * C) & held).sum())))
        return slot_tok, slot_w, pair_slot

    llm_moe.route, llm_moe._dispatch_tables = logged_route, logged_dispatch
    try:
        yield log
    finally:
        llm_moe.route, llm_moe._dispatch_tables = route, dispatch


@contextlib.contextmanager
def forced_routing(idxs):
    """``models.moe.route`` choosing the given experts, one (T, k) ``idx``
    a call in call order, with weights from its own scores at them,
    normalized (and scaled, where it routes as DeepSeek-V3 publishes) as
    ``route`` weighs its top k; its auxiliary losses
    unchanged.  A prefill under it routes as the served path did, so
    decode against it compares the arithmetic alone: a near-tie that
    bf16 rounding flips is a discrete jump, not an error."""
    route, calls = llm_moe.route, iter(idxs)

    def forced(x_flat, router_w, m, bias=None):
        _, idx, aux = route(x_flat, router_w, m, **_bias(bias))
        idx = next(calls).to(idx.device)
        scores = llm_moe.router_scores(x_flat.float() @ router_w, m)
        if llm_moe.published(m, bias):
            return llm_moe.chosen_weights(scores, idx, m), idx, aux
        w = scores.gather(-1, idx)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx, aux

    llm_moe.route = forced
    try:
        yield
    finally:
        llm_moe.route = route


def _chosen(idx):
    """Each row's experts as a set: ascending, whatever order ``top_k``
    listed them in (the layer's output depends on which experts, not on
    their order: the dispatch sorts the pairs by expert)."""
    return torch.sort(idx, -1).values


def routing_report(served, fresh):
    """The fresh prefill's own routing (its router's choice, before
    ``forced_routing`` overrides it) against the served path's, one
    (idx, margins) a layer: whether the new token's experts agree at
    every layer, how many (layer, token) choices differ in all, and per
    layer (the new token's experts equal, its k-th to (k+1)-th margin,
    how many of its experts the fresh prefill chose too).  Choices are
    compared as sets of experts (``_chosen``)."""
    per_layer = [(torch.equal(_chosen(s[-1]), _chosen(f[-1])), float(m[-1]),
                  len(set(s[-1].tolist()) & set(f[-1].tolist())))
                 for (s, _), (f, m) in zip(served, fresh)]
    differ = sum(int((_chosen(s) != _chosen(f)).any(-1).sum())
                 for (s, _), (f, _) in zip(served, fresh))
    return all(eq for eq, _, _ in per_layer), differ, per_layer


def decode_gaps(cfg, params, prompt, steps, fault=None):
    """Greedy decode of ``steps`` tokens from ``prompt``, with ``fault``
    planted in the decode calls; at each step the decode logits against a
    fresh prefill of the prompt plus the tokens so far, at its last
    position, that routes every token through the experts the served
    path chose (``forced_routing``).  Rows of (step, largest difference,
    the prefill's top-2 margin, greedy tokens equal, largest |logit|,
    routing): routing is None for a model without MoE layers, else
    ``routing_report``'s."""
    prefill = make_prefill_step(cfg, cache_len=LLM_CACHE_LEN)
    decode = make_decode_step(cfg)
    toks = torch.as_tensor(prompt, dtype=torch.long, device=params[
        "final_norm"]["scale"].device)[None]
    rows = []
    with torch.no_grad(), moe_log() as log:
        logits, cache = prefill(params, {"tokens": toks})
        served = list(log["route"])
        for step in range(steps):
            nxt = torch.argmax(logits, -1)[:, None]
            toks = torch.cat([toks, nxt], 1)
            log["route"].clear()
            with planted(fault):
                logits, cache = decode(params, {
                    "tokens": nxt, "cache": cache,
                    "decode_pos": toks.shape[1] - 1})
            served = [(torch.cat([a, b]), torch.cat([ma, mb])) for
                      (a, ma), (b, mb) in zip(served, log["route"])]
            log["route"].clear()
            with forced_routing([idx for idx, _ in served]):
                fresh, _ = make_prefill_step(cfg)(params, {"tokens": toks})
            routing = (routing_report(served, log["route"])
                       if served else None)
            rows.append((
                step, float((logits.float() - fresh.float()).abs().max()),
                top2_margin(fresh),
                bool(torch.equal(torch.argmax(logits, -1),
                                 torch.argmax(fresh, -1))),
                float(fresh[..., :cfg.vocab_size].float().abs().max()),
                routing))
    return rows


def layer_gaps(cfg, params, prompt, fault=None):
    """Where along the depth a decode-against-prefill gap enters: one
    decode step after a prefill of ``prompt`` (``fault`` planted in it)
    against a fresh prefill of the prompt plus the new token, routed as
    the served path was (``forced_routing``).  Per layer, in order:
    (mixer, ffn, the largest |decode - prefill| of the layer's output
    hidden state at the new token, the largest |h| there)."""
    prefill = make_prefill_step(cfg, cache_len=LLM_CACHE_LEN)
    toks = torch.as_tensor(prompt, dtype=torch.long, device=params[
        "final_norm"]["scale"].device)[None]
    sound, seen = llm_transformer.apply_layer, []

    def recording(lp, cfg_, spec, *a, **kw):
        out = sound(lp, cfg_, spec, *a, **kw)
        seen.append((spec.mixer, spec.ffn, out[0][:, -1].float()))
        return out

    with torch.no_grad(), moe_log() as log:
        logits, cache = prefill(params, {"tokens": toks})
        nxt = torch.argmax(logits, -1)[:, None]
        served = list(log["route"])
        log["route"].clear()
        llm_transformer.apply_layer = recording
        try:
            with planted(fault):
                make_decode_step(cfg)(params, {
                    "tokens": nxt, "cache": cache,
                    "decode_pos": toks.shape[1]})
            dec = list(seen)
            seen.clear()
            routes = [torch.cat([a, b]) for (a, _), (b, _) in
                      zip(served, log["route"])]
            with forced_routing(routes):
                make_prefill_step(cfg)(params, {
                    "tokens": torch.cat([toks, nxt], 1)})
        finally:
            llm_transformer.apply_layer = sound
    return [(mixer, ffn, float((d - p).abs().max()), float(p.abs().max()))
            for (mixer, ffn, d), (_, _, p) in zip(dec, seen)]


def decode_against_prefill(cfg, params, prompt, steps, tol, what,
                           faults=tuple(DECODE_FAULTS), tag="llm",
                           router_faults=()):
    """``decode_gaps`` of the sound decode: every step within ``tol``,
    the greedy tokens equal wherever the prefill's top-2 margin exceeds
    ``tol``.  With MoE layers the prefill's own router must choose the
    new token's experts as the decode did, at every layer, in more than
    half of the steps.  Then each of ``faults`` planted: its largest
    difference must exceed ``tol``; and each of ``router_faults``
    planted: the prefill's own router must agree at no more than half of
    the steps.  Returns the sound largest difference and each fault's."""
    rows = decode_gaps(cfg, params, prompt, steps)
    for step, err, margin, same, big, routing in rows:
        route_msg = ""
        if routing is not None:
            route_msg = (f"; own routing: new token's experts "
                         f"{'agree' if routing[0] else 'DIFFER'} (equal, "
                         "margin, experts in common a layer: "
                         + ", ".join(f"{'=' if eq else '!'}{m:.3g} {ov}"
                                     for eq, m, ov in routing[2])
                         + f"), {routing[1]} (layer, token) choices differ")
        print(f"[{tag}] {what} step {step}: |decode - prefill| max "
              f"{err:.6g}, prefill top-2 margin {margin:.6g}, |logits| "
              f"max {big:.4g}, greedy {'equal' if same else 'DIFFERS'}"
              f"{route_msg}")
    agree = [r for r in rows if r[5] is None or r[5][0]]
    if rows[0][5] is not None:
        print(f"[{tag}] {what}: the prefill's own router chose the new "
              f"token's experts as the decode did at {len(agree)} of "
              f"{len(rows)} steps")
    fault_errs = {}
    for fault in faults:
        errs = [r[1] for r in decode_gaps(cfg, params, prompt, steps, fault)]
        fault_errs[fault] = max(errs)
        print(f"[{tag}] {what} planted fault '{fault}': |decode - prefill| "
              f"max {max(errs):.6g} (steps: "
              f"{', '.join(f'{e:.4g}' for e in errs)})")
    missed = []
    for fault in router_faults if rows[0][5] is not None else ():
        n = sum(r[5][0] for r in decode_gaps(cfg, params, prompt, steps,
                                             fault))
        print(f"[{tag}] {what} planted router fault '{fault}': the "
              f"prefill's own router agrees at {n} of {len(rows)} steps")
        missed += [fault] if 2 * n > len(rows) else []
    check(2 * len(agree) > len(rows), f"{what}: the new token's routing "
          f"agrees at only {len(agree)} of {len(rows)} steps")
    check(not missed, f"{what}: the routing check does not catch the "
          f"planted router faults {missed}")
    for step, err, margin, same, _, _ in rows:  # every reading printed first
        check(err <= tol, f"{what} step {step}: decode vs prefill "
              f"{err} > {tol}")
        check(same or margin <= tol, f"{what} step {step}: greedy "
              f"token differs at a top-2 margin {margin} > {tol}")
    for fault, worst in fault_errs.items():
        check(worst > tol, f"{what}: planted fault '{fault}' reads "
              f"{worst} <= {tol}: the tolerance does not catch it")
    return max(r[1] for r in rows), fault_errs


def profile_llm(cfg, params, toks, steps=5, tag="llm"):
    """One prefill and ``steps`` decode steps under ``torch.profiler``:
    host wall and device busy a step, device events a step, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    prefill = make_prefill_step(cfg, cache_len=LLM_CACHE_LEN)
    decode = make_decode_step(cfg)
    with torch.no_grad():
        _, cache = prefill(params, {"tokens": toks})
        for label, fn, n in (
                ("prefill", lambda: prefill(params, {"tokens": toks}), 1),
                ("decode", lambda: decode(params, {
                    "tokens": toks[:, -1:], "cache": cache,
                    "decode_pos": toks.shape[1]}), steps)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / n
            rows = _device_rows(prof)
            busy_ms = sum(r[0] for r in rows) / 1e3 / n
            print(f"[profile {tag} {label}] wall {wall_ms:.3f} ms a step "
                  f"(profiled), device busy {busy_ms:.3f} ms = "
                  f"{busy_ms / wall_ms:.3f} of wall, "
                  f"{sum(r[1] for r in rows) / n:.1f} device events a step")
            for dev_us, count, key in rows[:8]:
                print(f"[profile {tag} {label}] {dev_us / n / 1e3:9.4f} ms a "
                      f"step {count // n:5d}x  {key[:90]}")


def phase_llm(profile=False):
    """Token serving of qwen3-4b at its full published width (bf16, random
    weights from seed 0 on the card) through ``ServingEngine``; decode
    against prefill at every step; then a 2-layer model of the same width
    in float32 on the card and on the CPU from the same weights."""
    cfg = get_config("qwen3-4b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device=DEV).manual_seed(SEED),
                        device=DEV)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"[llm] qwen3-4b full: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (padded {params['embed']['table'].shape[0]}),"
          f" {cfg.param_dtype}: {n_params} parameters, {n_bytes} bytes, "
          f"drawn on the card in {time.perf_counter() - t0:.2f} s")
    reqs, out, _, prefill_ms, decode_ms = serve_llm("llm", cfg, params)
    print(f"[llm] parameter bytes {n_bytes}, peak memory "
          f"{torch.cuda.max_memory_allocated()} bytes")
    if profile:
        profile_llm(cfg, params, torch.as_tensor(
            reqs[0].tokens, dtype=torch.long, device=DEV)[None])
    worst, faults = decode_against_prefill(
        cfg, params, reqs[0].tokens, LLM_NEW, LLM_BF16_TOL, "qwen3-4b bf16")
    print(f"[llm] bf16 decode vs prefill: largest difference {worst:.6g} "
          f"(tolerance {LLM_BF16_TOL}); planted faults, least "
          f"{min(faults.values()):.6g}")
    del params
    free_cuda()
    phase_llm_f32(cfg)
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms}


def phase_llm_f32(full):
    """Two layers of the full width in float32 on the card and on the CPU
    from the same weights: logits within ``LLM_F32_TOL``, decode against
    prefill on the card within it (and the planted faults above it), and
    the served tokens equal, unless the first difference sits at a top-2
    margin below the tolerance (printed)."""
    cfg = full.replace(stages=dense_stages(2), dtype="float32",
                       param_dtype="float32")
    gpu = init_model(cfg, torch.Generator(device=DEV).manual_seed(SEED),
                     device=DEV)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size - 1, LLM_PROMPT).astype(
        np.int32) for _ in range(LLM_F32_REQUESTS)]
    cpu = card_against_cpu("llm", "2-layer full width", cfg, gpu, prompts)
    with ieee_float32(), torch.no_grad():
        worst, faults = decode_against_prefill(
            cfg, gpu, prompts[0], LLM_NEW, LLM_F32_TOL, "2-layer float32")
        print(f"[llm] 2-layer float32 decode vs prefill on the card: "
              f"largest difference {worst:.6g} (tolerance {LLM_F32_TOL}); "
              f"planted faults, least {min(faults.values()):.6g}")
        reqs = [Request(i, p, LLM_NEW, float(i)) for i, p in
                enumerate(prompts)]
        served = {}
        for dev, p in ((DEV, gpu), ("cpu", cpu)):
            served[dev] = ServingEngine(cfg, params=p, n_replicas=2,
                                        scheduler="rr", device=dev,
                                        cache_len=LLM_CACHE_LEN).serve(reqs)
        n_equal = 0
        for a, b, q in zip(served[DEV]["responses"],
                           served["cpu"]["responses"], prompts):
            if np.array_equal(a.tokens, b.tokens):
                n_equal += 1
                continue
            k = int(np.argmax(a.tokens != b.tokens))
            prefix = np.concatenate([q, b.tokens[:k]])
            fresh, _ = make_prefill_step(cfg)(cpu, {
                "tokens": torch.from_numpy(prefix).long()[None]})
            margin = top2_margin(fresh)
            print(f"[llm] 2-layer float32: rid {a.rid} tokens differ at "
                  f"step {k} (cuda {a.tokens.tolist()}, cpu "
                  f"{b.tokens.tolist()}), top-2 margin {margin:.6g}")
            check(margin <= LLM_F32_TOL, f"rid {a.rid}: tokens differ at "
                  f"a top-2 margin {margin} > {LLM_F32_TOL}")
    print(f"[llm] 2-layer float32: served tokens cuda == cpu for "
          f"{n_equal} of {len(reqs)} requests "
          f"({[r.tokens.tolist() for r in served[DEV]['responses']]})")
    check(served[DEV]["per_replica"] == served["cpu"]["per_replica"],
          "2-layer float32: per-replica counts differ")


# ------------------------------------------------------- llm families
def cut_config(arch):
    """The published config of ``arch`` with each stage's repeats from
    ``FAMILY_CUTS``."""
    cfg = get_config(arch)
    reps, _ = FAMILY_CUTS[arch]
    return cfg.replace(stages=tuple(Stage(s.pattern, r)
                                    for s, r in zip(cfg.stages, reps)))


def lift_capacity(cfg):
    """``cfg`` with ``capacity_factor = E / top_k`` (C >= T: no drops) for
    decode against prefill; unchanged without MoE layers."""
    if cfg.moe is None:
        return cfg
    m = cfg.moe
    return cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))


def free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def eager_serve(cfg, params, reqs):
    """Each request's tokens by rid from ``make_prefill_step`` and the
    eager ``make_decode_step``, in ``ServingEngine._generate``'s order:
    one prefill at ``LLM_CACHE_LEN``, then ``max_new_tokens`` greedy
    decode steps at B = 1."""
    prefill = make_prefill_step(cfg, cache_len=LLM_CACHE_LEN)
    decode = make_decode_step(cfg)
    tokens = {}
    with torch.no_grad():
        for r in reqs:
            toks = torch.as_tensor(np.asarray(r.tokens, np.int64),
                                   device=DEV)[None]
            logits, cache = prefill(params, {"tokens": toks})
            nxt = torch.argmax(logits, -1)[:, None]
            got = []
            for i in range(r.max_new_tokens):
                got.append(int(nxt[0, 0]))
                logits, cache = decode(params, {
                    "tokens": nxt, "cache": cache,
                    "decode_pos": toks.shape[1] + i})
                nxt = torch.argmax(logits, -1)[:, None]
            tokens[r.rid] = got
    return tokens


def serve_llm(tag, cfg, params):
    """``[llm]``'s workload through ``ServingEngine`` on the card: 8
    requests of 16-token prompts at 20 a second, 8 greedy tokens each, 4
    fcfs replicas, ``cache_len`` 256.  Returns the requests, the serve's
    report, its MoE log (routing and drops of the served prefills and
    decodes, at the config's own capacity factor; None without MoE
    layers) and the prefill and decode ms by CUDA events.  The timed
    serve runs the program as it is; the log comes from a second,
    untimed serve of the same requests under ``moe_log`` (whose router
    product, sort and host copies in every MoE layer would otherwise
    enter the measured walls), which must give the same tokens.  The
    served decode steps replay CUDA graphs, inside which ``moe_log``
    sees no dispatch, so the log's one-token dispatches come from the
    same requests decoded eagerly (``eager_serve``), whose tokens must
    equal the served ones bit for bit."""
    rng = np.random.default_rng(SEED)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size - 1, LLM_PROMPT)
                    .astype(np.int32), LLM_NEW, i / LLM_RATE)
            for i in range(LLM_REQUESTS)]
    eng = ServingEngine(cfg, params=params, n_replicas=4, scheduler="fcfs",
                        cache_len=LLM_CACHE_LEN, device=DEV)
    eng.warmup(LLM_PROMPT)
    ops.reset_launches()
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    wall = time.perf_counter() - t0
    if cfg.mla is not None:
        n = ops.launches()["mla_decode"]
        layers = len(cfg.layer_specs())
        want = 3 * layers * LLM_REQUESTS * LLM_NEW
        print(f"[{tag}] MLA decode launches counted over the timed serve: "
              f"{n}, {want} expected (3 a call at each of {layers} layers "
              f"in each of the {LLM_REQUESTS} x {LLM_NEW} decode steps)")
        check(n == want, f"{tag}: the served decode launched the MLA "
              f"decode kernel {n} times, not {want}")
    log = None
    if cfg.moe is not None:
        n = ops.launches()["routed_experts"]
        print(f"[{tag}] routed-experts launches counted over the timed "
              f"serve: {n}, {n / (LLM_REQUESTS * LLM_NEW):.4g} a "
              f"generated token ({LLM_REQUESTS} requests of {LLM_NEW}; "
              f"a prefill's capacity {llm_moe.capacity(LLM_PROMPT, cfg.moe)}"
              f" slots an expert)")
        with moe_log() as log:
            logged = eng.serve(reqs)
        with moe_log() as eager_log:
            eager = eager_serve(cfg, params, reqs)
        log["drops"] += [d for d in eager_log["drops"] if d[0] == 1]
        check([r.tokens.tolist() for r in logged["responses"]]
              == [r.tokens.tolist() for r in out["responses"]],
              f"{tag}: the logged serve's tokens differ from the timed one's")
        check(all(eager[r.rid] == r.tokens.tolist()
                  for r in out["responses"]),
              f"{tag}: the served (graphed) decode's tokens differ from "
              f"the eager decode's")
        print(f"[{tag}] the same serve under moe_log (not reported): "
              f"{logged['throughput_rps']:.4f} req/s on the virtual "
              f"clock, the same tokens")
    check(len(out["responses"]) == LLM_REQUESTS and not out["dropped"],
          f"{tag} serve: {len(out['responses'])} responses, dropped "
          f"{out['dropped']}")
    for r in out["responses"]:
        check(r.tokens.shape == (LLM_NEW,) and
              ((0 <= r.tokens) & (r.tokens < cfg.vocab_size)).all(),
              f"{tag} serve: rid {r.rid} tokens {r.tokens}")
    prefill = make_prefill_step(cfg, cache_len=LLM_CACHE_LEN)
    decode = make_decode_step(cfg)
    toks = torch.as_tensor(reqs[0].tokens, dtype=torch.long,
                           device=DEV)[None]
    with torch.no_grad():
        prefill_ms = cuda_ms(lambda: prefill(params, {"tokens": toks}),
                             iters=10, warmup=2)
        _, cache = prefill(params, {"tokens": toks})
        decode_ms = cuda_ms(lambda: decode(params, {
            "tokens": toks[:, -1:], "cache": cache,
            "decode_pos": LLM_PROMPT}), iters=20, warmup=2)
        again = [decode(params, {"tokens": toks[:, -1:], "cache": cache,
                                 "decode_pos": LLM_PROMPT})[0]
                 for _ in range(2)]
    check(torch.equal(*again), f"{tag}: two decodes of one step differ")
    print(f"[{tag}] ServingEngine 4 replicas fcfs cache_len "
          f"{LLM_CACHE_LEN}: {LLM_REQUESTS} requests of {LLM_PROMPT} "
          f"tokens, {LLM_NEW} new each, served in {wall:.3f} s host wall; "
          f"{out['throughput_rps']:.4f} req/s on the virtual clock, p50 "
          f"{out['p50_latency'] * 1e3:.2f} ms, per-replica "
          f"{out['per_replica']}; prefill {prefill_ms:.3f} ms, decode "
          f"{decode_ms:.3f} ms a token (CUDA events); two decodes of one "
          f"step bit-equal")
    print(f"[{tag}] first response tokens: "
          f"{out['responses'][0].tokens.tolist()}")
    return reqs, out, log, prefill_ms, decode_ms


def phase_family(arch, profile=False):
    """One family at its published widths (``FAMILY_CUTS``), bf16, random
    weights drawn on the card from seed 0 (expert stacks one expert at a
    time): parameters, bytes and peak memory; ``serve_llm``; the drops
    the served prefills made at the published capacity factor; decode
    against a fresh prefill at ``FAMILY_BF16_TOL`` with capacity lifted
    to E / k, the family's planted faults above it; for rwkv6-3b the
    ``[rwkv-model]`` check on its layer 0.  Returns the launches of the
    check (the model itself launches none of the eight kernels that
    replace the reference's)."""
    tag = "llm-" + arch.split("-")[0].removesuffix("6")
    cfg = cut_config(arch)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device=DEV).manual_seed(SEED),
                        device=DEV)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    full = get_config(arch)
    print(f"[{tag}] {arch} at its published widths (d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}), {cfg.n_layers} of {full.n_layers} layers; "
          f"reduced: {FAMILY_CUTS[arch][1]}; {n_params} parameters, "
          f"{n_bytes} bytes, drawn on the card in {draw_s:.2f} s; weight-"
          f"read bound a decode step {n_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
          f" ms")
    reqs, out, log, prefill_ms, decode_ms = serve_llm(tag, cfg, params)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] parameter bytes {n_bytes}, peak memory {peak} bytes")
    if cfg.moe is not None:
        pre = [d for T, d in log["drops"] if T > 1]
        dec = [d for T, d in log["drops"] if T == 1]
        print(f"[{tag}] capacity factor {cfg.moe.capacity_factor}: the "
              f"served prefills dropped {sum(pre)} (token, expert) pairs "
              f"over {len(pre)} dispatches ({LLM_PROMPT} tokens x top-"
              f"{cfg.moe.top_k}), the eager decodes of the served "
              f"requests {sum(dec)} over {len(dec)}")
        check(len(dec) > 0, f"{tag}: no one-token decode dispatch logged")
        check(sum(dec) == 0, f"{tag}: a one-token decode dropped a pair")
    if profile:
        profile_llm(cfg, params, torch.as_tensor(
            reqs[0].tokens, dtype=torch.long, device=DEV)[None], tag=tag)
    tol = FAMILY_BF16_TOL[arch]
    worst, faults = decode_against_prefill(
        lift_capacity(cfg), params, reqs[0].tokens, LLM_NEW, tol,
        f"{arch} bf16", faults=FAMILY_FAULTS[arch], tag=tag,
        router_faults=FAMILY_ROUTER_FAULTS.get(arch, ()))
    print(f"[{tag}] bf16 decode vs prefill: largest difference {worst:.6g} "
          f"(tolerance {tol}); planted faults, least "
          f"{min(faults.values()):.6g}")
    if cfg.mamba is not None:
        for variant in (None, *VARIANTS):
            if variant is not None:
                rows = decode_gaps(lift_capacity(cfg), params,
                                   reqs[0].tokens, LLM_NEW, fault=variant)
                print(f"[{tag}] {arch} bf16 with the {variant}: |decode - "
                      f"prefill| max {max(r[1] for r in rows):.6g} (steps: "
                      + ", ".join(f"{r[1]:.4g}" for r in rows)
                      + f"; sound {worst:.6g})")
            gaps = layer_gaps(lift_capacity(cfg), params, reqs[0].tokens,
                              variant)
            print(f"[{tag}] {arch} bf16 step 0 a layer"
                  f"{', ' + variant if variant else ''}: |decode - "
                  "prefill| of its output / |h| max: "
                  + "; ".join(f"{i} {mx}+{ff} {e:.4g} / {h:.4g}"
                              for i, (mx, ff, e, h) in enumerate(gaps)))
    launches = (phase_rwkv_model(cfg, params, reqs[0].tokens)
                if cfg.rwkv else None)
    del params
    free_cuda()
    if arch in FAMILY_F32:
        phase_family_f32(tag, arch)
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "peak": peak}, launches


def phase_rwkv_model(cfg, params, prompt):
    """``[rwkv-model]``: layer 0 of the served rwkv6-3b on a served
    prompt.  Its float32 r, k, v, w (from the bf16 layer) and u go through
    ``ops.rwkv_scan`` (table row 8's kernel), counted from zero, held
    against the model's own recurrence (``models.rwkv._recurrence``) at
    ``F32_TOL`` (five times that for the state).  A check, not a caller:
    the model computes its own loop."""
    r_cfg = cfg.rwkv
    H, hs = cfg.d_model // r_cfg.head_size, r_cfg.head_size
    lp = params["stages"][0]["layers"][0]
    toks = torch.as_tensor(prompt, dtype=torch.long, device=DEV)[None]
    B, T = toks.shape
    with torch.no_grad():
        h = params["embed"]["table"][toks].to(torch.bfloat16)
        x = llm_layers.apply_rms_norm(lp["mixer_norm"], h, cfg.norm_eps)
        r, k, v, _, w = llm_rwkv._projections(lp["mixer"], x,
                                              llm_rwkv._shift(x),
                                              (B, T, H, hs))
        u = lp["mixer"]["u"]
        s0 = torch.zeros((B, H, hs, hs), dtype=torch.float32, device=DEV)
        want, S = llm_rwkv._recurrence(r, k, v, w, u, s0)
        want = want.transpose(1, 2)                    # (B, H, T, hs)
        args = [a.transpose(1, 2).contiguous() for a in (r, k, v, w)]
        torch.cuda.synchronize()
        ops.reset_launches()
        got, s_got = ops.rwkv_scan(*args, u, s0)
        torch.cuda.synchronize()
        launches = ops.launches()
    (e_out, ok_out), (e_s, ok_s) = (_close(got, want, F32_TOL),
                                    _close(s_got, S, 5 * F32_TOL))
    print(f"[rwkv-model] rwkv6-3b layer 0 on the served prompt (B={B}, "
          f"H={H}, T={T}, hs={hs}; r, k, v, w float32 from the bf16 "
          f"layer): ops.rwkv_scan against the model's own recurrence: max "
          f"|out| diff {e_out:.3e} within {F32_TOL}: {ok_out}; max |state| "
          f"diff {e_s:.3e} within {5 * F32_TOL}: {ok_s}; launches "
          f"{launches}")
    check(launches["rwkv_scan"] == 1 and ok_out and ok_s,
          f"rwkv-model: {launches}, out {e_out}, state {e_s}")
    return launches


def card_against_cpu(tag, what, cfg, gpu, prompts):
    """Float32 logits (and the MTP head's, where the model has one) of
    ``cfg`` from the same weights on the card and on the CPU, within
    ``LLM_F32_TOL``; with MoE layers, every routing decision equal (the
    least router margin printed).  Returns the CPU parameters."""
    cpu = params_to(gpu, "cpu")
    toks = torch.from_numpy(np.stack(prompts)).long()
    with ieee_float32(), torch.no_grad():
        with moe_log() as lg:
            out_g = model_apply(gpu, cfg, {"tokens": toks.to(DEV)})
        with moe_log() as lc:
            out_c = model_apply(cpu, cfg, {"tokens": toks})
    V = cfg.vocab_size
    errs = {"logits": float((out_g[0][..., :V].cpu()
                             - out_c[0][..., :V]).abs().max())}
    if "mtp_logits" in out_c[2]:
        errs["mtp_logits"] = float((out_g[2]["mtp_logits"][..., :V].cpu()
                                    - out_c[2]["mtp_logits"][..., :V])
                                   .abs().max())
    route = ""
    if lc["route"]:
        same = all(torch.equal(a[0], b[0]) for a, b in
                   zip(lg["route"], lc["route"]))
        least = min(float(m.min()) for _, m in lc["route"])
        route = (f"; routing cuda == cpu: {same} (least top-k margin "
                 f"{least:.3g})")
        check(same, f"{what}: routing differs between cuda and cpu")
    print(f"[{tag}] {what} float32, {len(prompts)} x {LLM_PROMPT} tokens: "
          f"|cuda - cpu| max "
          + ", ".join(f"{k} {e:.6g}" for k, e in errs.items())
          + f" (tolerance {LLM_F32_TOL}; logits up to "
          f"{float(out_c[0][..., :V].abs().max()):.4g}){route}")
    for k, e in errs.items():
        check(e <= LLM_F32_TOL, f"{what}: {k} cuda vs cpu {e}")
    return cpu


def phase_family_f32(tag, arch):
    """The full-width float32 cut of ``FAMILY_F32``: card against CPU
    from the same weights, then decode against prefill on the card at
    ``LLM_F32_TOL`` with the family's faults above it."""
    stages, what = FAMILY_F32[arch]
    full = get_config(arch)
    cfg = full.replace(stages=stages(full), dtype="float32",
                       param_dtype="float32")
    gpu = init_model(cfg, torch.Generator(device=DEV).manual_seed(SEED),
                     device=DEV)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size - 1, LLM_PROMPT).astype(
        np.int32) for _ in range(LLM_F32_REQUESTS)]
    cpu = card_against_cpu(tag, f"{arch} full width, {what},", cfg, gpu,
                           prompts)
    del cpu
    with ieee_float32():
        worst, faults = decode_against_prefill(
            cfg, gpu, prompts[0], LLM_NEW, LLM_F32_TOL,
            f"{arch} float32 {what}", faults=FAMILY_FAULTS[arch], tag=tag)
    print(f"[{tag}] float32 decode vs prefill on the card: largest "
          f"difference {worst:.6g} (tolerance {LLM_F32_TOL}); planted "
          f"faults, least {min(faults.values()):.6g}")
    del gpu
    free_cuda()


def phase_families_smoke_f32():
    """``[llm-smoke]``: each family's smoke preset in float32, card
    against CPU from the same weights (``card_against_cpu``).  The full
    width of an MoE layer in float32 is left out: a copy on the host
    would take 11-45 GB."""
    rng = np.random.default_rng(SEED + 2)
    for arch in FAMILY_CUTS:
        cfg = get_config(arch, preset="smoke")
        gpu = init_model(cfg, torch.Generator(device=DEV).manual_seed(SEED),
                         device=DEV)
        prompts = [rng.integers(0, cfg.vocab_size - 1, LLM_PROMPT).astype(
            np.int32) for _ in range(LLM_F32_REQUESTS)]
        card_against_cpu("llm-smoke", f"{arch} smoke preset", cfg, gpu,
                         prompts)


# ------------------------------------------------------- llm training
def counted(mod, name, counts):
    """``mod.name`` wrapped to add one to ``counts[name]`` a call (the
    context restores it)."""
    sound = getattr(mod, name)

    def wrapper(*a, **kw):
        counts[name] = counts.get(name, 0) + 1
        return sound(*a, **kw)

    @contextlib.contextmanager
    def ctx():
        setattr(mod, name, wrapper)
        try:
            yield counts
        finally:
            setattr(mod, name, sound)
    return ctx()


def _finite(metrics):
    return all(bool(torch.isfinite(v).all()) for v in metrics.values())


def phase_llm_train(profile=False):
    """``[llm-train]``: minicpm-2b at its published widths (all 40 layers,
    bf16 parameters, random from seed 0 on the card) trained
    ``LLM_TRAIN_STEPS`` steps by ``make_train_step(remat=True)`` with
    AdamW at its defaults and the WSD schedule, on ``LMBatchIterator``
    batches of ``LLM_TRAIN_BATCH`` x ``LLM_TRAIN_SEQ`` tokens (T = S =
    2048: the chunked attention, each key tile recomputed in backward,
    counted).  Prints each step's metrics, ms a step by CUDA events (the
    first step apart), tokens a second and peak memory; gates on every
    metric finite and the mean loss of the last 3 steps below the first
    step's."""
    cfg = get_config(LLM_TRAIN_ARCH)
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig()
    t0 = time.perf_counter()
    state = train_state_init(cfg, torch.Generator(device=DEV).manual_seed(
        SEED), opt, DEV)
    torch.cuda.synchronize()
    leaves = list(_leaves(state["params"]))
    n_params = sum(t.numel() for t in leaves)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"[llm-train] {LLM_TRAIN_ARCH} at its published widths: "
          f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (tied), {cfg.param_dtype}: {n_params} "
          f"parameters, {n_bytes} bytes, float32 moments; state drawn on "
          f"the card in {time.perf_counter() - t0:.2f} s; reduced: nothing")
    check(n_params == LLM_TRAIN_PARAMS,
          f"{n_params} parameters, the reference's {LLM_TRAIN_PARAMS}")
    sched = make_schedule("wsd", opt.peak_lr, LLM_TRAIN_STEPS,
                          warmup_steps=max(2, LLM_TRAIN_STEPS // 10))
    step = make_train_step(cfg, opt, sched, remat=True, donate=True)
    t0 = time.perf_counter()
    it = iter(LMBatchIterator(cfg, LLM_TRAIN_BATCH, LLM_TRAIN_SEQ,
                              device=DEV))
    batches = [next(it) for _ in range(LLM_TRAIN_STEPS)]
    print(f"[llm-train] {LLM_TRAIN_STEPS} batches of {LLM_TRAIN_BATCH} x "
          f"{LLM_TRAIN_SEQ} tokens made in {time.perf_counter() - t0:.2f} "
          f"s (set-up)")
    rows, ms = [], []
    counts = {}
    for i, batch in enumerate(batches):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        with contextlib.ExitStack() as stack:
            if i == 1:      # the chunked path and its recompute, one step
                for name in ("_sdpa_chunked", "_kv_step"):
                    stack.enter_context(counted(llm_attention, name, counts))
            e0.record()
            state, metrics = step(state, batch)
            e1.record()
            torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        row = {k: float(v) for k, v in metrics.items()}
        rows.append(row)
        print(f"[llm-train] step {i:2d} " + " ".join(
            f"{k}={v:.6g}" for k, v in row.items())
              + f" ({ms[-1]:.3f} ms)")
        check(_finite(metrics), f"llm-train step {i}: a metric is not "
              f"finite: {row}")
    peak = torch.cuda.max_memory_allocated()
    steady = ms[1:]
    mean_ms = sum(steady) / len(steady)
    tokens = LLM_TRAIN_BATCH * LLM_TRAIN_SEQ
    n_tiles = (LLM_TRAIN_SEQ // llm_attention.Q_CHUNK) * (
        LLM_TRAIN_SEQ // llm_attention.K_CHUNK)
    print(f"[llm-train] chunked attention in one step: {counts} calls "
          f"({cfg.n_layers} layers x 2: forward and the layer's recompute; "
          f"{n_tiles} tiles a call, and each tile once more in backward)")
    check(counts.get("_sdpa_chunked") == 2 * cfg.n_layers and
          counts.get("_kv_step") == 3 * n_tiles * cfg.n_layers,
          f"llm-train: chunked attention calls {counts}")
    last = sum(r["total_loss"] for r in rows[-3:]) / 3
    print(f"[llm-train] {LLM_TRAIN_STEPS} steps: first step "
          f"{ms[0]:.3f} ms, then {mean_ms:.3f} ms a step (CUDA events; "
          f"min {min(steady):.3f}, max {max(steady):.3f}), "
          f"{tokens / mean_ms * 1e3:.1f} tokens/s; peak memory {peak} "
          f"bytes; loss {rows[0]['total_loss']:.4f} -> mean of the last 3 "
          f"{last:.4f}; {gpu_line()}")
    check(last < rows[0]["total_loss"],
          f"llm-train: loss did not fall ({rows[0]['total_loss']} -> {last})")
    if profile:
        profile_train_step(step, state, batches[-1])
    del state, batches
    free_cuda()
    return {"ms": mean_ms, "peak": peak}


def profile_train_step(step, state, batch):
    """One more training step under ``torch.profiler``: host wall, device
    busy and its share, device events, and the largest device rows."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"[profile llm-train] wall {wall_ms:.3f} ms a step (profiled), "
          f"device busy {busy_ms:.3f} ms = {busy_ms / wall_ms:.3f} of wall, "
          f"{sum(r[1] for r in rows)} device events a step")
    for dev_us, count, key in rows[:10]:
        print(f"[profile llm-train] {dev_us / 1e3:9.3f} ms {count:6d}x  "
              f"{key[:90]}")


def adam_step_tolerance(lr, p, g0, g1, m, v, scales, opt):
    """Per element, how far a parameter after a run's second AdamW step
    may sit from another run's, when both start from the same state and
    their gradients at steps 1 and 2 differ by at most ``GRAD_RTOL`` |g| +
    ``GRAD_ATOL`` (each times its clip scale in ``scales``):
    ``PARAM_RTOL`` of the parameter plus lr times the change that makes
    to ``mhat / (sqrt(vhat) + eps)`` to first order, at the other run's
    moments ``m``, ``v`` after step 2 (numpy, float64).  Where the first
    moment nearly cancels (0.9 * 0.1 g1 + 0.1 g2 near 0) a gradient
    difference well inside the tolerance moves Adam's step by a few 1e-4
    of lr, beyond ``PARAM_RTOL`` alone."""
    s0, s1 = scales
    e0 = s0 * (GRAD_RTOL * np.abs(g0) + GRAD_ATOL)
    e1 = s1 * (GRAD_RTOL * np.abs(g1) + GRAD_ATOL)
    b1, b2 = opt.b1, opt.b2
    dm = b1 * (1 - b1) * e0 + (1 - b1) * e1
    dv = 2 * (b2 * (1 - b2) * s0 * np.abs(g0) * e0
              + (1 - b2) * s1 * np.abs(g1) * e1)
    mhat, dmhat = np.abs(m) / (1 - b1 ** 2), dm / (1 - b1 ** 2)
    vhat, dvhat = v / (1 - b2 ** 2), dv / (1 - b2 ** 2)
    root = np.sqrt(vhat)
    dratio = dmhat / (root + opt.eps) + mhat * dvhat / (
        2 * np.maximum(root, 1e-150) * (root + opt.eps) ** 2)
    return PARAM_RTOL * np.abs(p) + lr * dratio


def hold_adam_step(tag, got, want, g0, g1, m, v, scales, lr, opt):
    """The parameters ``got`` after a second AdamW step against ``want``
    (both trees): where ``want``'s gradient |g1| > ``SMALL_GRAD`` within
    ``adam_step_tolerance``, elsewhere within 2 lr plus ``PARAM_RTOL``
    (Adam's step is +-lr there, the sign mostly rounding).  Returns the
    count of elements in the second group and of elements beyond
    ``PARAM_RTOL`` alone in the first."""
    n_small = n_cond = 0
    for a, b, x0, x1, mm, vv in zip(*(tree_leaves(t) for t in (
            got, want, g0, g1, m, v))):
        a, b, x0, x1, mm, vv = (t.detach().cpu().double().numpy() for t in
                                (a, b, x0, x1, mm, vv))
        diff = np.abs(a - b)
        tol = adam_step_tolerance(lr, b, x0, x1, mm, vv, scales, opt)
        large = np.abs(x1) > SMALL_GRAD
        over = diff > np.where(large, tol, 2 * lr + PARAM_RTOL * np.abs(b))
        if over.any():
            raise SmokeFailure(f"{tag}: a parameter off by "
                               f"{float(diff[over].max())} (lr {lr})")
        n_small += int((~large).sum())
        n_cond += int((large & (diff > PARAM_RTOL * np.abs(b))).sum())
    return n_small, n_cond


def grads_close(tag, got, want):
    """Gradient trees within ``GRAD_RTOL`` |want| + ``GRAD_ATOL``; returns
    the largest excess of |got - want| over ``GRAD_RTOL`` |want|."""
    worst = -1.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = a.detach().cpu().double(), b.detach().double()
        excess = float(((a - b).abs() - GRAD_RTOL * b.abs()).max())
        worst = max(worst, excess)
    check(worst <= GRAD_ATOL, f"{tag}: gradients cuda vs cpu off by "
          f"{worst} beyond rtol {GRAD_RTOL} (atol {GRAD_ATOL})")
    return worst


def train_batches(cfg, n, device):
    """``n`` training batches of ``TRAIN_F32_BATCH`` x ``TRAIN_F32_SEQ``,
    made as the reference launcher makes them, on ``device``."""
    if cfg.modality == "text":
        it = iter(LMBatchIterator(cfg, TRAIN_F32_BATCH, TRAIN_F32_SEQ,
                                  device=device))
        return [next(it) for _ in range(n)]
    return [make_modality_batch(cfg, TRAIN_F32_BATCH, TRAIN_F32_SEQ, seed=i,
                                device=device) for i in range(n)]


def two_steps(cfg, state, batches, opt):
    """Two ``make_train_step(remat=True)`` steps (lr 0, then the peak:
    WSD over 2 steps) from ``state``, with ``grad_fn``'s gradients at
    each step's parameters: (states after 1 and 2 steps, gradients at
    both, metrics of both)."""
    sched = make_schedule("wsd", opt.peak_lr, 2, warmup_steps=1)
    step = make_train_step(cfg, opt, sched, remat=True)
    g0, _ = grad_fn(state["params"], cfg, batches[0], remat=True)
    s1, m0 = step(state, batches[0])
    g1, _ = grad_fn(s1["params"], cfg, batches[1], remat=True)
    s2, m1 = step(s1, batches[1])
    return (s1, s2), (g0, g1), (m0, m1)


def train_card_against_cpu(tag, what, cfg, state, opt):
    """``two_steps`` on the card and on the CPU from the same float32
    state: each step's metrics within ``TRAIN_F32_RTOL`` relative, the
    gradients within ``GRAD_RTOL`` + ``GRAD_ATOL``, the moments after
    step 2 within ``PARAM_RTOL`` + ``MOMENT_ATOL``, and the parameters
    under ``hold_adam_step``.  Returns the card's states."""
    cpu_state = params_to(state, "cpu")
    batches = train_batches(cfg, 2, "cpu")
    t0 = time.perf_counter()
    gs, gg, gm = two_steps(cfg, state, [{k: v.to(DEV) for k, v in
                                         b.items()} for b in batches], opt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cs, cg, cm = two_steps(cfg, cpu_state, batches, opt)
    t2 = time.perf_counter()
    worst_metric = 0.0
    for i, (a, b) in enumerate(zip(gm, cm)):
        check(_finite(a), f"{what} step {i}: a metric is not finite")
        check(set(a) == set(b), f"{what}: metrics {set(a)} vs {set(b)}")
        for k in b:
            err = abs(float(a[k]) - float(b[k])) / max(abs(float(b[k])),
                                                       1e-30)
            if float(b[k]) == 0.0:
                err = abs(float(a[k]))
            worst_metric = max(worst_metric, err)
            check(err <= TRAIN_F32_RTOL, f"{what} step {i} {k}: cuda "
                  f"{float(a[k])} vs cpu {float(b[k])}")
    worst_grad = max(grads_close(f"{what} step {i}", a, b)
                     for i, (a, b) in enumerate(zip(gg, cg)))
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(gs[1]["opt"][key]),
                        tree_leaves(cs[1]["opt"][key])):
            a, b = a.cpu().double(), b.double()
            check(bool(((a - b).abs() <= PARAM_RTOL * b.abs()
                        + MOMENT_ATOL).all()),
                  f"{what}: moment {key} cuda vs cpu")
    lr = float(cm[1]["lr"])
    scales = [min(1.0, opt.grad_clip / (float(m["grad_norm"]) + 1e-9))
              for m in cm]
    n_small, n_cond = hold_adam_step(
        what, gs[1]["params"], cs[1]["params"], cg[0], cg[1],
        cs[1]["opt"]["m"], cs[1]["opt"]["v"], scales, lr, opt)
    n_all = sum(t.numel() for t in tree_leaves(cs[1]["params"]))
    print(f"[{tag}] {what} float32, 2 steps of {TRAIN_F32_BATCH} x "
          f"{TRAIN_F32_SEQ} (cuda {t1 - t0:.2f} s, cpu {t2 - t1:.2f} s, "
          f"with grad_fn's gradients): losses "
          f"{float(gm[0]['total_loss']):.6f}, {float(gm[1]['total_loss']):.6f}"
          f"; metrics cuda vs cpu within {worst_metric:.3g} relative (held "
          f"to {TRAIN_F32_RTOL}); gradients within {worst_grad:.3g} beyond "
          f"rtol {GRAD_RTOL} (atol {GRAD_ATOL}); parameters after step 2 "
          f"under the Adam rule ({n_small} of {n_all} at |g| <= "
          f"{SMALL_GRAD}, {n_cond} beyond rtol alone)")
    return gs


def bits_equal(a, b):
    """Two trees equal bit for bit (NaN equal to itself)."""
    return all(x.dtype == y.dtype and torch.equal(
        x.detach().reshape(-1).view(torch.uint8),
        y.detach().reshape(-1).view(torch.uint8))
        for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_llm_train_f32():
    """``[llm-train-f32]``: minicpm-2b at full width cut to 2 layers, in
    float32, card against CPU (``train_card_against_cpu``); then on the
    card ``grad_fn`` with remat on and off, and twice with it on: whether
    each pair is bit-equal.  Returns whether the card's gradients repeat
    bit for bit."""
    full = get_config(LLM_TRAIN_ARCH)
    cfg = full.replace(stages=dense_stages(2), dtype="float32",
                       param_dtype="float32")
    opt = AdamWConfig()
    state = train_state_init(cfg, torch.Generator(device=DEV).manual_seed(
        SEED), opt, DEV)
    train_card_against_cpu("llm-train-f32", f"{LLM_TRAIN_ARCH} full width, "
                           "2 layers,", cfg, state, opt)
    batch = {k: v.to(DEV) for k, v in train_batches(cfg, 1, "cpu")[0].items()}
    runs = [grad_fn(state["params"], cfg, batch, remat=r)
            for r in (True, True, False)]
    same = bits_equal(runs[0][0], runs[1][0])
    remat_same = bits_equal(runs[0][0], runs[2][0])
    diff = ""
    if not same:
        leaves = [(name, a, b) for name, a, b in zip(
            _leaf_names(state["params"]), tree_leaves(runs[0][0]),
            tree_leaves(runs[1][0])) if not torch.equal(a, b)]
        diff = "; leaves that differ: " + ", ".join(
            f"{n} (max {float((a - b).abs().max()):.3g})"
            for n, a, b in leaves)
    print(f"[llm-train-f32] on the card: two runs of grad_fn bit-equal: "
          f"{same}; remat on vs off bit-equal: {remat_same}{diff}")
    del state, runs
    free_cuda()
    return same


def _leaf_names(tree, prefix=""):
    """Path strings of ``tree``'s leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in
                _leaf_names(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in
                _leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


def phase_train_smoke():
    """``[train-smoke]``: every architecture's smoke preset in float32,
    two steps on the card against the CPU from the same weights
    (``train_card_against_cpu``): MLA, MoE with drops, Mamba, RWKV, the
    MTP loss, audio and VLM batches through autograd on the card."""
    opt = AdamWConfig(peak_lr=1e-2)
    for arch in ARCH_IDS:
        cfg = get_config(arch, preset="smoke")
        state = train_state_init(cfg, torch.Generator(
            device=DEV).manual_seed(SEED), opt, DEV)
        train_card_against_cpu("train-smoke", f"{arch} smoke preset", cfg,
                               state, opt)


def phase_train_ckpt(deterministic):
    """``[train-ckpt]``: minicpm-2b's smoke preset in bf16 on the card:
    ``CKPT_STEPS[0]`` steps, saved, restored into a fresh state, then
    ``CKPT_STEPS[1]`` more; against the same steps uninterrupted: bit for
    bit where ``deterministic`` (the card repeated its gradients),
    else within ``TRAIN_F32_RTOL`` on the losses.  Every restored leaf
    equals the saved one bit for bit (bf16 included).  Then
    ``launch.train --device cuda --preset smoke --steps 20 --checkpoint``
    must print its round-trip line."""
    cfg = get_config(LLM_TRAIN_ARCH, preset="smoke").replace(
        dtype="bfloat16", param_dtype="bfloat16")
    opt = AdamWConfig(peak_lr=3e-3)
    k, m = CKPT_STEPS
    sched = make_schedule("wsd", opt.peak_lr, k + m, warmup_steps=2)
    step = make_train_step(cfg, opt, sched, remat=True)
    fresh = lambda: train_state_init(cfg, torch.Generator(
        device=DEV).manual_seed(SEED), opt, DEV)
    it = iter(LMBatchIterator(cfg, TRAIN_F32_BATCH, TRAIN_F32_SEQ,
                              device=DEV))
    batches = [next(it) for _ in range(k + m)]
    whole, losses = fresh(), []
    for b in batches:
        whole, met = step(whole, b)
        losses.append(float(met["total_loss"]))
    part = fresh()
    for b in batches[:k]:
        part, _ = step(part, b)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ck"
        save_checkpoint(path, part, step=k)
        restored = restore_checkpoint(path, fresh(), device=DEV)
        check(checkpoint_step(path) == k, "train-ckpt: checkpoint step")
        check(bits_equal(restored, part), "train-ckpt: a restored leaf "
              "differs from the saved one")
        n_bf16 = sum(t.dtype == torch.bfloat16 for t in tree_leaves(part))
        resumed = []
        for b in batches[k:]:
            restored, met = step(restored, b)
            resumed.append(float(met["total_loss"]))
        same = bits_equal(restored, whole)
        print(f"[train-ckpt] {cfg.name} bf16: {k} steps, saved, restored "
              f"into a fresh state ({n_bf16} bf16 leaves bit for bit), "
              f"{m} more: losses {resumed} against {losses[k:]} "
              f"uninterrupted; final state bit-equal: {same}")
        if deterministic:
            check(same and resumed == losses[k:],
                  "train-ckpt: the resumed run differs from the "
                  "uninterrupted one")
        else:
            check(all(abs(a - b) <= TRAIN_F32_RTOL * abs(b)
                      for a, b in zip(resumed, losses[k:])),
                  "train-ckpt: resumed losses off the uninterrupted ones")
        out = run_main_quietly(launch_train.main, [
            "--device", DEV, "--preset", "smoke", "--steps", "20",
            "--checkpoint", str(Path(tmp) / "launch")])
    lines = out.strip().splitlines()
    print("\n".join(f"[train-ckpt] launch.train: {line}" for line in lines))
    check(lines[-1].startswith("checkpoint round-trip OK -> "),
          f"launch.train: {lines[-1]}")


def start_dryrun(out_dir):
    """Start ``DRYRUN_RUNS``, each ``python -m repro_torch.launch.dryrun
    ... --out out_dir`` in a process of its own, all together (they run
    on ``meta`` tensors and see no card).  Returns (processes, start
    time)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, argv in enumerate(DRYRUN_RUNS):
        log = open(Path(out_dir) / f"run{i}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
             "--out", str(out_dir)], stdout=log, stderr=subprocess.STDOUT,
            env=env, cwd=ROOT), log))
    return procs, time.perf_counter()


def phase_dryrun(procs, t0, out_dir):
    """``[dryrun]``: wait for ``start_dryrun``'s processes (each must
    exit 0 within ``DRYRUN_TIMEOUT_S``; the caller stops any left), then
    read every record: none has ``error``, the
    hubert-xlarge decode pairs are the reference's skip, every other
    pair has a parameter count, per-device argument bytes and counted
    FLOPs; each architecture's ``n_params`` and the phase's wall time
    are printed."""
    rcs = []
    for proc, _ in procs:
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
        try:
            rcs.append(proc.wait(timeout=max(left, 1)))
        except subprocess.TimeoutExpired:
            rcs.append("timeout")
    wall = time.perf_counter() - t0
    for i, rc in enumerate(rcs):
        if rc != 0:
            print((Path(out_dir) / f"run{i}.log").read_text()[-4000:])
        check(rc == 0, f"dryrun {' '.join(DRYRUN_RUNS[i])}: exit {rc}")
    recs = [json.loads(f.read_text())
            for f in sorted(Path(out_dir).glob("*.json"))]
    want = 2 * len(ARCH_IDS) + 2
    check(len(recs) == want, f"dryrun: {len(recs)} records, not {want}")
    n_params = {}
    for r in recs:
        what = f"dryrun {r['arch']} x {r['shape']} x {r['mesh']}"
        check("error" not in r, f"{what}: {r.get('error')}")
        if r["arch"] == "hubert-xlarge" and r["shape"] == "decode_32k":
            check(r.get("skipped") and r["reason"] ==
                  "encoder-only: no decode step", f"{what}: not skipped")
            continue
        check(not r.get("skipped"), f"{what}: skipped")
        check(r["step_cost"]["flops"] > 0 and
              r["memory"]["argument_size_in_bytes"] > 0, f"{what}: empty")
        n_params[r["arch"]] = r["n_params"]
        print(f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh_name']}: "
              f"{r['n_params']} parameters, "
              f"{r['memory']['argument_size_in_bytes']} argument bytes a "
              f"device, {r['step_cost']['flops']:.6e} FLOPs and "
              f"{r['step_cost']['bytes']:.6e} bytes a step (global), "
              f"count {r['timing']['count_s']:.1f} s")
    check(set(n_params) == set(ARCH_IDS) - {"hubert-xlarge"},
          f"dryrun: n_params for {sorted(n_params)}")
    for arch in ARCH_IDS:     # hubert-xlarge's pairs here are skips
        n = launch_dryrun.count_params(param_shapes(get_config(arch)))
        check(n_params.get(arch, n) == n, f"dryrun: {arch} n_params")
        print(f"[dryrun] n_params {arch}: {n}")
    print(f"[dryrun] {len(recs)} records, 0 errors; wall {wall:.1f} s "
          f"from the start of its {len(procs)} processes (they ran beside "
          f"[mesh], [dryrun-card] and [examples])")


def phase_dryrun_card(train_ms):
    """``[dryrun-card]``: minicpm-2b whole at ``[llm-train]``'s batch
    (``LLM_TRAIN_BATCH`` x ``LLM_TRAIN_SEQ``, remat): the cost model's
    FLOPs, counted on ``meta`` at cut depths and extrapolated, must
    equal ``FlopCounterMode`` over one real step on the card exactly,
    and the per-device argument bytes of a 1 x 1 host mesh the bytes of
    the state and batch on the card exactly.  Prints the achieved
    TFLOP/s: the counted FLOPs over ``[llm-train]``'s ms a step."""
    arch = LLM_TRAIN_ARCH
    cfg = get_config(arch)
    shape = InputShape("llm_train", LLM_TRAIN_SEQ, LLM_TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    meta = launch_dryrun.pair_cost(arch, cfg, shape)
    t_meta = time.perf_counter() - t0
    mesh = make_host_mesh()
    check(mesh.sizes == (1, 1), f"host mesh {mesh}")
    arg_bytes = launch_dryrun.argument_bytes(arch, cfg, shape, mesh)
    free_cuda()
    opt = launch_dryrun.opt_config(LLM_TRAIN_PARAMS)
    state = train_state_init(cfg, torch.Generator(device=DEV).manual_seed(
        SEED), opt, DEV)
    batch = next(iter(LMBatchIterator(cfg, LLM_TRAIN_BATCH, LLM_TRAIN_SEQ,
                                      device=DEV)))
    held = sum(t.numel() * t.element_size()
               for t in tree_leaves(state) + tree_leaves(batch))
    step = make_train_step(cfg, opt, make_schedule(
        "wsd", opt.peak_lr, LLM_TRAIN_STEPS), remat=True, donate=True)
    t0 = time.perf_counter()
    card = step_cost(step, state, batch)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    del state, batch
    free_cuda()
    print(f"[dryrun-card] {arch} whole, {LLM_TRAIN_BATCH} x "
          f"{LLM_TRAIN_SEQ}, remat: FLOPs counted on meta at cut depths "
          f"{meta['flops']} ({t_meta:.1f} s), over one step on the card "
          f"{card['flops']} ({t_card:.1f} s); argument bytes of a 1 x 1 "
          f"host mesh {arg_bytes}, on the card {held}")
    check(meta["flops"] == card["flops"],
          f"dryrun-card: meta FLOPs {meta['flops']} != card {card['flops']}")
    check(arg_bytes == held,
          f"dryrun-card: argument bytes {arg_bytes} != on the card {held}")
    print(f"[dryrun-card] achieved {meta['flops'] / train_ms / 1e9:.2f} "
          f"TFLOP/s: {meta['flops']} FLOPs over [llm-train]'s "
          f"{train_ms:.3f} ms a step; {gpu_line()}")


def phase_mesh():
    """``[mesh]``: ``make_serving_mesh(1)`` is ``("cuda:0",)``, one more
    shard than there are cards raises ``ValueError``, and qwen3-4b's
    smoke decode logits inside ``mesh_context(make_host_mesh())`` equal
    those outside it bit for bit."""
    check(make_serving_mesh(1) == ("cuda:0",),
          f"make_serving_mesh(1) = {make_serving_mesh(1)}")
    n = torch.cuda.device_count()
    try:
        make_serving_mesh(n + 1)
        raised = False
    except ValueError:
        raised = True
    check(raised, f"make_serving_mesh({n + 1}) did not raise")
    cfg = get_config("qwen3-4b", "smoke")
    params = init_model(cfg, torch.Generator(device=DEV).manual_seed(SEED),
                        device=DEV)
    step = make_decode_step(cfg)
    prefill = make_prefill_step(cfg, cache_len=32)
    toks = torch.arange(8, dtype=torch.int32, device=DEV)[None] + 3
    _, cache = prefill(params, {"tokens": toks})
    batch = {"tokens": toks[:, -1:], "cache": cache, "decode_pos": 8}
    want, _ = step(params, batch)
    mesh = make_host_mesh()
    with mesh_context(mesh):
        got, _ = step(params, batch)
    check(torch.equal(got, want), "[mesh] logits differ inside the mesh")
    print(f"[mesh] make_serving_mesh(1) = ('cuda:0',); "
          f"make_serving_mesh({n + 1}) raises ValueError; qwen3-4b smoke "
          f"decode logits {tuple(got.shape)} bit-equal inside "
          f"mesh_context({mesh.axis_names} {mesh.sizes}) and outside")


def run_quietly(main, argv):
    """``main(argv)`` with its standard output captured; returns what
    ``main`` returns."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def load_by_path(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples():
    """``[examples]``: each of ``EXAMPLES`` through its ``main`` on
    ``cuda`` (launches counted from zero over the four) and on ``cpu``:
    the reports it returns equal, discrete fields exactly (reports,
    drops, track ids, coverage, restarts), floats within
    ``EXAMPLE_RTOL`` + ``EXAMPLE_ATOL``.  Returns the launch counts."""
    mods = {name: load_by_path(ROOT / "examples" / name)
            for name in EXAMPLES}
    got, ms = {}, {}
    tpipe.clear_tick_graphs()
    ops.reset_launches()
    for name, mod in mods.items():
        t0 = time.perf_counter()
        got[name] = run_quietly(mod.main, ["--device", DEV])
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = ops.launches()
    graphs = tpipe.tick_graphs()
    ticks = sum((1 + g.replays) * g.captured.get("greedy_assign", 0)
                for g in graphs)
    for name, mod in mods.items():
        want = run_quietly(mod.main, ["--device", "cpu"])
        close_report(got[name], want, f"[examples] {name}", EXAMPLE_ATOL,
                     EXAMPLE_RTOL, nan_equal=True)
        print(f"[examples] {name}: cuda == cpu ({ms[name]:.0f} ms host "
              f"wall on cuda)")
    print(f"[examples] launches over the four on cuda: {launches}; "
          f"{len(graphs)} tick graphs, {sum(g.replays for g in graphs)} "
          f"replays")
    check(launches["batched_nms"] > 0 and launches["greedy_assign"] > 0,
          f"[examples] NMS or assignment never launched: {launches}")
    check(launches["greedy_assign"] == ticks,
          f"[examples] assignment launches {launches['greedy_assign']} != "
          f"warm-ups + replays x captured ({ticks})")
    return launches


def tf32_settings():
    """The legacy TF32 flags and, where this torch has them, the
    per-operation float32 precisions, as strings (a legacy flag that
    disagrees with the per-operation one raises when read)."""
    out = {}
    for name, obj, attr in (
            ("cudnn.allow_tf32", torch.backends.cudnn, "allow_tf32"),
            ("cudnn.conv.fp32_precision",
             getattr(torch.backends.cudnn, "conv", None), "fp32_precision"),
            ("cuda.matmul.allow_tf32", torch.backends.cuda.matmul,
             "allow_tf32"),
            ("cuda.matmul.fp32_precision", torch.backends.cuda.matmul,
             "fp32_precision")):
        try:
            out[name] = str(getattr(obj, attr))
        except (AttributeError, RuntimeError) as e:
            out[name] = f"unreadable ({type(e).__name__})"
    return out


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    print(f"[tf32] process-wide settings as found (left as they are; the "
          f"port holds its own convs and products in IEEE float32): "
          f"{tf32_settings()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    t_start = time.perf_counter()
    phase_build()
    check_mma_zero_identity()
    cfg = SSDConfig()
    params = init_ssd(cfg, torch.Generator().manual_seed(SEED), device=DEV)
    # the draws of init_ssd may change with the PyTorch version: this
    # checksum tells whether a CPU rehearsal served the same weights
    absw = [p["w"].abs().sum() for p in params["backbone"]] + [
        params[h]["w"].abs().sum() for h in ("head8", "head16")]
    print(f"[weights] init_ssd seed {SEED}: sum |w| "
          f"{float(torch.stack(absw).sum()):.6f}")
    anchors = torch.from_numpy(make_anchors(cfg)).to(DEV)
    frames, *_ = nvr_frames(4, 32, rate=RATE_FPS)
    entries = phase_kernels(params, cfg, anchors, frames)
    by_path = {"nvr": phase_serve(params, cfg, frames),
               "cascade": phase_cascade(params, cfg, frames)}
    phase_parity(params, cfg)
    by_path["seed_nms"], entries["iou_matrix"] = phase_seed_nms(
        params, cfg, anchors, frames)
    by_path["attention"], attn_entries = phase_attention(
        profile="--profile" in sys.argv[1:])
    entries.update(attn_entries)
    by_path["moe_experts"], entries["routed_experts"] = phase_moe_experts()
    by_path["mla_decode"], entries["mla_decode"] = phase_mla_decode()
    by_path["fused"] = phase_fused(params, cfg, frames,
                                   profile="--profile" in sys.argv[1:])
    by_path["parallel"] = phase_parallel()
    by_path["train"], trained = phase_train(
        cfg, anchors, profile="--profile" in sys.argv[1:])
    by_path["sharded"] = phase_sharded(trained, cfg)
    by_path["daemon"] = phase_daemon(trained, cfg)
    if "--profile" in sys.argv[1:]:
        phase_profile("nvr", nvr_engine(params, cfg), frames)
        phase_profile("cascade", cascade_engine(params, cfg, DEV), frames)
        phase_profile("sharded-2", sharded_engine(trained, cfg, DEV,
                                                  n_shards=2),
                      nvr_frames(SHARD_CAMS, SHARD_FRAMES, RATE_FPS)[0])
    phase_nan()
    phase_llm(profile="--profile" in sys.argv[1:])
    for arch in FAMILY_CUTS:
        _, launches = phase_family(arch, profile="--profile" in sys.argv[1:])
        if launches is not None:
            by_path["rwkv_model"] = launches
    phase_families_smoke_f32()
    ops.reset_launches()
    train = phase_llm_train(profile="--profile" in sys.argv[1:])
    deterministic = phase_llm_train_f32()
    phase_train_smoke()
    phase_train_ckpt(deterministic)
    torch.cuda.synchronize()
    by_path["training"] = ops.launches()
    check(not any(by_path["training"].values()),
          f"the training phases launched a kernel: {by_path['training']}")
    with tempfile.TemporaryDirectory() as dry_dir:
        procs, t_dry = start_dryrun(dry_dir)
        try:
            phase_mesh()
            phase_dryrun_card(train["ms"])
            by_path["examples"] = phase_examples()
            phase_dryrun(procs, t_dry, dry_dir)
        finally:
            for proc, log in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
    for k, e in entries.items():
        e["launches_by_path"] = {p: n[k] for p, n in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        check(e["launches"] > 0, f"{k} was never launched on a main path")
    check(len(entries) == 10, f"kernels line has {len(entries)} entries")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
