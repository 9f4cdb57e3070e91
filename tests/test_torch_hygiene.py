"""Rules of the port that a parity test would not catch: it imports
neither JAX nor the reference package, its entry points never fall back
to the CPU by themselves, and its kernel wrappers never send a non-CPU
tensor to the plain version."""
import ast
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "check_trace_torch.py",
    REPO / "examples" / "video_analytics_torch.py",
    REPO / "examples" / "llm_serving_torch.py",
    REPO / "examples" / "quickstart_torch.py",
    REPO / "examples" / "nvr_serving_torch.py",
    REPO / "examples" / "sharded_serving_torch.py",
    REPO / "examples" / "fault_tolerant_serving_torch.py"]
NEW_EXAMPLES = ["quickstart_torch.py", "nvr_serving_torch.py",
                "sharded_serving_torch.py",
                "fault_tolerant_serving_torch.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_serving_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.serving, repro_torch.kernels.ops, "
            "repro_torch.detector, repro_torch.tracking, "
            "repro_torch.kernels.iou, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.kernels.rwkv_scan, repro_torch.kernels.ref, "
            "repro_torch.core.parallel, repro_torch.tracking.interpolate, "
            "repro_torch.sharding, repro_torch.sharding.serving_rules, "
            "repro_torch.serving.faults, repro_torch.serving.supervisor, "
            "repro_torch.serving.sharded, repro_torch.serving.events, "
            "repro_torch.obs.audit, repro_torch.obs.export, "
            "repro_torch.launch.daemon, repro_torch.launch.serve, "
            "repro_torch.models, repro_torch.models.attention, "
            "repro_torch.models.moe, repro_torch.models.mamba, "
            "repro_torch.models.rwkv, "
            "repro_torch.configs, repro_torch.runtime, "
            "repro_torch.runtime.steps, repro_torch.runtime.specs, "
            "repro_torch.runtime.checkpoint, repro_torch.data, "
            "repro_torch.optim, repro_torch.launch.train, "
            "repro_torch.sharding.context, repro_torch.sharding.rules, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.cost, runpy; "
            "[repro_torch.configs.get_config(a, preset='smoke') "
            "for a in repro_torch.configs.ARCH_IDS]; "
            "runpy.run_path(sys.argv[1]); "
            "assert 'jax' not in {m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None}; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code,
                          str(REPO / "tools" / "check_trace_torch.py")],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_detection_engine_without_cuda_raises(monkeypatch):
    from repro_torch.serving import DetectionEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionEngine(device="cuda")
    assert DetectionEngine(device="cpu").device.type == "cpu"


def test_parallel_pipeline_without_cuda_raises(monkeypatch):
    """``ParallelDetector`` and ``fill_stream`` keep their track table on
    ``cuda`` unless the caller passes ``device="cpu"``."""
    from repro_torch.core import FrameStream, ParallelDetector, simulate
    from repro_torch.tracking import fill_stream
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"], device="cuda")
    det = ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"], device="cpu")
    assert det.device.type == "cpu"
    paced = simulate(FrameStream(det.video), det.scheduler)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fill_stream(det.video, paced, det.detector)
    assert len(fill_stream(det.video, paced, det.detector,
                           device="cpu")) == paced.n_frames


def test_sharded_engine_and_mesh_detect_without_cuda_raise(monkeypatch):
    """``ShardedDetectionEngine`` places its shards' trackers (and the
    detector) on ``cuda`` unless told otherwise, and a mesh entry of
    None or ``cuda`` means the card: without one, each raises."""
    from repro_torch.core import proxy_detect_fn_streams
    from repro_torch.detector import SSDConfig, init_ssd
    from repro_torch.serving import (ShardedDetectionEngine,
                                     make_nvr_streams, make_spmd_detect)
    f, fo, v, d = make_nvr_streams(2, 2, rate=1.0)
    oracle = proxy_detect_fn_streams(v, d, fo)
    cfg = SSDConfig()
    params = init_ssd(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}, {"detect_fn": oracle},
               {"mesh": ("cpu",), "params": params}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedDetectionEngine(n_shards=2, **kw)
    for mesh in ((None,), ("cuda",), ("cpu", "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_spmd_detect(cfg, params, mesh)
    eng = ShardedDetectionEngine(n_shards=2, detect_fn=oracle, device="cpu")
    assert {e.device.type for e in eng.engines} == {"cpu"}
    make_spmd_detect(cfg, params, ("cpu",))


def test_train_detector_without_cuda_raises(monkeypatch):
    """The example's training loop runs on ``cuda`` unless the caller
    passes ``device="cpu"``."""
    import importlib.util
    from repro_torch.core import SyntheticVideo
    from repro_torch.core.stream import ETH_SUNNYDAY
    spec = importlib.util.spec_from_file_location(
        "video_analytics_torch", REPO / "examples" / "video_analytics_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    video = SyntheticVideo(ETH_SUNNYDAY)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ex.train_detector(video, 1, batch=1, **kw)
    _, params, _ = ex.train_detector(video, 1, batch=1, device="cpu",
                                     log=lambda s: None)
    assert params["head8"]["w"].device.type == "cpu"


def test_serving_and_obs_export_every_reference_name():
    """The port's ``serving`` and ``obs`` packages export every name the
    reference's do (``roi_second_pass`` included), less the names
    ``ROADMAP.md`` lists as waiting: none is left."""
    import repro.obs
    import repro.serving
    import repro_torch.obs
    import repro_torch.serving
    waiting = set()
    for ref, port in ((repro.serving, repro_torch.serving),
                      (repro.obs, repro_torch.obs)):
        assert set(ref.__all__) - set(port.__all__) == waiting
        assert all(hasattr(port, name) for name in port.__all__)


def test_token_serving_without_cuda_raises(monkeypatch):
    """``ServingEngine``, ``init_model``, ``init_cache`` and
    ``params_from_numpy`` place the model on ``cuda`` unless the caller
    passes ``device="cpu"``."""
    from repro_torch.configs import get_config
    from repro_torch.device import params_to
    from repro_torch.models import init_cache, init_model
    from repro_torch.models import params_from_numpy as llm_from_numpy
    from repro_torch.serving import ServingEngine
    cfg = get_config("qwen3-4b", preset="smoke").replace(
        stages=get_config("qwen3-4b", preset="smoke").stages[:1])
    gen = torch.Generator().manual_seed(0)
    params = init_model(cfg, gen, device="cpu")
    tree = _to_numpy(params)
    tree["stages"] = [{"layers": [_stack(s["layers"])]}
                      for s in tree["stages"]]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: ServingEngine(cfg, params=params, **kw),
                 lambda **kw: ServingEngine(cfg, **kw),
                 lambda **kw: init_model(cfg, gen, **kw),
                 lambda **kw: init_cache(cfg, 1, 8, **kw),
                 lambda **kw: llm_from_numpy(cfg, tree, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(device="cuda")
    assert ServingEngine(cfg, params=params,
                         device="cpu").device.type == "cpu"
    assert params_to(llm_from_numpy(cfg, tree, device="cpu"),
                     "cpu")["embed"]["table"].device.type == "cpu"


def _to_numpy_state(state):
    """A port train state as the reference's numpy tree (stages
    stacked on their repeats axis)."""
    def tree(p):
        t = _to_numpy(p)
        t["stages"] = [{"layers": [_stack(s["layers"])]}
                       for s in t["stages"]]
        return t
    return {"params": tree(state["params"]),
            "opt": {"m": tree(state["opt"]["m"]),
                    "v": tree(state["opt"]["v"]),
                    "step": state["opt"]["step"].numpy()}}


def _to_numpy(p):
    if isinstance(p, dict):
        return {k: _to_numpy(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_to_numpy(v) for v in p]
    return p.numpy()


def _stack(layers):
    """Per-layer dicts stacked on a leading repeats axis, as the
    reference's stages hold them."""
    if isinstance(layers[0], dict):
        return {k: _stack([d[k] for d in layers]) for k in layers[0]}
    return np.stack(layers)


@pytest.mark.parametrize("argv", [
    ["daemon", "--cameras", "2", "--frames", "2"],
    ["serve", "--payload", "frames", "--cameras", "2", "--frames", "2"],
    ["serve", "--payload", "frames", "--cameras", "2", "--frames", "2",
     "--spmd"],
    ["serve", "--payload", "tokens", "--requests", "1", "--new-tokens", "1"],
    ["train", "--steps", "1", "--batch", "1", "--seq", "8"],
], ids=["daemon", "serve-frames", "serve-frames-spmd", "serve-tokens",
        "train"])
def test_launchers_default_to_cuda(monkeypatch, capsys, argv):
    """``python -m repro_torch.launch.daemon``, ``.serve`` and ``.train``
    run on ``cuda`` unless given ``--device cpu``: without CUDA they
    raise."""
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{argv[0]}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(argv[1:] + extra)
    mod.main(argv[1:] + ["--device", "cpu"])
    assert capsys.readouterr().out


def _restore_probe(**kw):
    """The device ``restore_checkpoint`` puts a saved leaf on."""
    from repro_torch.runtime.checkpoint import (restore_checkpoint,
                                                save_checkpoint)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(Path(tmp) / "ck", {"w": torch.zeros(2)})
        return restore_checkpoint(Path(tmp) / "ck", {"w": torch.ones(2)},
                                  **kw)["w"].device


def _entry_points():
    from repro_torch.detector import SSDConfig, init_ssd, params_from_numpy
    from repro_torch.serving import TickPipeline
    from repro_torch.serving.pipeline import build_tracker_state
    from repro_torch.tracking import TrackerConfig, init_state, rows_to_state
    from repro_torch.tracking.kalman import init_cov
    cfg = TrackerConfig(capacity=4)
    w = torch.zeros((1, 1, 1, 1)).numpy()
    tree = {"backbone": [{"w": w, "b": w[0, 0, 0]}],
            "head8": {"w": w, "b": w[0, 0, 0]},
            "head16": {"w": w, "b": w[0, 0, 0]}}
    from repro_torch.configs import get_config
    from repro_torch.data import LMBatchIterator, make_modality_batch
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import concrete_batch, train_state_init
    from repro_torch.configs.base import InputShape
    from repro_torch.models import train_state_from_numpy
    llm = get_config("minicpm-2b", preset="smoke")
    llm1 = llm.replace(stages=llm.stages[:1])
    audio = get_config("hubert-xlarge", preset="smoke")
    from repro_torch.launch.mesh import (make_host_mesh, make_replica_mesh,
                                         make_serving_mesh)
    return {
        "make_host_mesh": lambda **kw: make_host_mesh(**kw).devices[0],
        "make_replica_mesh": lambda **kw: make_replica_mesh(
            1, **kw).devices[0],
        "make_serving_mesh": lambda **kw: torch.device(
            make_serving_mesh(1, **kw)[0]),
        "train_state_init": lambda **kw: train_state_init(
            llm, torch.Generator().manual_seed(0), AdamWConfig(),
            **kw)["opt"]["m"]["embed"]["table"].device,
        "LMBatchIterator": lambda **kw: next(iter(LMBatchIterator(
            llm, 1, 8, **kw)))["tokens"].device,
        "make_modality_batch": lambda **kw: make_modality_batch(
            audio, 1, 8, **kw)["features"].device,
        "concrete_batch": lambda **kw: concrete_batch(
            llm, InputShape("t", 8, 1, "train"), **kw)["tokens"].device,
        "restore_checkpoint": _restore_probe,
        "TickPipeline": lambda **kw: TickPipeline(cfg, **kw).device,
        "train_state_from_numpy": lambda **kw: train_state_from_numpy(
            llm1, _to_numpy_state(train_state_init(
                llm1, torch.Generator().manual_seed(0), AdamWConfig(),
                device="cpu")), **kw)["opt"]["step"].device,
        "build_tracker_state": lambda **kw: build_tracker_state(
            None, [0, 1], cfg, **kw).active.device,
        "init_state": lambda **kw: init_state(2, cfg, **kw).active.device,
        "rows_to_state": lambda **kw: rows_to_state(
            [None], cfg, **kw).active.device,
        "init_cov": lambda **kw: init_cov((2, 3, 4), 9.0, 25.0,
                                          **kw).device,
        "init_ssd": lambda **kw: init_ssd(
            SSDConfig(channels=(4, 4)), torch.Generator().manual_seed(0),
            **kw)["head8"]["w"].device,
        "params_from_numpy": lambda **kw: params_from_numpy(
            tree, **kw)["head8"]["w"].device,
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda(monkeypatch, name):
    """Every entry point that places tensors runs on ``cuda`` unless the
    caller passes ``device="cpu"``; without CUDA the default raises."""
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert make(device="cpu").type == "cpu"


@pytest.mark.parametrize("name", NEW_EXAMPLES)
def test_examples_default_to_cuda(monkeypatch, capsys, name):
    """The four examples ported last run on ``cuda`` unless given
    ``--device cpu``: without CUDA they raise."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(extra)


def _nms_args(device):
    return (torch.zeros((2, 40, 4), device=device),
            torch.zeros((2, 40), device=device))


def _assign_args(device):
    return (torch.zeros((2, 6, 4), device=device),
            torch.zeros((2, 5, 4), device=device))


def _crop_args(device):
    return (torch.zeros((2, 16, 16, 3), device=device),
            torch.zeros((2, 4, 4), device=device))


def _uncrop_args(device):
    return (torch.zeros((2, 4, 32, 4), device=device),
            torch.zeros((2, 4, 1, 4), device=device))


def _iou_args(device):
    return (torch.zeros((5, 4), device=device),
            torch.zeros((3, 4), device=device))


def _flash_args(device):
    return tuple(torch.zeros((1, 2, 128, 32), device=device)
                 for _ in range(3))


def _decode_args(device):
    return (torch.zeros((2, 4, 32), device=device),
            torch.zeros((2, 64, 2, 32), device=device),
            torch.zeros((2, 64, 2, 32), device=device))


def _rwkv_args(device):
    x = torch.zeros((1, 2, 16, 8), device=device)
    return (x, x, x, x, torch.zeros((2, 8), device=device),
            torch.zeros((1, 2, 8, 8), device=device))


def _routed_args(device):
    return (torch.zeros((2, 4, 8), device=device),
            torch.zeros((8,), device=device),
            torch.zeros((2, 8, 16), device=device),
            torch.zeros((2, 8, 16), device=device),
            torch.zeros((2, 16, 8), device=device))


def _mla_args(device):
    z = lambda *shape: torch.zeros(  # noqa: E731
        shape, dtype=torch.bfloat16, device=device)
    return (z(1, 1, 4, 32), z(1, 1, 4, 16), z(1, 24, 64), z(1, 24, 16),
            z(64, 4, 32), z(64, 4, 32), 5)


NEW_CALLS = {"iou_matrix": (_iou_args, {}),
             "flash_attention": (_flash_args, {}),
             "decode_attention": (_decode_args, {}),
             "rwkv_scan": (_rwkv_args, {}),
             "nms_serial": (lambda d: (torch.zeros((6, 4), device=d),
                                       torch.zeros((6,), device=d)),
                            {"max_out": 4})}


def _call(kernel, device):
    """One call of ``ops.<kernel>`` on small tensors on ``device``."""
    if kernel == "routed_experts":
        return ops.routed_expert_ffn(*_routed_args(device))
    if kernel == "mla_decode":
        return ops.mla_decode(*_mla_args(device), scale=0.25)
    if kernel in NEW_CALLS:
        make, kw = NEW_CALLS[kernel]
        return getattr(ops, kernel)(*make(device), **kw)
    if kernel == "batched_nms":
        return ops.batched_nms(*_nms_args(device), score_thr=0.4)
    if kernel == "greedy_assign":
        return ops.greedy_assign(*_assign_args(device))
    if kernel == "crop_resize":
        return ops.crop_resize(*_crop_args(device), out_size=8)
    return ops.uncrop_boxes(*_uncrop_args(device), bounds=(1.0, 1.0),
                            crop_size=64)


KERNELS = ["batched_nms", "greedy_assign", "crop_resize", "uncrop_boxes",
           "iou_matrix", "flash_attention", "decode_attention", "rwkv_scan",
           "routed_experts", "mla_decode"]
PLAIN = ["batched_nms_torch", "greedy_assign_torch", "crop_resize_torch",
         "uncrop_boxes_torch", "iou_matrix_torch", "flash_attention_torch",
         "decode_attention_torch", "rwkv_scan_torch",
         "routed_expert_ffn_torch", "mla_decode_torch"]


@pytest.mark.parametrize("kernel", KERNELS + ["nms_serial"])
def test_wrappers_raise_when_library_missing(monkeypatch, kernel):
    """A non-CPU tensor goes to the kernel's wrapper and never to the
    plain version: with the library loader failing, the call raises and
    no launch is counted.  (A meta tensor stands in for a CUDA tensor.)"""
    def missing(*a, **k):
        raise build.KernelBuildError("kernel library missing")

    def plain(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(build, "function", missing)
    for name in PLAIN:
        monkeypatch.setattr(ops, name, plain)
    before = ops.launches()
    with pytest.raises(build.KernelBuildError):
        _call(kernel, "meta")
    assert ops.launches() == before


@pytest.mark.parametrize("kernel", ["crop_resize", "uncrop_boxes"])
def test_roi_wrappers_refuse_non_cuda_tensors(monkeypatch, kernel):
    """With the library loaded, a tensor that is neither on the CPU nor
    on a CUDA device (meta) reaches the CUDA wrapper, which raises
    before launching: no launch, no plain version, no count."""
    launched = []

    def loader(*a, **k):
        return lambda *args: launched.append(args) or 0

    def plain(*a, **k):
        raise AssertionError("plain version called for a meta tensor")

    monkeypatch.setattr(build, "function", loader)
    for name in PLAIN:
        monkeypatch.setattr(ops, name, plain)
    before = ops.launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _call(kernel, "meta")
    assert not launched and ops.launches() == before


def test_reset_launches_zeroes_every_counter(monkeypatch):
    from repro_torch.kernels import (association, decode_attention,
                                     flash_attention, iou, mla_decode, nms,
                                     roi, routed_experts, rwkv_scan)
    for mod, attr in ((nms, "LAUNCHES"), (association, "LAUNCHES"),
                      (roi, "CROP_LAUNCHES"), (roi, "UNCROP_LAUNCHES"),
                      (iou, "LAUNCHES"), (flash_attention, "LAUNCHES"),
                      (decode_attention, "LAUNCHES"),
                      (rwkv_scan, "LAUNCHES"),
                      (routed_experts, "LAUNCHES"),
                      (mla_decode, "LAUNCHES")):
        monkeypatch.setattr(mod, attr, 7)
    assert set(ops.launches()) == set(KERNELS)
    assert set(ops.launches().values()) == {7}
    ops.reset_launches()
    assert ops.launches() == {k: 0 for k in KERNELS}


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Where no nvcc exists the build raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        ops.batched_nms(*_nms_args("meta"))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel loader")

    monkeypatch.setattr(build, "function", no_build)
    before = ops.launches()
    keep, valid = ops.batched_nms(*_nms_args("cpu"))
    match = ops.greedy_assign(*_assign_args("cpu"))
    crops = _call("crop_resize", "cpu")
    boxes = _call("uncrop_boxes", "cpu")
    assert keep.shape == (2, 64) and valid.shape == (2, 64)
    assert match.shape == (2, 6)
    assert crops.shape == (2, 4, 8, 8, 3) and boxes.shape == (2, 4, 32, 4)
    assert _call("iou_matrix", "cpu").shape == (5, 3)
    assert _call("flash_attention", "cpu").shape == (1, 2, 128, 32)
    assert _call("decode_attention", "cpu").shape == (2, 4, 32)
    out, state = _call("rwkv_scan", "cpu")
    assert out.shape == (1, 2, 16, 8) and state.shape == (1, 2, 8, 8)
    assert _call("routed_experts", "cpu").shape == (2, 4, 8)
    assert _call("mla_decode", "cpu").shape == (1, 1, 4, 32)
    keep, valid = _call("nms_serial", "cpu")
    assert keep.shape == (4,) and valid.shape == (4,)
    assert ops.launches() == before


def test_library_names_track_source_and_flags():
    p = build.library_path("nms")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    for name in ("nms", "association", "roi", "iou", "rwkv_scan"):
        assert "-fmad=false" in build.flags(name), name
    for name in build.SOURCES:
        assert "--use_fast_math" not in build.flags(name), name
        assert any("sm_90a" in f for f in build.flags(name)), name
    assert (build.CSRC / "nms.cu").is_file()
    assert (build.CSRC / "association.cu").is_file()
    assert "roi" in build.SOURCES and (build.CSRC / "roi.cu").is_file()
    assert set(build.SOURCES) >= {"iou", "flash_attention",
                                  "decode_attention", "rwkv_scan"}
    assert all((build.CSRC / f"{n}.cu").is_file() for n in build.SOURCES)


WRAPPERS = {"iou_matrix_cuda": ("iou", _iou_args, {}),
            "flash_attention_cuda": ("flash_attention", _flash_args, {}),
            "decode_attention_cuda": ("decode_attention", _decode_args, {}),
            "rwkv_scan_cuda": ("rwkv_scan", _rwkv_args, {}),
            "routed_expert_ffn_cuda": ("routed_experts", _routed_args, {}),
            "mla_decode_cuda": ("mla_decode", _mla_args, {"scale": 0.25})}


@pytest.mark.parametrize("name", build.SOURCES)
def test_each_kernel_source_opens_with_its_note(name):
    """Every hand-written kernel's source opens with the note the port
    keeps beside each kernel: the TPU kernel it replaces, or that it
    replaces none and why, and what bounds it on the card; and its
    wrapper module counts its launches in a counter ``ops.launches``
    reads."""
    import importlib
    head = (build.CSRC / f"{name}.cu").read_text().split("#include")[0]
    assert "Replaces" in head or "replaces" in head, name
    assert "Replaces no TPU kernel" in head or "JAX package's" in head, name
    assert "Bound on the card" in head, name
    counters = {m.__name__.rsplit(".", 1)[-1] for m, _ in
                ops._COUNTERS.values()}
    assert name in counters, name
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    assert any(a.endswith("LAUNCHES") for a in vars(mod)), name


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_new_cuda_wrappers_refuse_non_cuda_tensors(monkeypatch, wrapper,
                                                   device):
    """With the library loaded, each new CUDA wrapper called on CPU (or
    meta) tensors raises before launching: nothing launched, nothing
    counted, no plain version."""
    import importlib
    module, make, kw = WRAPPERS[wrapper]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    launched = []

    def loader(*a, **k):
        return lambda *args: launched.append(args) or 0

    monkeypatch.setattr(build, "function", loader)
    before = ops.launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(mod, wrapper)(*make(device), **kw)
    assert not launched and ops.launches() == before


def test_library_names_track_each_sources_flags(monkeypatch):
    """Changing one source's flags renames that source's library and no
    other's."""
    before = {n: build.library_path(n) for n in build.SOURCES}
    base = build.flags
    monkeypatch.setattr(build, "flags", lambda n: base(n) + (
        ("-lineinfo",) if n == "decode_attention" else ()))
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert [n for n in build.SOURCES if after[n] != before[n]] == [
        "decode_attention"]


def test_library_names_track_shared_headers(monkeypatch, tmp_path):
    """Editing a shared ``csrc/*.cuh`` header renames every library, so
    no library built against the old header loads."""
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("a")
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build.library_path("a") != before
    assert (build.CSRC / "a.cu").is_file()
    assert (REPO / "src/repro_torch/kernels/csrc/common.cuh").is_file()


def test_train_launcher_prints_reference_lines(monkeypatch, capsys,
                                               tmp_path):
    """``python -m repro_torch.launch.train --device cpu --preset smoke
    --steps 6 --checkpoint <tmp>`` prints the reference launcher's lines:
    the same steps logged with the same learning rates, finite losses
    and norms, the timing line and the round trip's line; the checkpoint
    holds the step count and, outside the stages (per-layer lists here,
    stacked in the reference), the reference's keys."""
    import re
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    from repro_torch.runtime.checkpoint import checkpoint_step
    argv = ["--preset", "smoke", "--steps", "6"]
    ttrain.main(argv + ["--device", "cpu", "--checkpoint",
                        str(tmp_path / "port")])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--checkpoint", str(tmp_path / "ref")])
    jtrain.main()
    want = capsys.readouterr().out.splitlines()
    step = re.compile(r"step +(\d+) loss=(\S+) ce=(\S+) lr=(\S+) "
                      r"gnorm=(\S+)$")
    rows = [[step.match(line) for line in out[:-2]] for out in (got, want)]
    assert all(rows[0]) and all(rows[1]) and len(rows[0]) == len(rows[1])
    for g, w in zip(*rows):
        assert g[1] == w[1] and g[4] == w[4]          # step, lr
        assert all(np.isfinite(float(g[i])) for i in (2, 3, 5))
    assert re.fullmatch(r"6 steps in \d+\.\ds \(\d+ tok/s\)", got[-2])
    assert got[-1] == f"checkpoint round-trip OK -> {tmp_path / 'port'}"
    assert checkpoint_step(tmp_path / "port") == 6
    keys = [{k for k in json.loads((tmp_path / d / "manifest.json")
                                   .read_text())["keys"]
             if "['stages']" not in k} for d in ("port", "ref")]
    assert keys[0] == keys[1] and "['opt']['step']" in keys[0]
