"""The port's last four examples at ``--device cpu`` print the reference
examples' lines, on the CPU.

``quickstart_torch.py``, ``nvr_serving_torch.py``,
``sharded_serving_torch.py`` and ``fault_tolerant_serving_torch.py``
run in this process beside ``quickstart.py``, ``nvr_serving.py``,
``sharded_serving.py`` and ``fault_tolerant_serving.py``; every printed
line is equal.  The reference's sharded example forces four fake host
devices for its last leg, and under the installed jax that leg raises
(its ``with_sharding_constraint`` refuses the explicit axes of
``jax.make_mesh``; ``ROADMAP.md`` section 3).  So the lines before that
leg are held against the reference's, and the leg itself, the port's
mini-SSD over a one-device serving mesh, against the port's meshless
run on the same frames, bit for bit (as ``tests/test_torch_sharded.py``
holds its mesh runs).
"""
import importlib.util
import runpy
from pathlib import Path

import numpy as np
import pytest

from test_torch_serving import assert_reports_match

from repro_torch.serving import FrameRequest, ShardedDetectionEngine

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SPMD_LEG = "== SPMD mesh leg"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_lines(name, monkeypatch, capsys):
    """The reference example's printed lines, run as ``__main__`` (the
    environment it changes restored after the test); an error raised
    after its last line is returned beside them."""
    monkeypatch.setenv("XLA_FLAGS", "")
    monkeypatch.setattr("sys.argv", [name])
    raised = None
    try:
        runpy.run_path(str(EXAMPLES / name), run_name="__main__")
    except ValueError as e:
        raised = e
    return capsys.readouterr().out.splitlines(), raised


@pytest.mark.parametrize("name", ["quickstart", "nvr_serving",
                                  "fault_tolerant_serving"])
def test_example_prints_the_reference_lines(name, monkeypatch, capsys):
    want, raised = _reference_lines(f"{name}.py", monkeypatch, capsys)
    assert raised is None
    _load(f"{name}_torch.py").main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == want


def test_sharded_example_prints_the_reference_lines(monkeypatch, capsys):
    want, raised = _reference_lines("sharded_serving.py", monkeypatch,
                                    capsys)
    results = _load("sharded_serving_torch.py").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    leg = next(i for i, line in enumerate(got) if line.startswith(SPMD_LEG))
    assert got[:leg] == want[:leg]
    if raised is None:
        assert got == want
    else:
        assert len(want) == leg and "with_sharding_constraint" in str(raised)
    assert got[leg:] == [
        f"{SPMD_LEG}: one compiled detect+NMS program over 1 devices ==",
        "  1 cameras / 1 shards, coverage=1.00, 8 mini-SSD responses"]
    # the mesh leg against the meshless engine on the same frames
    rng = np.random.default_rng(0)
    frames = [FrameRequest(i, rng.random((64, 64, 3)).astype(np.float32),
                           i / 40.0, stream_id=0) for i in range(8)]
    meshless = ShardedDetectionEngine(n_shards=1, n_replicas=2,
                                      service_time=0.05,
                                      track_and_interpolate=True,
                                      device="cpu").serve(frames)
    assert_reports_match(meshless, results["spmd"])


@pytest.mark.parametrize("name", ["quickstart", "nvr_serving",
                                  "sharded_serving",
                                  "fault_tolerant_serving"])
def test_example_returns_what_it_printed_from(name, capsys):
    """Each port example's ``main`` returns its reports, which chip_smoke
    holds cuda against cpu; two runs on the CPU give equal ones."""
    main = _load(f"{name}_torch.py").main
    a, b = main(["--device", "cpu"]), main(["--device", "cpu"])
    capsys.readouterr()
    assert a.keys() == b.keys() and a
    assert repr(a) == repr(b)
