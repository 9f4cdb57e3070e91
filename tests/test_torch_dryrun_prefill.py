"""The dry run's prefill pair on the CPU: minicpm-2b x prefill_32k
(B=32, S=32768) at full width on ``meta`` tensors, on both production
meshes, its fields and argument bytes held as ``test_torch_dryrun.py``
holds the train and decode pairs.  Its own file: counting the chunked
attention's 2048 tiles a layer at two cut depths takes about a minute
on one core."""
import json

from test_torch_dryrun import MESH, _ref_argument_bytes

from repro_torch.launch import dryrun


def test_prefill_pair_records_match_the_reference(tmp_path):
    arch, shape, cache = "minicpm-2b", "prefill_32k", {}
    for mesh in ("single", "multi"):
        rec = dryrun.run_pair(arch, shape, mesh == "multi", tmp_path, cache)
        assert rec == json.loads(
            (tmp_path / f"{arch}__{shape}__{mesh}.json").read_text())
        assert "error" not in rec, rec.get("traceback")
        n, arg_bytes = _ref_argument_bytes(arch, shape, MESH[mesh])
        assert rec["n_params"] == n
        assert rec["memory"]["argument_size_in_bytes"] == arg_bytes
        assert rec["mesh"] == MESH[mesh] and rec["kind"] == "prefill"
        assert rec["step_cost"]["flops"] > 0
    assert rec["step_cost"] == cache[(arch, shape)]
