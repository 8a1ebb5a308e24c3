"""``run_cell`` on the smoke config of each family x prefill / decode
(the train cells are in ``test_torch_dryrun_train_cells.py``, so that the
two files run in parallel), on a (2, 4) fake mesh: every cell ends ``ok``
with the record's keys, and moves bytes between ranks where its step is
sharded."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.sharding import AbstractMesh  # noqa: E402

FAMILIES = ["codeqwen15_7b", "mamba2_1_3b", "zamba2_2_7b",
            "granite_moe_3b_a800m", "whisper_large_v3"]
KEYS = {"arch", "shape", "mesh", "variant", "family", "kind", "params",
        "active_params", "chips", "decisions", "arg_bytes_per_device",
        "trace_s", "memory", "cost_pass_s", "cost", "collectives",
        "roofline", "status", "torch", "reshards"}
MESH = AbstractMesh((2, 4), ("data", "model"))


def check_smoke_cell(arch, shape, tmp_path):
    cfg = get_smoke_config(arch)
    rec = TD.run_cell(arch, shape, False, tmp_path, verbose=False, cfg=cfg,
                      mesh_axes=MESH)
    assert rec["status"] == "ok", rec.get("traceback")
    assert KEYS <= set(rec), KEYS - set(rec)
    assert not {"compile_s", "lower_s", "generated_code_size_in_bytes"} & \
        (set(rec) | set(rec["memory"]))
    assert rec["chips"] == 8
    assert rec["family"] == cfg.family
    if shape == "train_4k":
        assert rec["num_microbatches"] == TD.NUM_MICROBATCHES
    mem = rec["memory"]
    assert mem["arg_bytes_per_device"] == rec["arg_bytes_per_device"] > 0
    assert mem["per_device_bytes"] == \
        mem["arg_bytes_per_device"] + mem["peak_temp_bytes_per_device"]
    assert mem["peak_temp_bytes_per_device"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    coll = rec["collectives"]
    assert set(coll) == {"all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute", "total"}
    assert coll["total"] > 0                 # the step is sharded
    r = rec["roofline"]
    assert r["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert r["model_flops"] > 0
    written = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                         .read_text())
    assert written["status"] == "ok"


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_smoke_cell_ends_ok(arch, shape, tmp_path):
    check_smoke_cell(arch, shape, tmp_path)


def test_unsupported_cell_is_skipped(tmp_path):
    rec = TD.run_cell("codeqwen15_7b", "long_500k", False, tmp_path,
                      verbose=False, cfg=get_smoke_config("codeqwen15_7b"),
                      mesh_axes=MESH)
    assert rec["status"] == "skipped"
    assert "sub-quadratic" in rec["skip_reason"]


def test_a_failing_cell_is_recorded_not_raised(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(TD, "trace_cell", boom)
    rec = TD.run_cell("mamba2_1_3b", "decode_32k", False, tmp_path,
                      verbose=False, cfg=get_smoke_config("mamba2_1_3b"),
                      mesh_axes=MESH)
    assert rec["status"] == "error"
    assert rec["error"] == "RuntimeError: boom"
    assert "Traceback" in rec["traceback"]
    import torch.distributed as dist
    assert not dist.is_initialized()         # the group was closed


def split_view_reshards() -> list:
    """The view that granite's decode MoE buffer once took on the (16, 16)
    mesh, run under ``Reshard``: 1,024 token rows sharded over all 256
    ranks, split into 128 tokens x top-8, fewer tokens than ranks."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import fake_process_group, make_mesh
    with fake_process_group(256):
        mesh = make_mesh((16, 16), ("data", "model"))
        buf = DTensor.from_local(
            torch.empty((4, 32), device="meta"), mesh, [Shard(0), Shard(0)],
            run_check=False, shape=torch.Size((1024, 32)), stride=(32, 1))
        reshard = TD.Reshard()
        with reshard:
            out = buf.view(128, 8, 32)
        assert tuple(out.shape) == (128, 8, 32)
        return reshard.record()


@pytest.mark.parametrize("case", ["gqa_named", "moe_split"])
def test_a_refused_view_is_resharded_and_recorded(case, tmp_path):
    """DTensor refuses a view that GSPMD reshards, ``Reshard`` replicates
    the shards its rule picks, and the record lists the reshard.
    ``gqa_named``: query heads sharded 2 a rank over the model axis, split
    into 2 KV groups that its 4 ranks do not divide (grok's 48 heads into
    8 groups on 16 ranks); the error names the dim (the mesh dim in torch
    2.13, the tensor dim in 2.11).  ``moe_split``:
    a token dim sharded over both axes of the (16, 16) mesh, split into
    (tokens, top-k) with fewer tokens than ranks; the error names no dim,
    so the view's innermost sharded mesh dim is replicated and the data
    axis keeps its shard.  granite's decode cell on that mesh, whose MoE
    combine took such a view until its gather became ``torch.gather``,
    ends ok without replicating every shard."""
    if case == "gqa_named":
        arch, mesh, rule = "grok_1_314b", MESH, "named"
        cfg = dataclasses.replace(get_smoke_config(arch), num_heads=8,
                                  num_kv_heads=2)
    else:
        arch, rule = "granite_moe_3b_a800m", "split"
        mesh = AbstractMesh((16, 16), ("data", "model"))
        cfg = get_smoke_config(arch)
    rec = TD.run_cell(arch, "decode_32k", False, tmp_path, verbose=False,
                      cfg=cfg, mesh_axes=mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["torch"] == torch.__version__
    reshards = (rec["reshards"] if case == "gqa_named"
                else split_view_reshards())
    views = [r for r in reshards if r["op"] == "aten.view.default"]
    assert views and all(
        r["rule"] == rule and r["after"][1] == "R"
        and r["before"][1].startswith("S(") and r["after"][0] ==
        r["before"][0] for r in views), reshards


def test_the_last_resort_ends_the_cell_error(tmp_path, monkeypatch):
    """A cell whose step ran only because every shard of an op's
    arguments was replicated ends ``error``, with the reshard listed."""
    trace = TD.trace_cell
    last = {"op": "aten.index_put.default", "rule": "all", "shape": [4],
            "dtype": "torch.float32", "before": ["S(0)", "R"],
            "after": ["R", "R"], "bytes_per_device": 16, "count": 1}

    def traced(*a, **k):
        out = trace(*a, **k)
        out["reshards"] = out["reshards"] + [last]
        return out
    monkeypatch.setattr(TD, "trace_cell", traced)
    rec = TD.run_cell("mamba2_1_3b", "decode_32k", False, tmp_path,
                      verbose=False, cfg=get_smoke_config("mamba2_1_3b"),
                      mesh_axes=MESH)
    assert rec["status"] == "error"
    assert "aten.index_put.default" in rec["error"]
    assert last in rec["reshards"]
