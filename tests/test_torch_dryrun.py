"""The port's dry-run pieces around ``run_cell``: the variants against the
reference's parser, the activation-sharding hooks (the identity outside a
profile, so serve and train give the same bits), the depth extrapolation
against a full-depth trace, the pre-allocated prefill cache, and the one
committed record against the reference's."""
import contextlib
import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import mesh as TMesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.common import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.sharding import AbstractMesh, P  # noqa: E402
from repro_torch.sharding import ctx as sctx  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def world():
    """``world(n)`` opens a fake process group of ``n`` ranks (closing the
    one it opened before); the fixture closes it after the test."""
    stack = contextlib.ExitStack()

    def open_(n):
        stack.close()
        stack.enter_context(TMesh.fake_process_group(n))
    yield open_
    stack.close()


def _jax_dryrun():
    """The reference dry-run, imported without letting its 512-device
    ``XLA_FLAGS`` outlive the import."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


VARIANTS = ["baseline", "", "dp_all", "sp", "ep", "chunk128", "noremat",
            "nm4", "pin", "cf1.5", "dp_all+chunk128", "ep+cf2+pin",
            "sp+noremat+nm2"]


@pytest.mark.parametrize("spec", VARIANTS)
def test_make_variant_parses_as_the_reference(spec):
    jd = _jax_dryrun()
    assert dataclasses.asdict(TD.make_variant(spec)) == \
        dataclasses.asdict(jd.make_variant(spec))


@pytest.mark.parametrize("spec", ["bogus", "dp_all+zero", "chunkX",
                                  "nmfour", "cfx"])
def test_make_variant_raises_where_the_reference_raises(spec):
    jd = _jax_dryrun()
    with pytest.raises(ValueError) as want:
        jd.make_variant(spec)
    with pytest.raises(ValueError) as got:
        TD.make_variant(spec)
    assert type(got.value) is type(want.value)


def test_ep_variant_views_the_single_pod_ranks():
    ep = TD.make_variant("ep")
    got = TD.variant_mesh(AbstractMesh((16, 16), ("data", "model")), ep)
    assert (got.axis_sizes, got.axis_names) == \
        ((16, 8, 2), ("data", "expert", "tp"))
    with pytest.raises(ValueError, match="single-pod"):
        TD.variant_mesh(AbstractMesh((2, 16, 16),
                                     ("pod", "data", "model")), ep)


def test_constrain_is_the_identity_outside_a_profile(world):
    x = torch.randn(8, 4, 16)
    for role in ("residual", "moe_buffer", "logits"):
        assert sctx.constrain(x, role) is x
    world(8)
    mesh = TMesh.make_mesh((2, 4), ("data", "model"))
    d = TD._meta_dtensor(torch.empty(8, 4, 16), TD.P(), mesh)
    assert sctx.constrain(d, "residual") is d           # no profile
    prof = sctx.ShardProfile(name="sp", mesh=mesh, data_axes=("data",),
                             tp_axes=("model",))
    with sctx.use_profile(prof):
        assert sctx.current() is prof
        assert sctx.constrain(x, "residual") is x       # a plain tensor
        got = sctx.constrain(d, "residual")
        assert got.placements == TD.to_placements(
            TD.P("data", "model", None), mesh)
        assert sctx.constrain(d, "moe_buffer") is d     # no spec for it
    assert sctx.current() is None


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, max(s // cfg.encoder_ratio, 1), cfg.d_model))
            .astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "zamba2_2_7b",
                                  "granite_moe_3b_a800m"])
def test_hooks_leave_serve_and_train_bits_unchanged(arch, world):
    """Under every profile the hooks pass plain tensors through: the
    train step's loss, grad norm and new params and the prefill's logits
    are the same bits as with no profile."""
    cfg = get_smoke_config(arch)
    if cfg.family in ("ssm", "hybrid"):
        cfg = dataclasses.replace(cfg, ssm_chunk=8)
    batch = _batch(cfg, 4, 16)
    params = M.init_params(cfg, device="cpu")
    world(8)
    meshes = {"sp": TMesh.make_mesh((2, 4), ("data", "model"))}
    meshes["dp_all"] = meshes["sp"]

    def run(profile):
        with sctx.use_profile(profile):
            logits, _ = M.prefill(params, cfg, {"tokens": batch["tokens"]})
            state = TS.train_state_init(cfg, device="cpu")
            step = TS.make_train_step(cfg, num_microbatches=2,
                                      warmup_steps=1)
            state, m = step(state, batch)
            state, m = step(state, batch)
        return [logits, m["loss"], m["grad_norm"],
                *leaves(state.params)]

    want = run(None)
    for name in ("sp", "dp_all"):
        prof = sctx.ShardProfile(name=name, mesh=meshes[name])
        for g, w in zip(run(prof), want):
            assert torch.equal(g, w)


def test_prefill_fills_a_given_cache_as_its_own():
    cfg = get_smoke_config("zamba2_2_7b")
    cfg = dataclasses.replace(cfg, ssm_chunk=8)
    params = M.init_params(cfg, device="cpu")
    tokens = _batch(cfg, 2, 16)["tokens"]
    want_logits, want = M.prefill(params, cfg, {"tokens": tokens},
                                  max_seq=24)
    given = M.init_cache(cfg, 2, 24, device="cpu")
    logits, got = M.prefill(params, cfg, {"tokens": tokens}, cache=given,
                            max_seq=99)
    assert got is given
    assert torch.equal(logits, want_logits)
    for (p, g), (_, w) in zip(leaves_with_path(got),
                              leaves_with_path(want)):
        assert torch.equal(g, w), p


@pytest.mark.parametrize("arch,kind", [("codeqwen15_7b", "train"),
                                       ("zamba2_2_7b", "prefill"),
                                       ("whisper_large_v3", "decode")])
def test_depth_extrapolation_against_a_full_depth_trace(arch, kind, world):
    """The cost pass's counts extrapolated from its two depths against a
    trace at the full depth (6 layers): FLOPs and collective bytes are
    linear in depth and equal; bytes accessed within 2% (DTensor lays out
    the stacked layer axis by whether the ranks divide the depth)."""
    cfg = get_smoke_config(arch)
    if cfg.family in ("ssm", "hybrid"):
        cfg = dataclasses.replace(cfg, ssm_chunk=8)
    cfg = TD.at_depth(cfg, 6)
    shape = ShapeConfig("t", 16, 8, kind)
    world(8)
    mesh = TMesh.make_mesh((2, 4), ("data", "model"))
    var = TD.make_variant("nm2")
    ex = TD.costs(cfg, shape, mesh, var)
    full = TD.trace_cell(cfg, shape, mesh, cost_pass=True, variant=var)
    scale = full["cost_scale"]
    assert ex["flops"] == full["flops"] * scale > 0
    for k, v in full["collectives"].items():
        assert ex[f"coll_{k}"] == v * scale
    assert ex["bytes_accessed"] == pytest.approx(
        full["bytes_accessed"] * scale, rel=2e-2)


RECORD = "mamba2_1_3b__decode_32k__single.json"


@pytest.fixture(scope="module")
def fresh_record(tmp_path_factory):
    """A fresh run of the committed record's cell."""
    return TD.run_cell("mamba2_1_3b", "decode_32k", False,
                       tmp_path_factory.mktemp("dryrun"), verbose=False)


def _committed():
    return json.loads((ROOT / "results" / "dryrun_torch" / RECORD)
                      .read_text())


def test_committed_record_agrees_with_the_reference(fresh_record):
    """The committed port record and a fresh run of its cell agree with the
    reference's committed record on what does not depend on the compiler
    or the torch release: params, active params, chips, decisions,
    argument bytes per device."""
    keys = ("params", "active_params", "chips", "decisions",
            "arg_bytes_per_device")
    want = json.loads((ROOT / "results" / "dryrun" / RECORD).read_text())
    for rec in (_committed(), fresh_record):
        assert rec["status"] == "ok"
        assert {k: rec[k] for k in keys} == {k: want[k] for k in keys}
        assert rec["memory"]["arg_bytes_per_device"] == \
            want["memory"]["arg_bytes_per_device"]
    assert fresh_record["torch"] == torch.__version__


def test_committed_record_counts_repeat_on_its_torch(fresh_record):
    """A fresh run counts what the committed record counted (FLOPs, bytes,
    collective bytes, the reshards made), where it runs the torch release
    that the record names: DTensor's strategies, hence the bytes, differ
    between releases."""
    committed = _committed()
    if committed["torch"] != torch.__version__:
        pytest.skip(f"the committed record was counted under torch "
                    f"{committed['torch']}, this is {torch.__version__}")
    for k in ("cost", "collectives", "reshards"):
        assert fresh_record[k] == committed[k], k


def test_reshard_replicates_the_dim_an_argmax_reduces(world):
    """DTensor refuses an argmax over a vocab-parallel row of logits (a
    batch-1 decode's (1, V) row, V sharded); ``Reshard`` replicates the
    shards of the reduced dim and records it."""
    world(8)
    mesh = TMesh.make_mesh((2, 4), ("data", "model"))
    x = TD._meta_dtensor(torch.empty(1, 32), P(None, "model"), mesh)
    reshard = TD.Reshard()
    with reshard:
        out = torch.argmax(x, dim=-1)
    assert tuple(out.shape) == (1,)
    assert reshard.record() == [{
        "op": "aten.argmax.default", "rule": "reduced", "shape": [1, 32],
        "dtype": "torch.float32", "before": ["R", "S(1)"],
        "after": ["R", "R"], "bytes_per_device": 128, "count": 1}]


def test_production_mesh_needs_its_group(world):
    with pytest.raises(RuntimeError, match="fake_process_group"):
        TMesh.make_production_mesh()
    world(256)
    mesh = TMesh.make_production_mesh()
    assert (tuple(mesh.mesh.shape), mesh.mesh_dim_names) == \
        ((16, 16), ("data", "model"))
    world(512)
    mesh = TMesh.make_production_mesh(multi_pod=True)
    assert tuple(mesh.mesh.shape) == (2, 16, 16)
    world(1)
    assert tuple(TMesh.make_local_mesh().mesh.shape) == (1, 1)


def test_a_group_is_closed_after_an_error():
    import torch.distributed as dist
    with pytest.raises(ZeroDivisionError):
        with TMesh.fake_process_group(4):
            assert dist.get_world_size() == 4
            1 / 0
    assert not dist.is_initialized()
    assert get_config("mamba2_1_3b").family == "ssm"
    assert SHAPES["decode_32k"].kind == "decode"
