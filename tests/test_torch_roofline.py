"""The port's roofline layer: ``model_flops`` and ``roofline_terms`` against
the JAX package's, and the counters the dry-run reads.

* ``FlopCounterMode`` over DTensors counts GLOBAL FLOPs: a (2, 2) mesh and
  a 1-rank mesh count the same, and the 1-rank fake pass counts what the
  same step counts when it really runs on the CPU.
* ``StepCounter`` counts PER DEVICE: bytes of rank 0's local shards, and
  the result bytes of the collectives DTensor issues.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro import roofline as JR  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import mesh as TMesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.common import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.roofline import (StepCounter, model_flops,  # noqa: E402
                                  roofline_terms)
from repro_torch.train import steps as TS  # noqa: E402


@pytest.fixture
def world():
    """``world(n)`` opens a fake process group of ``n`` ranks (closing the
    one it opened before); the fixture closes it after the test, also when
    the test fails."""
    stack = contextlib.ExitStack()

    def open_(n):
        stack.close()
        stack.enter_context(TMesh.fake_process_group(n))
    yield open_
    stack.close()


def mesh_of(shape):
    return TMesh.make_mesh(shape, ("data", "model"))


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_model_flops_match_jax(arch):
    for shape in SHAPES.values():
        assert model_flops(TC.get_config(arch), shape) == \
            JR.model_flops(JC.get_config(arch), shape)


@pytest.mark.parametrize("args", [
    (197e12 * 256, 0.0, 0.0, 256, 197e12, 819e9, 50e9),      # compute-bound
    (1e12, 819e9 * 256 * 10, 0, 256, 197e12, 819e9, 50e9),  # memory-bound
    (1e12, 1e9, 50e9 * 256 * 3, 256, 197e12, 819e9, 50e9),  # collectives
    (0.0, 0.0, 0.0, 1, 989e12, 3.35e12, 450e9),              # nothing
])
def test_roofline_terms_match_jax(args):
    assert roofline_terms(*args) == JR.roofline_terms(*args)


def test_h100_constants():
    assert (TMesh.PEAK_FLOPS_BF16, TMesh.PEAK_FLOPS_F32, TMesh.HBM_BW,
            TMesh.HBM_BYTES, TMesh.LINK_BW) == \
        (989e12, 67e12, 3.35e12, 80e9, 450e9)


def test_flops_are_global_and_bytes_per_device(world):
    """A matmul and an add on DTensors sharded 4 ways: the FLOP count is
    the global one, the bytes are one rank's shards."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    world(4)
    mesh = mesh_of((2, 2))
    x = TD._meta_dtensor(torch.empty(8, 16), TD.P(("data", "model"), None),
                         mesh)
    w = TD._meta_dtensor(torch.empty(16, 32), TD.P(), mesh)
    assert x.placements == (Shard(0), Shard(0))
    assert w.placements == (Replicate(), Replicate())
    counter = StepCounter()
    with counter, FlopCounterMode(display=False) as flops:
        y = x @ w
        z = y + y
    assert flops.get_total_flops() == 2 * 8 * 16 * 32
    # per device: 2 of the 8 rows; mm reads x's and w's shard, writes y's;
    # the add reads y's twice and writes z's
    rows = 2
    want = 4 * (rows * 16 + 16 * 32 + rows * 32) + 4 * 3 * rows * 32
    assert counter.bytes_accessed == want
    assert counter.collective_bytes()["total"] == 0
    assert counter.peak_live_bytes == 2 * 4 * rows * 32
    del z


def test_counters_on_a_sharded_smoke_train_step(world):
    """codeqwen's smoke train step on a (2, 2) fake mesh moves params and
    grads: non-zero all-gather and reduce-scatter bytes; the same step
    on a 1-rank mesh counts the same FLOPs and no collective."""
    cfg = TC.get_smoke_config("codeqwen15_7b")
    shape = ShapeConfig("t", 32, 8, "train")
    var = TD.make_variant("nm1")
    world(4)
    sharded = TD.trace_cell(cfg, shape, mesh_of((2, 2)), variant=var)
    coll = sharded["collectives"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["total"] == sum(v for k, v in coll.items() if k != "total")
    world(1)
    one = TD.trace_cell(cfg, shape, mesh_of((1, 1)), variant=var)
    assert one["flops"] == sharded["flops"] > 0
    assert one["collectives"]["total"] == 0
    assert one["bytes_accessed"] > sharded["bytes_accessed"]


def _real_tokens(cfg, b, s, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32))


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "mamba2_1_3b",
                                  "zamba2_2_7b", "granite_moe_3b_a800m",
                                  "whisper_large_v3"])
def test_fake_pass_flops_equal_a_real_cpu_run(arch, world):
    """The 1-rank fake pass counts, to the FLOP, what ``FlopCounterMode``
    counts when the same prefill and train step run on real CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = TC.get_smoke_config(arch)
    if cfg.family in ("ssm", "hybrid"):
        cfg = dataclasses.replace(cfg, ssm_chunk=8)
    b, s = 2, 16
    world(1)
    mesh = mesh_of((1, 1))
    fake = {kind: TD.trace_cell(cfg, ShapeConfig("t", s, b, kind), mesh,
                                variant=TD.make_variant("nm1"))["flops"]
            for kind in ("prefill", "train")}

    params = M.init_params(cfg, device="cpu")
    batch = {"tokens": _real_tokens(cfg, b, s, 0)}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros(
            (b, max(s // cfg.encoder_ratio, 1), cfg.d_model),
            dtype=cfg.torch_dtype)
    with FlopCounterMode(display=False) as prefill:
        TS.make_prefill_step(cfg, use_kernel=False)(params, batch)
    state = TS.train_state_init(cfg, device="cpu")
    tbatch = dict(batch, labels=_real_tokens(cfg, b, s, 1))
    step = TS.make_train_step(cfg, remat=True, donate=True)
    with FlopCounterMode(display=False) as train:
        step(state, tbatch)
    assert fake["prefill"] == prefill.get_total_flops() > 0
    assert fake["train"] == train.get_total_flops() > 0
