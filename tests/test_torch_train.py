"""Port parity: the train step (five families), its options and the kernel
guard, against the JAX package.

The start state is the JAX package's ``train_state_init``, bridged as
numpy (``bridge.train_state_from_numpy``): the port cannot reproduce
``jax.random``.  Batches come from ``synthetic_batch`` (plus seeded f32
frames for whisper) and go to both sides.  Each case runs 3 steps with
warmup 1, so the first step has lr 0 and the next two move the params.
Tolerances, f32 smoke configs: loss and grad norm within 1e-5 relative,
lr within 1e-7, m and v within atol 1e-6 and 1e-7, params within atol
2e-5 + 1e-3 x the lr summed over the steps (both sides run the same f32
math in another summation order).  AdamW's normalised step turns f32
noise in a grad near eps into a step of any sign, and int8 compression
can round a grad on a boundary either way; ``check`` says how those
elements are held.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import synthetic_batch  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch.bridge import train_state_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

B, S, STEPS = 4, 16, 3
STEP_KW = dict(peak_lr=1e-2, warmup_steps=1, total_steps=8)
FAMILIES = ["codeqwen15_7b", "mamba2_1_3b", "zamba2_2_7b",
            "granite_moe_3b_a800m", "whisper_large_v3", "nemotron_4_15b",
            "command_r_plus_104b", "gemma2_27b", "chameleon_34b",
            "grok_1_314b"]


def cfgs(arch):
    """(port config, JAX config); SSM scans with ``ssm_chunk=8`` so the
    16-token batches cross chunks."""
    t, j = get_smoke_config(arch), jax_smoke(arch)
    if t.family in ("ssm", "hybrid"):
        t = dataclasses.replace(t, ssm_chunk=8)
        j = dataclasses.replace(j, ssm_chunk=8)
    return t, j


def batches(cfg, n=STEPS):
    out = []
    for i in range(n):
        b = synthetic_batch(3, 0, i, B, S, cfg.vocab_size)
        if cfg.family == "encdec":
            b["frames"] = np.random.default_rng(i).standard_normal(
                (B, max(S // cfg.encoder_ratio, 1), cfg.d_model)
            ).astype(np.float32)
        out.append(b)
    return out


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), **tol)


def run_both(arch, **kw):
    """``STEPS`` steps of the port's and the jitted JAX step from one
    bridged state; returns (port state, JAX state, metrics pairs)."""
    tcfg, jcfg = cfgs(arch)
    compress = kw.get("compress", False)
    jstate = JS.train_state_init(jcfg, jax.random.PRNGKey(0),
                                 compress=compress)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(JS.make_train_step(jcfg, **STEP_KW, **kw))
    tstep = TS.make_train_step(tcfg, **STEP_KW, **kw)
    metrics = []
    for b in batches(tcfg):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        metrics.append((tm, jm))
    return tstate, jstate, metrics


def check(tstate, jstate, metrics, compress=False):
    """Hold the port's run to JAX's.

    Params within atol 2e-5 + 1e-3 x (sum of lr), m within atol 1e-6 and
    v within 1e-7, except where the step is ill-conditioned:
    - elements whose RMS grad sqrt(v_hat) is below 1e-6 (100 x eps): there
      m_hat / (sqrt(v_hat) + eps) is a ratio of f32 noise (the attention
      key biases, whose true grad is 0, are such), so their params are
      held only to the size of the steps taken, 2 x (sum of lr);
    - with compression, the int8 code of an element whose grad lies within
      f32 noise of a rounding boundary may differ by one quantum q (the
      per-tensor scale, >= 2 max |residual|): m, v and the residual are
      held to what one quantum a step can move them, and an element whose
      m moved that way is held like an ill-conditioned one."""
    for tm, jm in metrics:
        close(tm["loss"], jm["loss"], rtol=1e-5, atol=0)
        close(tm["grad_norm"], jm["grad_norm"], rtol=1e-5, atol=0)
        close(tm["lr"], jm["lr"], rtol=1e-7, atol=0)
        assert int(tm["step"]) == int(jm["step"])
    assert float(metrics[0][0]["lr"]) == 0.0
    lr_sum = sum(float(jm["lr"]) for _, jm in metrics)
    assert int(tstate.opt.step) == int(jstate.opt.step) == STEPS
    c2 = 1 - 0.95 ** STEPS
    leaves = zip(*(jax.tree.leaves(t) for t in (
        tstate.params, tstate.opt.m, tstate.opt.v, jstate.params,
        jstate.opt.m, jstate.opt.v)))
    res = (zip(jax.tree.leaves(tstate.residual),
               jax.tree.leaves(jstate.residual)) if compress else None)
    for tp, tm, tv, jp, jm, jv in leaves:
        tp, tm, tv = (t.detach().numpy() for t in (tp, tm, tv))
        jp, jm, jv = (np.asarray(t) for t in (jp, jm, jv))
        m_tol, v_tol = 1e-6, 1e-7
        if compress:
            tr, jr = next(res)
            q = 2.5 * float(np.abs(np.asarray(jr)).max()) + 1e-12
            np.testing.assert_allclose(tr.numpy(), jr, rtol=0,
                                       atol=1e-6 + q)
            m_tol += 0.1 * STEPS * q
            v_tol += 0.05 * STEPS * (2 * 127 * q + q) * q
        np.testing.assert_allclose(tm, jm, rtol=0, atol=m_tol)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=v_tol)
        noisy = np.sqrt(jv / c2) < 1e-6
        if compress:
            noisy |= np.abs(tm - jm) > 1e-6
        err = np.abs(tp - jp)
        assert (err[~noisy] <= 2e-5 + 1e-3 * lr_sum).all(), err[~noisy].max()
        assert (err[noisy] <= 2 * lr_sum).all()


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_jax(arch):
    check(*run_both(arch))


@pytest.mark.parametrize("kw", [dict(num_microbatches=2),
                                dict(compress=True),
                                dict(remat=False)],
                         ids=["microbatches2", "compress", "no_remat"])
def test_train_step_options_match_jax(kw):
    check(*run_both("codeqwen15_7b", **kw), compress=kw.get("compress"))


def test_donated_step_equals_functional_step():
    """``donate=True`` updates the state's own tensors, to the same bits."""
    cfg = get_smoke_config("codeqwen15_7b")
    gen = torch.Generator().manual_seed(0)
    a = TS.train_state_init(cfg, gen, device="cpu")
    b = jax.tree.map(torch.clone, a)
    fstep = TS.make_train_step(cfg, **STEP_KW)
    dstep = TS.make_train_step(cfg, **STEP_KW, donate=True)
    embed = b.params["embed"]
    for batch in batches(cfg):
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        a, am = fstep(a, tb)
        b, bm = dstep(b, tb)
        for k in am:
            assert torch.equal(am[k], bm[k]), k
    assert b.params["embed"] is embed
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert torch.equal(x, y)


def test_remat_matches_no_remat_on_the_port():
    cfg = get_smoke_config("zamba2_2_7b")
    params = TM.init_params(cfg, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(1, 0, 0, 2, 16, cfg.vocab_size)
             .items()}
    grads = []
    for remat in (True, False):
        loss, g = TS._grads(lambda p, mb: TM.forward_train(
            p, cfg, mb, remat=remat)[0], params, batch)
        grads.append((loss, g))
    assert torch.equal(grads[0][0], grads[1][0])
    for x, y in zip(jax.tree.leaves(grads[0][1]),
                    jax.tree.leaves(grads[1][1])):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-7)


def test_unbind_layers_give_one_grad_per_stacked_leaf():
    """The layers come from one unbind per stacked leaf: each leaf's grad
    is a single (L, ...) tensor, and no layer reads another's slice."""
    cfg = get_smoke_config("codeqwen15_7b")
    params = TM.init_params(cfg, device="cpu")
    w = params["layers"]["mlp"]["w1"].detach().requires_grad_(True)
    views = TM._unstack({"w": w}, cfg.num_layers)
    assert len(views) == cfg.num_layers
    assert views[1]["w"].grad_fn.name().startswith("Unbind")
    (views[1]["w"].sum() * 2).backward()
    assert torch.equal(w.grad[1], torch.full_like(w.grad[1], 2.0))
    assert float(w.grad[0].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# The kernel route refuses autograd
# ---------------------------------------------------------------------------


def test_flash_wrapper_refuses_inputs_that_require_grad():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16)
    with pytest.raises(RuntimeError, match="no backward.*use_kernel=False"):
        fa.flash_attention_bhsd(q, k, v)
    with torch.no_grad():
        out = fa.flash_attention_bhsd(q, k, v)
    torch.testing.assert_close(out, fa.flash_attention_plain(
        q.detach(), k, v))
    fa.flash_attention_bhsd(q.detach(), k, v)     # nothing requires grad


def test_ssd_wrapper_refuses_inputs_that_require_grad():
    x = torch.randn(1, 2, 16, 8)
    dt = torch.rand(1, 2, 16, requires_grad=True)
    a = -torch.rand(2)
    b, c = torch.randn(1, 1, 16, 4), torch.randn(1, 1, 16, 4)
    with pytest.raises(RuntimeError, match="no backward.*use_kernel=False"):
        ss.ssd_scan_bhsd(x, dt, a, b, c, 8)
    with torch.inference_mode():
        ss.ssd_scan_bhsd(x, dt, a, b, c, 8)


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "mamba2_1_3b"])
def test_train_step_on_the_kernel_route_raises(arch):
    cfg, _ = cfgs(arch)
    state = TS.train_state_init(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    step = TS.make_train_step(cfg, use_kernel=True)
    b = {k: torch.from_numpy(v) for k, v in batches(cfg, 1)[0].items()}
    with pytest.raises(RuntimeError, match="no backward"):
        step(state, b)


def test_train_state_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        TS.train_state_init(get_smoke_config("codeqwen15_7b"))


class TestLossTrains:
    def test_tiny_model_loss_decreases(self):
        """A few optimizer steps on repeated data must cut the loss."""
        cfg = dataclasses.replace(get_smoke_config("codeqwen15_7b"),
                                  num_layers=2)
        state = TS.train_state_init(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
        step = TS.make_train_step(cfg, peak_lr=3e-3, warmup_steps=2,
                                  total_steps=40, remat=False)
        batch = {k: torch.from_numpy(v) for k, v in
                 synthetic_batch(0, 0, 0, 4, 32, cfg.vocab_size).items()}
        state, m0 = step(state, batch)
        for _ in range(15):
            state, m = step(state, batch)
        assert float(m["loss"]) < float(m0["loss"]) - 0.5, (
            float(m0["loss"]), float(m["loss"]))


# ---------------------------------------------------------------------------
# The train driver through the engine
# ---------------------------------------------------------------------------


# How long the reference's checkpoint writer may take to finish after its
# ``run_training`` returns.  The reference's
# ``CheckpointManager.save_async`` hands over its writer thread without a
# lock, so when two of the engine's
# checkpoint apps overlap, ``wait`` joins only one writer and
# ``run_training`` can return before its last checkpoint is on disk (the
# port's manager drains every write before ``wait`` returns).
REFERENCE_WRITER_DEADLINE_S = 60.0


def _await_reference_checkpoint(directory, step: int) -> None:
    """Block until the reference ``run_training``'s checkpoint of ``step``
    is on disk under ``directory`` and no write is left in flight (no
    ``.tmp-*`` directory); fail after ``REFERENCE_WRITER_DEADLINE_S``."""
    import time
    final = directory / f"step_{step:08d}" / "manifest.json"
    deadline = time.monotonic() + REFERENCE_WRITER_DEADLINE_S
    while not (final.exists() and not any(
            p.name.startswith(".tmp-") for p in directory.iterdir())):
        if time.monotonic() > deadline:
            pytest.fail(f"the reference's checkpoint writer did not put step "
                        f"{step} on disk in {directory} within "
                        f"{REFERENCE_WRITER_DEADLINE_S} s: found "
                        f"{sorted(p.name for p in directory.iterdir())}")
        time.sleep(0.05)


def test_run_training_resumed_matches_jax(tmp_path, capsys):
    """The JAX driver trains ``tiny`` 4 steps and checkpoints; both drivers
    resume from that checkpoint (the same start state) for 4 more steps.
    Losses within 1e-4 relative; each driver's final checkpoint restores
    in the other package and agrees with the other's."""
    import shutil

    from repro.checkpointing import load_checkpoint as jax_load
    from repro.launch import train as JT
    from repro_torch.checkpointing import latest_step, load_checkpoint
    from repro_torch.launch import train as TT

    kw = dict(steps=4, shards=2, batch_per_shard=2, seq=16, ckpt_every=2,
              log_every=0)
    JT.run_training(JT.PRESETS["tiny"], ckpt_dir=str(tmp_path / "first"),
                    **kw)
    _await_reference_checkpoint(tmp_path / "first", 4)
    for name in ("jax", "port"):
        shutil.copytree(tmp_path / "first", tmp_path / name)
    want = JT.run_training(JT.PRESETS["tiny"], ckpt_dir=str(tmp_path / "jax"),
                           resume=True, **kw)
    _await_reference_checkpoint(tmp_path / "jax", 8)
    got = TT.run_training(TT.PRESETS["tiny"], ckpt_dir=str(tmp_path / "port"),
                          resume=True, device="cpu", **kw)
    assert got["start_step"] == 4 and got["final_step"] == want[
        "final_step"] == 8
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    assert latest_step(str(tmp_path / "port")) == 8
    jstate = JS.train_state_init(jax_smoke("codeqwen15_7b"),
                                 jax.random.PRNGKey(0))
    _, port_in_jax = jax_load(str(tmp_path / "port"), jstate)
    _, jax_ckpt = jax_load(str(tmp_path / "jax"), jstate)
    _, port_ckpt = load_checkpoint(str(tmp_path / "port"),
                                   got["final_state"])
    for a, b, c, d in zip(jax.tree.leaves(port_in_jax),
                          jax.tree.leaves(jax_ckpt),
                          jax.tree.leaves(port_ckpt),
                          jax.tree.leaves(got["final_state"])):
        assert torch.equal(c, d)                       # bit for bit
        np.testing.assert_array_equal(a, c.numpy())
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_run_training_defaults_to_cuda():
    from repro_torch.launch import train as TT
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        TT.run_training(TT.PRESETS["tiny"], steps=1)
