"""The norms' fused neighbours: the residual add and output bias with the
block's norm, the q and k biases with RoPE, the SSM gate with its norm.

The CUDA kernels (the add and gate prologues of ``rms_norm_fwd_kernel``
and ``rms_norm_bwd_kernel``, ``rope_kernel`` with biases; ``csrc/
norm_rope.cu``) run only on the card, where ``chip_smoke.py`` holds them to
the plain versions.  Here, on the CPU, with inputs made from a seed with
numpy:

(a) the plain versions (``models.common``'s ``add_rms_norm_plain``,
    ``gated_rms_norm_plain`` and ``apply_rope_qk(..., biases=)``) against
    the JAX package's unfused ops (``h + (a + b)`` then ``rms_norm``;
    ``rms_norm(y * jax.nn.silu(z))``; ``apply_rope(q + bq)``): h' and
    ``q + bq`` to the bit, the rest within the stated tolerance of JAX on
    f32 upcasts (f32 within 1e-5 x max|ref|; bf16 within k x 2^-8 |ref| +
    1e-5 x max|ref| for a chain of k bf16 roundings);
(b) the plain backward formulas (``add_rms_norm_bwd_plain``,
    ``gated_rms_norm_bwd_plain``, ``rope_bias_bwd_plain``) against
    ``jax.vjp`` of the same ops (f32: 1e-5 x max|ref|) and against torch
    autograd of today's plain ops in the inputs' dtype;
(c) the dispatch: CPU and meta tensors run the unfused ops (today's ops
    in today's order), the launch functions refuse CPU tensors and the
    inputs the kernels do not take, the routes are the source's instances;
(d) the autograd functions (``AddRMSNorm``, ``GatedRMSNorm``,
    ``RopeBias``) with their launches emulated on the CPU by the plain
    formulas: the smoke configs of codeqwen (biases), whisper (cross
    attention, the f32 encoder), granite (MoE), mamba2 and zamba2 (the
    gate), and codeqwen with qk-norm on both sides (its biases stay plain
    adds before the norms) held to JAX through prefill, decode steps and
    ``forward_train``'s loss and grads, each making exactly the launches
    ``chip_smoke.norm_rope_pass`` counts, by kernel and route.

Every test runs on one intra-op thread, as ``test_torch_norm_rope.py``'s.
"""
import dataclasses
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import norm_rope as K  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train.steps import _grads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL_TOL = 1e-5
BF16_HALF_ULP = 2.0 ** -8
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)   # f32 smoke models, as test_model


@pytest.fixture(autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def within(got: torch.Tensor, ref, roundings: int = 1, extra=None) -> None:
    """``got`` (in its dtype) against the f32 reference ``ref``: f32 within
    1e-5 x max(|ref|, |extra|); bf16 within ``roundings`` x 2^-8 (|ref| +
    |extra|) + 1e-5 x max|ref| (``extra``: a summand whose own rounding a
    sum may cancel)."""
    ref = np.asarray(ref, dtype=np.float32)
    got_np = got.detach().float().numpy()
    assert got_np.shape == ref.shape
    e = 0.0 if extra is None else np.abs(np.asarray(extra, np.float32))
    scale = max(float(np.abs(ref).max()), float(np.max(e)))
    tol = REL_TOL * scale
    if got.dtype == torch.bfloat16:
        tol = tol + roundings * BF16_HALF_ULP * (np.abs(ref) + e)
    err = np.abs(got_np - ref)
    assert (err <= tol).all(), float((err - tol).max())


def same_bits(got: torch.Tensor, want) -> bool:
    """``got``'s bits against a JAX array's (or a tensor's)."""
    if isinstance(want, torch.Tensor):
        return got.dtype == want.dtype and torch.equal(
            got.view(torch.int16 if got.element_size() == 2 else torch.int32),
            want.view(torch.int16 if want.element_size() == 2
                      else torch.int32))
    ints = np.int16 if got.element_size() == 2 else np.int32
    t = got.view(torch.int16 if got.element_size() == 2 else torch.int32)
    return np.array_equal(t.numpy(), np.asarray(want).view(ints))


def draw(rng, shape, dt, scale=1.0):
    """(torch tensor, JAX array) of the same values in dtype ``dt``."""
    t = torch.from_numpy(scale * rng.standard_normal(shape).astype(
        np.float32)).to(DTYPES[dt][0])
    return t, jnp.asarray(t.float().numpy()).astype(DTYPES[dt][1])


def upcast(t: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(t.detach().float().numpy())


# ---------------------------------------------------------------------------
# (a) the plain versions against JAX's unfused ops
# ---------------------------------------------------------------------------

# shape, x dtype, scale dtype, bias dtype (None: no bias)
ADD_CASES = [((3, 16), "float32", "float32", None),
             ((2, 5, 80), "bfloat16", "bfloat16", "bfloat16"),
             ((2, 3, 768), "float32", "bfloat16", "bfloat16"),
             ((2, 3, 64), "float32", "float32", "float32"),
             ((2, 4096), "bfloat16", "bfloat16", None),
             ((2, 3, 48), "bfloat16", "float32", None)]


def add_inputs(seed, shape, x_dt, s_dt, b_dt):
    rng = np.random.default_rng(seed)
    n = shape[-1]
    h, a, dy, dres = (draw(rng, shape, x_dt) for _ in range(4))
    scale = draw(rng, (n,), s_dt, 0.1)
    bias = None if b_dt is None else draw(rng, (n,), b_dt, 0.1)
    return h, a, scale, bias, dy, dres


@pytest.mark.parametrize("shape,x_dt,s_dt,b_dt", ADD_CASES)
def test_add_rms_norm_plain_matches_jax(shape, x_dt, s_dt, b_dt):
    h, a, scale, bias, _, _ = add_inputs(0, shape, x_dt, s_dt, b_dt)
    hp, x = TC.add_rms_norm_plain(h[0], a[0], scale[0],
                                  None if bias is None else bias[0])
    ja = a[1] if bias is None else a[1] + bias[1]
    jhp = h[1] + ja
    assert same_bits(hp, jhp)
    within(x, JC.rms_norm(upcast(hp), upcast(scale[0])))
    # the entry point takes the plain ops on the CPU: the same bits
    hp2, x2 = TC.add_rms_norm(h[0], a[0], scale[0],
                              None if bias is None else bias[0])
    assert same_bits(hp2, hp) and same_bits(x2, x)


# shape, the projection's width (z its first columns), x dtype, scale dtype
GATE_CASES = [((2, 5, 32), 80, "float32", "float32"),
              ((2, 4, 64), 140, "bfloat16", "bfloat16"),
              ((3, 1, 64), 140, "float32", "bfloat16"),
              ((2, 4, 256), 600, "bfloat16", "float32")]


def gate_inputs(seed, shape, width, x_dt, s_dt):
    """(y, z, scale, dy), each (torch, JAX); z a slice of the projection."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    proj = draw(rng, (*shape[:-1], width), x_dt)
    y = draw(rng, shape, x_dt)
    scale = draw(rng, (n,), s_dt, 0.1)
    dy = draw(rng, shape, x_dt)
    return y, (proj[0][..., :n], proj[1][..., :n]), scale, dy


@pytest.mark.parametrize("shape,width,x_dt,s_dt", GATE_CASES)
def test_gated_rms_norm_plain_matches_jax(shape, width, x_dt, s_dt):
    y, z, scale, _ = gate_inputs(1, shape, width, x_dt, s_dt)
    got = TC.gated_rms_norm_plain(y[0], z[0], scale[0])
    # JAX's unfused ops on f32 upcasts: bf16 rounds silu(z), the product
    # and the result
    want = JC.rms_norm(upcast(y[0]) * jax.nn.silu(upcast(z[0])),
                       upcast(scale[0]))
    within(got, want, roundings=3)
    if x_dt == "float32":          # the same ops in the same dtype
        within(got, JC.rms_norm(y[1] * jax.nn.silu(z[1]), scale[1]))
    assert same_bits(TC.gated_rms_norm(y[0], z[0], scale[0]), got)


# B, S, q heads, k heads, head dim, dtype, positions
ROPE_CASES = [(2, 6, 4, 2, 16, "float32", "arange"),
              (2, 5, 3, 1, 18, "bfloat16", "shifted"),
              (3, 1, 4, 4, 32, "bfloat16", "decode"),
              (2, 9, 2, 2, 128, "float32", "shifted")]


def rope_inputs(seed, b, s, hq, hk, hd, dt, kind):
    rng = np.random.default_rng(seed)
    q, k = draw(rng, (b, s, hq, hd), dt), draw(rng, (b, s, hk, hd), dt)
    bq, bk = draw(rng, (hq, hd), dt, 0.1), draw(rng, (hk, hd), dt, 0.1)
    dq, dk = draw(rng, (b, s, hq, hd), dt), draw(rng, (b, s, hk, hd), dt)
    if kind == "decode":
        pos = np.full((b, 1), 37, dtype=np.int32)
    else:
        pos = np.broadcast_to(np.arange(s) + (3 if kind == "shifted" else 0),
                              (b, s)).astype(np.int32)
    return q, k, bq, bk, dq, dk, pos


@pytest.mark.parametrize("b,s,hq,hk,hd,dt,kind", ROPE_CASES)
def test_rope_with_biases_plain_matches_jax(b, s, hq, hk, hd, dt, kind):
    q, k, bq, bk, _, _, pos = rope_inputs(2, b, s, hq, hk, hd, dt, kind)
    tpos = torch.from_numpy(pos.astype(np.int64))
    rq, rk = TC.apply_rope_qk(q[0], k[0], tpos, 1e4, biases=(bq[0], bk[0]))
    for got, x, bias in ((rq, q, bq), (rk, k, bk)):
        added = x[0] + bias[0]
        assert same_bits(added, x[1] + bias[1])
        within(got, JC.apply_rope(upcast(added), jnp.asarray(pos), 1e4))
    # without biases the rotation is the plain one of x + b
    pq, pk = TC.apply_rope_qk(q[0] + bq[0], k[0] + bk[0], tpos, 1e4)
    assert same_bits(pq, rq) and same_bits(pk, rk)


# ---------------------------------------------------------------------------
# (b) the plain backwards against jax.vjp and torch autograd of the plain
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,x_dt,s_dt,b_dt", ADD_CASES)
def test_add_rms_norm_backward_matches_jax_vjp_and_autograd(
        shape, x_dt, s_dt, b_dt):
    h, a, scale, bias, dy, dres = add_inputs(3, shape, x_dt, s_dt, b_dt)
    n = shape[-1]
    hp, _ = TC.add_rms_norm_plain(h[0], a[0], scale[0],
                                  None if bias is None else bias[0])
    b_dtype = None if bias is None else bias[0].dtype
    dh, dscale, dbias = K.add_rms_norm_bwd_plain(hp, scale[0], dy[0],
                                                 dres[0], b_dtype)
    assert dh.dtype == hp.dtype and dscale.dtype == scale[0].dtype
    dx, _ = K.rms_norm_bwd_plain(hp.float(), scale[0].float(),
                                 dy[0].float())
    # jax.vjp of the same ops in the inputs' dtypes (h' rounded as the
    # port rounds it): each grad is a rounding of its own, so within two
    # roundings (dh of each summand)
    zero = jnp.zeros(n, h[1].dtype)

    def f(h_, a_, s_, b_):
        hp_ = h_ + (a_ + b_)
        return hp_, JC.rms_norm(hp_, s_)
    _, vjp = jax.vjp(f, h[1], a[1], scale[1],
                     zero if bias is None else bias[1])
    jdh, jda, jds, jdb = vjp((dres[1], dy[1]))
    within(dh, upcast_jax(jdh), roundings=2, extra=np.asarray(dx))
    assert np.array_equal(np.asarray(jdh), np.asarray(jda))
    within(dscale, upcast_jax(jds), roundings=2)
    # torch autograd of today's plain ops, in the inputs' dtypes
    leaves = [t[0].clone().requires_grad_() for t in
              (h, a, scale) + (() if bias is None else (bias,))]
    hp_t, x_t = TC.add_rms_norm_plain(*leaves)
    torch.autograd.backward((hp_t, x_t), (dres[0], dy[0]))
    within(dh, leaves[0].grad.float(), roundings=2, extra=np.asarray(dx))
    assert same_bits(leaves[0].grad, leaves[1].grad)
    within(dscale, leaves[2].grad.float(), roundings=2)
    if bias is not None:
        # the bias's grad: the rows' dh summed, once rounded
        within(dbias, dh.float().reshape(-1, n).sum(dim=0))
        within(dbias, leaves[3].grad.float(), roundings=2,
               extra=np.abs(np.asarray(dx)).reshape(-1, n).sum(axis=0)
               * (2 if x_dt == "bfloat16" else 0))
        within(dbias, upcast_jax(jdb), roundings=2,
               extra=np.abs(np.asarray(dx)).reshape(-1, n).sum(axis=0)
               * (2 if x_dt == "bfloat16" else 0))


def upcast_jax(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("shape,width,x_dt,s_dt", GATE_CASES)
def test_gated_rms_norm_backward_matches_jax_vjp_and_autograd(
        shape, width, x_dt, s_dt):
    y, z, scale, dy = gate_inputs(4, shape, width, x_dt, s_dt)
    gy, gz, gs = K.gated_rms_norm_bwd_plain(y[0], z[0], scale[0], dy[0])
    assert gy.dtype == gz.dtype == y[0].dtype and gs.dtype == scale[0].dtype
    # torch autograd of today's plain ops, in the inputs' dtypes: dscale
    # within the norm's tolerance; the rounded dx of two f32 sums of other
    # orders may differ by an ulp (two roundings) and each later rounding
    # of both chains adds one: y's grad within four roundings, z's six
    leaves = [t.clone().requires_grad_() for t in (y[0], z[0], scale[0])]
    TC.rms_norm_plain(leaves[0] * F.silu(leaves[1]), leaves[2]).backward(
        dy[0])
    within(gy, leaves[0].grad.float(), roundings=4)
    within(gz, leaves[1].grad.float(), roundings=6)
    within(gs, leaves[2].grad.float())
    if x_dt == "float32":
        _, vjp = jax.vjp(lambda y_, z_, s_: JC.rms_norm(
            y_ * jax.nn.silu(z_), s_), upcast(y[0]), upcast(z[0]),
            upcast(scale[0]))
        jy, jz, js = vjp(upcast(dy[0]))
        within(gy, jy)
        within(gz, jz)
        within(gs, js)


@pytest.mark.parametrize("b,s,hq,hk,hd,dt,kind", ROPE_CASES)
def test_rope_bias_backward_matches_jax_vjp_and_autograd(b, s, hq, hk, hd,
                                                         dt, kind):
    q, k, bq, bk, dq, dk, pos = rope_inputs(5, b, s, hq, hk, hd, dt, kind)
    tpos = torch.from_numpy(pos.astype(np.int64))
    gq, gk, gbq, gbk = K.rope_bias_bwd_plain(
        (dq[0], dk[0]), tpos, 1e4, (bq[0].dtype, bk[0].dtype))
    _, vjp = jax.vjp(lambda q_, k_, bq_, bk_: (
        JC.apply_rope(q_ + bq_, jnp.asarray(pos), 1e4),
        JC.apply_rope(k_ + bk_, jnp.asarray(pos), 1e4)),
        upcast(q[0]), upcast(k[0]), upcast(bq[0]), upcast(bk[0]))
    jq, jk, jbq, jbk = vjp((upcast(dq[0]), upcast(dk[0])))
    within(gq, jq)
    within(gk, jk)
    for got, out in ((gbq, gq), (gbk, gk)):
        within(got, out.float().reshape(-1, *out.shape[-2:]).sum(dim=0))
    if dt == "float32":
        within(gbq, jbq)
        within(gbk, jbk)
    leaves = [t[0].clone().requires_grad_() for t in (q, k, bq, bk)]
    rq, rk = TC.apply_rope_qk(leaves[0], leaves[1], tpos, 1e4,
                              biases=(leaves[2], leaves[3]))
    torch.autograd.backward((rq, rk), (dq[0], dk[0]))
    assert same_bits(gq, leaves[0].grad) and same_bits(gk, leaves[1].grad)
    within(gbq, leaves[2].grad.float())
    within(gbk, leaves[3].grad.float())


# ---------------------------------------------------------------------------
# (c) the dispatch and the routes
# ---------------------------------------------------------------------------


def _refuse(*args, **kwargs):
    raise AssertionError("a fused kernel on plain tensors")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_run_the_unfused_ops(device, monkeypatch):
    for name in ("add_rms_norm_fwd", "gated_rms_norm_fwd",
                 "add_rms_norm_bwd", "gated_rms_norm_bwd"):
        monkeypatch.setattr(K, name, _refuse)
    for fn in (K.AddRMSNorm, K.GatedRMSNorm, K.RopeBias):
        monkeypatch.setattr(fn, "apply", _refuse)
    h = torch.ones((2, 3, 8), device=device, requires_grad=True)
    s = torch.zeros(8, device=device, requires_grad=True)
    hp, x = TC.add_rms_norm(h, h * 2, s, s + 1)
    g = TC.gated_rms_norm(h, h * 3, s)
    q = torch.ones((2, 3, 2, 8), device=device, requires_grad=True)
    pos = torch.arange(3, device=device).expand(2, 3)
    bq = torch.zeros((2, 8), device=device, requires_grad=True)
    rq, rk = TC.apply_rope_qk(q, q, pos, 1e4, biases=(bq, bq))
    assert {t.device.type for t in (hp, x, g, rq, rk)} == {device}
    if device == "cpu":
        (hp.sum() + x.sum() + g.sum() + rq.sum() + rk.sum()).backward()
        assert h.grad.shape == h.shape and bq.grad.shape == bq.shape


def test_unfused_ops_are_todays_in_todays_order():
    """On the CPU the fused entry points dispatch exactly the ATen ops the
    unfused code ran, in its order (what the dry-run traces on meta
    DTensors)."""
    from torch.profiler import ProfilerActivity, profile

    def ops(fn):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        return [e.name for e in prof.events() if e.name.startswith("aten::")
                and e.cpu_parent is None]
    h, a, y, z = (torch.randn(2, 3, 8) for _ in range(4))
    s, b = torch.randn(8), torch.randn(8)
    assert ops(lambda: TC.add_rms_norm(h, a, s, b)) == ops(
        lambda: TC.rms_norm(h + (a + b), s))
    assert ops(lambda: TC.gated_rms_norm(y, z, s)) == ops(
        lambda: TC.rms_norm(y * F.silu(z), s))


def _stand_in(device):
    return SimpleNamespace(device=torch.device(device), placements=None)


def test_takes_fused_is_takes_kernels_rule():
    cpu = torch.zeros(2)
    assert K.takes_fused([cpu]) is False
    assert K.takes_fused([_stand_in("cuda")]) is True
    with pytest.raises(ValueError, match="mix"):
        K.takes_fused([cpu, _stand_in("cuda")])


def test_launch_functions_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        K.add_rms_norm_fwd(x, x, torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA"):
        K.gated_rms_norm_fwd(x, x, torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA"):
        K.add_rms_norm_bwd(x, torch.zeros(16), x, x)
    with pytest.raises(ValueError, match="CUDA"):
        K.gated_rms_norm_bwd(x, x, torch.zeros(16), x)
    with pytest.raises(ValueError, match="CUDA"):
        K.rope([torch.zeros(1, 2, 1, 8)], torch.zeros(1, 2, dtype=torch.long),
               torch.zeros(4), biases=[torch.zeros(1, 8)])
    # a bias that would promote bf16 x to f32 is refused, not run unfused
    with pytest.raises(ValueError, match="bias"):
        K._bias_arg("add_rms_norm_fwd", torch.zeros(16),
                    torch.zeros(2, 16, dtype=torch.bfloat16), 16)
    assert K._bias_arg("f", torch.zeros(16, dtype=torch.bfloat16),
                       torch.zeros(2, 16), 16) == 1


def test_routes_are_the_sources_instances():
    assert K.norm_route(torch.bfloat16, torch.bfloat16, "add") == \
        "add_bf16_bf16"
    assert K.norm_route(torch.float32, torch.bfloat16, "gate") == \
        "gate_f32_bf16"
    # the C instance: prologue * 4 + (x bf16) * 2 + (scale bf16)
    assert K.NORM_ROUTES.index("add_bf16_f32") == 4 + 2
    assert K.NORM_ROUTES.index("gate_f32_bf16") == 8 + 1
    assert K.DSCALE_ROUTES[:12] == K.NORM_ROUTES
    assert K.DSCALE_ROUTES.index("rope_bias_bf16") == 13
    # rope: (biases) * 4 + (backward) * 2 + (bf16)
    assert K.rope_route(torch.bfloat16, True, True) == "bias_backward_bf16"
    assert K.ROPE_ROUTES.index("bias_backward_bf16") == 7
    assert K.dscale_route("bias_backward_f32") == "rope_bias_f32"
    assert K.dscale_route("add_f32_f32") == "add_f32_f32"
    with pytest.raises(ValueError):
        K.norm_route(torch.float32, torch.float32, "mul")
    src = (_build.CSRC / "norm_rope.cu").read_text()
    assert "constexpr int kPairs = 8;" in src and K.PAIRS == 8
    for name in ("add_rms_norm_fwd", "gated_rms_norm_fwd",
                 "add_rms_norm_bwd", "gated_rms_norm_bwd", "rope_bias"):
        assert f'extern "C" int {name}(' in src, name


def test_rope_bias_blocks_cover_the_rows():
    # a block of whole rows: 256 threads / (head_dim / 2 / pairs)
    assert K.rope_bias_blocks(4096, 128, True) == 4096 // 32
    assert K.rope_bias_blocks(10, 18, False) == 1
    assert K.rope_bias_blocks(29, 18, False) == 2
    with pytest.raises(ValueError):
        K.rope_bias_blocks(4, 1026, False)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smokes_parent_route_runs_the_unfused_ops():
    """``chip_smoke.unfused_norm_rope`` (the train step's parent column and
    ``--serve-parent``) shows the fused entry points no kernel device, so
    they run the adds and then the norm and RoPE kernels, and puts the
    choice back after; ``takes_kernel`` stays as it was."""
    cs = _chip_smoke()
    stand_in = [_stand_in("cuda")]
    with cs.unfused_norm_rope():
        assert not K.takes_fused(stand_in)
        assert K.takes_kernel(stand_in)
    assert K.takes_fused(stand_in)


@pytest.mark.parametrize("shape,width,x_dt,s_dt", GATE_CASES)
def test_chip_smokes_gate_tolerance_catches_planted_faults(shape, width,
                                                            x_dt, s_dt):
    """``chip_smoke.nr_gate_check``'s limits on y's and z's grads (4 and 6
    roundings, ``nr_within``) pass the plain backward itself and catch
    each planted fault of ``nr_gate_faults`` (a dropped silu(z) factor in
    y's grad, a dropped slope term in z's)."""
    cs = _chip_smoke()
    y, z, scale, dy = (t[0] for t in gate_inputs(4, shape, width, x_dt,
                                                  s_dt))
    want = K.gated_rms_norm_bwd_plain(y, z, scale, dy)
    assert cs.nr_within(torch, want[0], want[0], 4)["ok"]
    assert cs.nr_within(torch, want[1], want[1], 6)["ok"]
    faults = cs.nr_gate_faults(torch, K, y, z, scale, dy, want)
    assert set(faults) == {"dy_without_silu", "dz_without_silu_slope"}
    assert not any(f["ok"] for f in faults.values()), faults


def test_chip_smoke_counts_the_fused_prefill_ops():
    cs = _chip_smoke()
    want = {"codeqwen15_7b": {"aten::add": 4 * 4, "aten::mul": 0,
                              "aten::silu": 0},
            "mamba2_1_3b": {"aten::add": 0, "aten::mul": 4,
                            "aten::silu": 4}}
    for arch, ops in want.items():
        cfg = dataclasses.replace(get_smoke_config(arch), num_layers=4)
        assert cs.fused_prefill_ops(cfg) == ops, arch


def test_chip_smoke_op_family_gives_bias_adds_their_own_row():
    cs = _chip_smoke()
    dims = dict(seq=512, heads=(32, 32), head_dim=128, d_model=4096,
                d_ff=13440, vocab=92416)
    assert cs.op_family([[8, 512, 32, 128], [32, 128], []], dims,
                        "aten::add") == "bias_adds"
    assert cs.op_family([[8, 512, 4096], [4096], []], dims,
                        "aten::add") == "bias_adds"
    assert cs.op_family([[8, 512, 4096], [8, 512, 4096], []], dims,
                        "aten::add") == "norms_residual"
    assert cs.op_family([[8, 512, 32, 128], [32, 128]], dims,
                        "aten::mul") == "rope_upcasts"


# ---------------------------------------------------------------------------
# (d) the autograd functions, their launches emulated on the CPU
# ---------------------------------------------------------------------------


def _rotate(xs, positions, freqs, backward):
    cos, sin = K.rope_cos_sin(positions, freqs)
    sin = -sin if backward else sin
    out = []
    for x in xs:
        x1, x2 = x.float().chunk(2, dim=-1)
        out.append(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                             dim=-1).to(x.dtype))
    return tuple(out)


@pytest.fixture
def fused_emulated(monkeypatch):
    """CPU tensors take every norm and RoPE function, plain and fused,
    whose launches run the plain formulas here and count themselves by
    kernel and route (a backward's dscale launch too)."""
    counts = {k: dict.fromkeys(K.KERNEL_ROUTES[k], 0) for k in K.KERNELS}
    lock = threading.Lock()

    def count(kernel, route):
        with lock:
            counts[kernel][route] += 1

    def fwd(x, scale, eps=1e-6):
        count("rms_norm_fwd", K.norm_route(x.dtype, scale.dtype))
        return TC.rms_norm_plain(x, scale, eps)

    def add_fwd(h, a, scale, bias=None, eps=1e-6, h_out=None):
        count("rms_norm_fwd", K.norm_route(h.dtype, scale.dtype, "add"))
        hp, x = TC.add_rms_norm_plain(h, a, scale, bias, eps)
        if h_out is None:
            return hp, x
        return h_out.copy_(hp), x

    def gate_fwd(y, z, scale, eps=1e-6):
        count("rms_norm_fwd", K.norm_route(y.dtype, scale.dtype, "gate"))
        return TC.gated_rms_norm_plain(y, z, scale, eps)

    # the backward's rows on the route the launch function would take
    # (``K.backward_route``: by the width, the dtype and the alignment of
    # the contiguous rows it launches on, z by its row stride)
    def bwd(x, scale, dy, eps=1e-6):
        count("rms_norm_bwd", K.backward_route(
            "", x.contiguous(), scale, (dy.contiguous(),)))
        count("rms_norm_dscale", K.norm_route(x.dtype, scale.dtype))
        return K.rms_norm_bwd_plain(x, scale, dy, eps)

    def add_bwd(hp, scale, dy, dres, bias_dtype=None, eps=1e-6):
        count("rms_norm_bwd", K.backward_route(
            "add", hp.contiguous(), scale, (dy.contiguous(),
                                            dres.contiguous())))
        count("rms_norm_dscale", K.norm_route(hp.dtype, scale.dtype, "add"))
        return K.add_rms_norm_bwd_plain(hp, scale, dy, dres, bias_dtype, eps)

    def gate_bwd(y, z, scale, dy, eps=1e-6):
        z2, stride = K._rows_of(z, y.shape[-1])
        count("rms_norm_bwd", K.backward_route(
            "gate", y.contiguous(), scale, (z2, dy.contiguous()),
            stride * z2.element_size()))
        count("rms_norm_dscale", K.norm_route(y.dtype, scale.dtype, "gate"))
        return K.gated_rms_norm_bwd_plain(y, z, scale, dy, eps)

    def rope(xs, positions, freqs, *, backward=False, biases=None):
        route = K.rope_route(xs[0].dtype, backward, biases is not None)
        count("rope", route)
        if biases is not None and not backward:
            xs = [x + b for x, b in zip(xs, biases)]
        outs = _rotate(xs, positions, freqs, backward)
        if biases is None or not backward:
            return outs
        count("rms_norm_dscale", K.dscale_route(route))
        return outs + tuple(o.float().reshape(-1, *o.shape[-2:]).sum(dim=0)
                            .to(b.dtype) for o, b in zip(outs, biases))
    def cpu(ts):
        return all(t.device.type == "cpu" for t in ts)
    monkeypatch.setattr(K, "takes_kernel", cpu)
    monkeypatch.setattr(K, "takes_fused", cpu)
    for name, fn in (("rms_norm_fwd", fwd), ("add_rms_norm_fwd", add_fwd),
                     ("gated_rms_norm_fwd", gate_fwd), ("rms_norm_bwd", bwd),
                     ("add_rms_norm_bwd", add_bwd),
                     ("gated_rms_norm_bwd", gate_bwd), ("rope", rope)):
        monkeypatch.setattr(K, name, fn)
    return counts


# (port arch, the configs' replaced fields on both sides)
PATHS = [("codeqwen15_7b", {}), ("whisper_large_v3", {}),
         ("granite_moe_3b_a800m", {}), ("mamba2_1_3b", {"ssm_chunk": 8}),
         ("zamba2_2_7b", {"ssm_chunk": 8}),
         ("codeqwen15_7b", {"qk_norm": True})]
PATH_IDS = ["codeqwen", "whisper", "granite", "mamba2", "zamba2",
            "codeqwen_qk_norm"]
B, S, STEPS = 2, 16, 3
_FILLED = ("attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm",
           "bq", "bk", "bv", "bo", "norm", "conv_b", "cross_norm",
           "enc_norm")


def configs(arch, kw):
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


def shared_params(jcfg, seed=0):
    """The JAX init as numpy, its norms and biases filled from ``seed``
    (zeros would leave the fused bias adds untested)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k in _FILLED:
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    fill(tree)
    return tree


def batch_of(cfg, toks, seed=7):
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], max(toks.shape[1] // cfg.encoder_ratio, 1),
             cfg.d_model)).astype(np.float32)
    return batch


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want), **MODEL_TOL)


def reset(counts):
    for by in counts.values():
        for r in by:
            by[r] = 0


@pytest.mark.parametrize("arch,kw", PATHS, ids=PATH_IDS)
def test_serve_steps_through_the_functions_match_jax(arch, kw,
                                                     fused_emulated):
    """Prefill and decode steps through the fused functions (emulated)
    equal JAX's, each making the launches ``chip_smoke.norm_rope_pass``
    counts for a forward pass and for a decode step."""
    cs = _chip_smoke()
    cfg, jcfg = configs(arch, kw)
    tree = shared_params(jcfg)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, S + STEPS)).astype(np.int32)
    batch = batch_of(cfg, toks[:, :S])
    jl, jcache = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(jp, batch)
    reset(fused_emulated)
    with torch.inference_mode():
        tl, tcache = TM.prefill(tp, cfg, {k: torch.from_numpy(v)
                                          for k, v in batch.items()},
                                max_seq=S + STEPS)
    close(tl, jl)
    assert fused_emulated == cs.norm_rope_pass(K, cfg, "forward", 1)
    grown = jax.tree.map(
        lambda dst, src: jnp.pad(
            src, [(0, d - s) for d, s in zip(dst.shape, src.shape)]
        ).astype(dst.dtype), JM.init_cache(jcfg, B, S + STEPS), jcache)
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(p, jcfg, c, t, pos))
    reset(fused_emulated)
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        jl, grown = jstep(jp, grown, tok, jnp.int32(S + i))
        with torch.inference_mode():
            tl, tcache = TM.decode_step(tp, cfg, tcache,
                                        torch.from_numpy(tok), S + i)
        close(tl, jl)
    assert fused_emulated == cs.norm_rope_pass(K, cfg, "decode", STEPS)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch,kw", PATHS, ids=PATH_IDS)
def test_forward_train_through_the_functions_matches_jax(arch, kw, remat,
                                                         fused_emulated):
    """``forward_train``'s loss and grads through the fused functions
    (emulated) equal JAX's ``value_and_grad``, with the launches of one
    pass (two forwards of the layers under remat) and one backward."""
    cs = _chip_smoke()
    cfg, jcfg = configs(arch, kw)
    tree = shared_params(jcfg, seed=2)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {**batch_of(cfg, toks), "labels": labels}
    jloss, jgrads = jax.value_and_grad(lambda p: JM.forward_train(
        p, jcfg, jax.tree.map(jnp.asarray, batch), remat=remat)[0])(
        jax.tree.map(jnp.asarray, tree))
    reset(fused_emulated)
    tloss, tgrads = _grads(lambda p, mb: TM.forward_train(
        p, cfg, mb, remat=remat)[0], params_from_numpy(tree, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    close(tloss, jloss)
    jl, tl = jax.tree.leaves(jgrads), jax.tree.leaves(tgrads)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        close(t, j)
    assert fused_emulated == cs.norm_rope_pass(
        K, cfg, "forward", 1, forwards=2 if remat else 1, backward=True)


def test_serve_writes_h_over_the_branch_output(fused_emulated):
    """Where autograd does not record, the fused add norm writes h' over
    ``a`` (the serve steps' peak holds no more rows than the unfused
    adds'); where it records, ``AddRMSNorm`` leaves its inputs alone."""
    h, a, s = torch.randn(2, 3, 16), torch.randn(2, 3, 16), torch.randn(16)
    b = torch.randn(16)
    want = TC.add_rms_norm_plain(h, a, s, b)
    a_serve = a.clone()
    with torch.inference_mode():
        hp, x = TC.add_rms_norm(h, a_serve, s, b)
    assert hp.data_ptr() == a_serve.data_ptr()
    assert same_bits(hp, want[0]) and same_bits(x, want[1])
    a_train = a.clone().requires_grad_()
    hp, x = TC.add_rms_norm(h, a_train, s, b)
    assert same_bits(a_train.detach(), a) and same_bits(hp.detach(), want[0])


def test_qk_norm_keeps_the_biases_before_the_norms():
    """With qk-norm the q and k biases are plain adds before the norms:
    no rotation takes them."""
    cs = _chip_smoke()
    cfg, _ = configs("codeqwen15_7b", {"qk_norm": True})
    c = cs.norm_rope_calls(cfg, "forward")
    assert c["bias_ropes"] == 0 and c["ropes"] == cfg.num_layers
    plain, _ = configs("codeqwen15_7b", {})
    assert cs.norm_rope_calls(plain, "forward")["bias_ropes"] == \
        plain.num_layers
