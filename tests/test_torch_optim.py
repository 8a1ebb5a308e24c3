"""Port parity: the optimizer (AdamW, clipping, the cosine schedule) and
int8 gradient compression against the JAX package, plus ports of the JAX
package's own optimizer tests (``TestAdamW``, ``TestSchedule`` in
``test_substrates.py``, ``TestCompressionProperties`` in
``test_property.py``, its random cases drawn here from fixed seeds).

Inputs come from numpy seeds and go to both packages.  Tolerances, f32:
the schedule within 1e-7 relative (the same f32 formula; XLA's and ATen's
``cos`` may differ in the last bit), m and v within atol 1e-6, params
within atol 1e-5 (AdamW's normalised step m / (sqrt(v) + eps) amplifies
the last bits of a grad whose size is near eps), int8 codes exact, scales
within 1e-7 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def tree(seed, scale=1.0, stack=3):
    """A nested numpy tree with a stacked leaf, a matrix and a vector."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"layers": {"w": f(stack, 6, 5), "b": f(stack, 5)},
            "embed": f(7, 4), "norm": f(4)}


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def assert_tree_close(got, want, **tol):
    got = jax.tree.map(lambda t: t.numpy(), got)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **tol),
                 got, np_tree(want))


@pytest.mark.parametrize("warmup,total", [(4, 10), (1, 12), (0, 8)])
def test_cosine_schedule_matches_jax(warmup, total):
    for step in range(13):
        got = float(TO.cosine_schedule(step, peak_lr=3e-3,
                                       warmup_steps=warmup,
                                       total_steps=total))
        want = float(JO.cosine_schedule(step, peak_lr=3e-3,
                                        warmup_steps=warmup,
                                        total_steps=total))
        assert got == pytest.approx(want, rel=1e-7, abs=0), step
    assert float(TO.cosine_schedule(0, peak_lr=1.0, warmup_steps=3,
                                    total_steps=9)) == 0.0


def test_cosine_schedule_takes_a_device_step():
    step = torch.tensor(5, dtype=torch.int32)
    lr = TO.cosine_schedule(step, peak_lr=1.0, warmup_steps=10,
                            total_steps=100)
    assert lr.dtype == torch.float32 and lr.dim() == 0
    assert float(lr) == pytest.approx(0.5)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = tree(1)
    got, gn = TO.clip_by_global_norm(params_from_numpy(g, "cpu"), max_norm)
    want, wgn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                       max_norm)
    assert float(gn) == pytest.approx(float(wgn), rel=1e-6)
    assert_tree_close(got, want, rtol=1e-6, atol=1e-7)


def test_clip_makes_bf16_grads_f32_as_jax_promotes():
    g = {"w": torch.full((4,), 10.0, dtype=torch.bfloat16)}
    clipped, gn = TO.clip_by_global_norm(g, 1.0)
    assert clipped["w"].dtype == torch.float32
    assert float(gn) == pytest.approx(20.0)


def _bridged_state():
    m, v = tree(11, 0.01), tree(12, 1e-4)
    v = jax.tree.map(np.abs, v)
    jstate = JO.AdamWState(step=jnp.int32(2),
                           m=jax.tree.map(jnp.asarray, m),
                           v=jax.tree.map(jnp.asarray, v))
    tstate = TO.AdamWState(step=torch.tensor(2, dtype=torch.int32),
                           m=params_from_numpy(m, "cpu"),
                           v=params_from_numpy(v, "cpu"))
    return jstate, tstate


def test_adamw_update_matches_jax_over_three_steps():
    p_np = tree(0)
    jstate, tstate = _bridged_state()
    jp, tp = jax.tree.map(jnp.asarray, p_np), params_from_numpy(p_np, "cpu")
    for i in range(3):
        g_np = tree(20 + i, 0.1)
        lr = 1e-3 * (i + 1)
        jp, jstate = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g_np),
                                     jstate, lr=jnp.float32(lr))
        tp, tstate = TO.adamw_update(tp, params_from_numpy(g_np, "cpu"),
                                     tstate, lr=torch.tensor(lr))
    assert int(tstate.step) == int(jstate.step) == 5
    assert_tree_close(tstate.m, jstate.m, rtol=0, atol=1e-6)
    assert_tree_close(tstate.v, jstate.v, rtol=0, atol=1e-6)
    assert_tree_close(tp, jp, rtol=0, atol=1e-5)


def test_adamw_update_leaves_its_arguments_alone():
    p = params_from_numpy(tree(0), "cpu")
    before = [t.clone() for t in leaves(p)]
    st = TO.adamw_init(p)
    TO.adamw_update(p, params_from_numpy(tree(1), "cpu"), st, lr=0.1)
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(p)))
    assert int(st.step) == 0 and all(float(t.abs().sum()) == 0
                                     for t in leaves(st.m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_donating_form_equals_functional_form(dtype, monkeypatch):
    """In place, slice by slice (slices forced small here) and with the
    clip factor applied per slice: the same bits as clip + update."""
    monkeypatch.setattr(TA, "SLICE_ELEMS", 16)
    p = params_from_numpy(tree(0), "cpu", dtype)
    g = params_from_numpy(tree(1, 3.0), "cpu", dtype)
    st = TO.adamw_init(p)
    fp, fst = p, st
    dp = {k: (v.clone() if not isinstance(v, dict) else
              {k2: v2.clone() for k2, v2 in v.items()}) for k, v in p.items()}
    dst = TO.adamw_init(dp)
    assert len(list(TA.slices(dp["layers"]["w"]))) == 3
    for _ in range(3):
        lr = torch.tensor(1e-2)
        clipped, gn = TO.clip_by_global_norm(g, 1.0)
        fp, fst = TO.adamw_update(fp, clipped, fst, lr=lr)
        gn2 = TA.global_norm(g)
        out_p, dst = TO.adamw_update_(dp, g, dst, lr=lr,
                                      scale=TA.clip_scale(gn2, 1.0))
        assert out_p is dp
        assert torch.equal(gn, gn2)
    for a, b in zip(leaves((fp, fst.m, fst.v)), leaves((dp, dst.m, dst.v))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(dst.step) == 3


def test_compress_decompress_match_jax():
    g = tree(3, 5.0)
    tq, ts = TO.compress_gradients(params_from_numpy(g, "cpu"))
    jq, js = JO.compress_gradients(jax.tree.map(jnp.asarray, g))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b),
                 tq, np_tree(jq))
    assert all(t.dtype == torch.int8 for t in leaves(tq))
    assert_tree_close(ts, js, rtol=1e-7, atol=0)
    back = TO.decompress_gradients(tq, ts)
    assert_tree_close(back, JO.decompress_gradients(jq, js),
                      rtol=1e-7, atol=0)


def test_error_feedback_matches_jax_over_steps():
    shapes = tree(0)
    tres = params_from_numpy(jax.tree.map(np.zeros_like, shapes), "cpu")
    jres = jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, shapes))
    for i in range(3):
        g = tree(30 + i)
        tq, ts, tres = TO.error_feedback_update(params_from_numpy(g, "cpu"),
                                                tres)
        jq, js, jres = JO.error_feedback_update(
            jax.tree.map(jnp.asarray, g), jres)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a.numpy(), b), tq, np_tree(jq))
        assert_tree_close(ts, js, rtol=1e-7, atol=0)
        assert_tree_close(tres, jres, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Ports of the JAX package's own optimizer tests
# ---------------------------------------------------------------------------


class TestAdamW:
    def test_converges_on_quadratic(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        state = TO.adamw_init(params)
        target = torch.tensor([1.0, 2.0])
        for _ in range(300):
            w = params["w"].detach().requires_grad_(True)
            (g,) = torch.autograd.grad(((w - target) ** 2).sum(), [w])
            params, state = TO.adamw_update(params, {"w": g}, state, lr=0.1,
                                            weight_decay=0.0)
        np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                                   atol=1e-2)

    def test_state_shapes_match_params(self):
        params = {"a": torch.zeros((3, 4)), "b": {"c": torch.zeros((5,))}}
        st = TO.adamw_init(params)
        assert st.m["a"].shape == (3, 4) and st.m["b"]["c"].shape == (5,)
        assert st.v["a"].dtype == torch.float32
        assert st.step.dtype == torch.int32 and int(st.step) == 0

    def test_clip_by_global_norm(self):
        clipped, norm = TO.clip_by_global_norm(
            {"x": torch.full((4,), 10.0)}, 1.0)
        assert abs(float(norm) - 20.0) < 1e-5
        assert abs(float(clipped["x"].square().sum().sqrt()) - 1.0) < 1e-5

    def test_clip_noop_below_max(self):
        g = {"x": torch.tensor([0.1, 0.2])}
        clipped, _ = TO.clip_by_global_norm(g, 10.0)
        np.testing.assert_allclose(clipped["x"].numpy(), g["x"].numpy())


class TestSchedule:
    def test_warmup_then_decay(self):
        kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100)
        assert float(TO.cosine_schedule(0, **kw)) == 0.0
        assert abs(float(TO.cosine_schedule(10, **kw)) - 1.0) < 1e-6
        assert abs(float(TO.cosine_schedule(100, **kw)) - 0.1) < 1e-6


_SEEDS = [0, 1, 7, 123, 2**31 - 1]


class TestCompressionProperties:
    @pytest.mark.parametrize("seed", _SEEDS)
    @pytest.mark.parametrize("dim", [1, 5, 64])
    def test_error_feedback_telescopes(self, seed, dim):
        """sum(decompressed) + residual == sum(true grads)."""
        rng = np.random.default_rng(seed)
        grads = [torch.from_numpy(rng.normal(size=(dim,)).astype(np.float32))
                 for _ in range(5)]
        residual = torch.zeros((dim,))
        total_true = torch.zeros((dim,))
        total_sent = torch.zeros((dim,))
        for gr in grads:
            q, s, residual = TO.error_feedback_update(gr, residual)
            total_sent = total_sent + TO.decompress_gradients(q, s)
            total_true = total_true + gr
        np.testing.assert_allclose((total_sent + residual).numpy(),
                                   total_true.numpy(), rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("seed", _SEEDS)
    def test_quantisation_bounded_error(self, seed):
        rng = np.random.default_rng(seed)
        g = torch.from_numpy((rng.normal(size=(128,)) * 10).astype(
            np.float32))
        q, s = TO.compress_gradients(g)
        back = TO.decompress_gradients(q, s)
        assert float((back - g).abs().max()) <= float(s) / 2 + 1e-6
