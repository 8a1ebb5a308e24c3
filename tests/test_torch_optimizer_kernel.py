"""The train step's fused update: ``kernels/optimizer.py``'s two kernels.

The CUDA kernels (``csrc/optimizer.cu``) run only on the card, where
``chip_smoke.py`` holds them to the plain versions bit for bit.  Here, on
the CPU:

(a) an f32 numpy emulation of the AdamW kernel's order of operations (one
    IEEE rounding an op, no contraction, p rounded to bf16 to nearest
    even) equals the plain version (``optim.adamw._update_slice``, through
    ``adamw_update`` and the donating ``adamw_update_``) to the bit, on
    CPU tensors: bf16 and f32 params and grads, with and without the clip
    factor, values whose sqrt(v_hat) sits near eps.  One op differs by
    platform: ATen's vectorised f32 ``sqrt`` on the CPU (SLEEF's 0.5-ulp
    routine) is not always correctly rounded, where the card's
    (``sqrt.rn``) and the kernel's ``__fsqrt_rn`` are.  So the emulation
    with the CPU's ``sqrt`` in that one place equals the plain version to
    the bit, and with the IEEE square root it differs only in the
    elements whose CPU square root is one ulp off.  The emulation also
    equals the JAX package's ``adamw_update`` within
    ``test_torch_optim.py``'s tolerances (m and v atol 1e-6, params atol
    1e-5, f32);
(b) an emulation of ``sumsq``'s fixed order of sums (each leaf in chunks
    of ``CHUNK_BYTES``, a block a chunk: threads in the chunk's stride
    order, the xor tree a warp, the warps in order; the last block's sum
    of the partials in chunk order, by groups of four; the launches of
    ``SUMSQ_LEAVES`` leaves in order) within 1e-6 relative of an f64 sum,
    the same bits on every call;
(c) the dispatch: CPU and meta tensors take the plain versions, a CUDA
    stand-in takes the kernels once a leaf (the emulations standing in for
    the launches), other devices and mixes raise; the launch functions
    refuse CPU tensors;
(d) the build lists the source, the wrapper's launch-shape constants are
    the source's, and ``chip_smoke.py``'s expected optimizer launches per
    phase.
"""
import re
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as JO  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import optimizer as K  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32 = np.float32
HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """Each test on one intra-op thread.  ATen's f32 square root on the
    CPU splits a tensor into ``at::parallel_for`` chunks of 2,048 elements,
    and a chunk computed on a pool thread has given other bits than the
    same call on the calling thread (the last third of a 4,099-element
    leaf, in about one run in thirty of this file under ``-n 4``), so the
    plain version would not repeat its own bits; on one thread every
    square root runs on the calling thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Emulations of the kernels' arithmetic
# ---------------------------------------------------------------------------


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 to nearest even, as bits (NaN to 0x7FC0)."""
    u = x.astype(F32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    return np.where(np.isnan(x), np.uint16(0x7FC0), r)


def as_f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def cpu_sqrt(x: np.ndarray) -> np.ndarray:
    """ATen's f32 square root on the CPU, as the plain version takes it."""
    return torch.sqrt(torch.from_numpy(x)).numpy()


def emulate_adamw(p, g, m, v, c1, c2, lr, scale=None, *, b1=0.9, b2=0.95,
                  eps=1e-8, weight_decay=0.1, sqrt=np.sqrt):
    """The kernel's ops on one leaf in numpy f32, each rounded once
    (``sqrt`` the IEEE square root unless given): returns p's new bits
    (int16 for bf16, f32 values else), m2, v2."""
    pf, gf = as_f32(p), as_f32(g)
    m, v = as_f32(m), as_f32(v)
    if scale is not None:
        gf = gf * F32(scale)
    m2 = F32(b1) * m + F32(1 - b1) * gf
    v2 = F32(b2) * v + F32(1 - b2) * (gf * gf)
    mh = m2 / F32(c1)
    vh = v2 / F32(c2)
    delta = mh / (sqrt(vh) + F32(eps)) + F32(weight_decay) * pf
    p2 = pf - F32(lr) * delta
    for a in (m2, v2, p2):
        assert a.dtype == F32
    if p.dtype == torch.bfloat16:
        return bf16_bits(p2).view(np.int16), m2, v2
    return p2, m2, v2


def bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16
            else t).numpy().view(np.int16 if t.dtype == torch.bfloat16
                                 else np.int32)


def emulated_bits(p_new, m2, v2):
    p_bits = p_new.view(np.int16) if p_new.dtype == np.int16 \
        else p_new.view(np.int32)
    return p_bits, m2.view(np.int32), v2.view(np.int32)


def block_sums(a: np.ndarray) -> np.ndarray:
    """Thread 0's ``block_sum`` of each row of 256 thread values: lanes
    by the xor tree (each lane adds its partner), then the 8 warps' lane
    0 in order from 0."""
    w = a.reshape(a.shape[0], K.THREADS // 32, 32).astype(F32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[:, :, lanes ^ o]
    s = np.zeros(a.shape[0], F32)
    for k in range(K.THREADS // 32):
        s = s + w[:, k, 0]
    return s


def emulate_block(values: np.ndarray, width: int) -> F32:
    """One block's sum of ``values`` (f32): thread t adds the groups of
    ``width`` values t, t + 256, ... in order, then the last
    ``size % width`` values one a thread; then ``block_sum``.  A chunk's
    partial (``width`` 8 from an aligned leaf, else 1) and the last
    block's sum of the partials (``width`` 4)."""
    v = np.asarray(values, F32)
    groups = v.size // width
    rounds = -(-groups // K.THREADS)
    body = np.zeros(rounds * K.THREADS * width, F32)
    body[:groups * width] = v[:groups * width]
    body = body.reshape(rounds, K.THREADS, width)
    acc = np.zeros(K.THREADS, F32)
    for r in range(rounds):
        for j in range(width):
            acc = acc + body[r, :, j]      # + 0.0 past the end: exact
    rest = v[groups * width:]
    acc[:rest.size] = acc[:rest.size] + rest
    return block_sums(acc[None, :])[0]


def emulate_sumsq(tensors, aligned: bool = True) -> F32:
    """``sumsq`` over the tensors (f32 or bf16) in the kernel's order:
    ``sumsq_plan``'s launches, each leaf's chunks in order."""
    tensors = [t for t in tensors if t.numel()]
    total = None
    for first, count, chunks in K.sumsq_plan([(t.numel(), t.dtype)
                                              for t in tensors]):
        partials = []
        for t in tensors[first:first + count]:
            sq = np.square(as_f32(t).ravel())
            per = K.sumsq_chunk(t.dtype)
            for o in range(0, sq.size, per):
                partials.append(emulate_block(sq[o:o + per],
                                              K.VEC if aligned else 1))
        assert len(partials) == chunks
        launch = emulate_block(np.array(partials, F32), 4)
        total = launch if total is None else F32(total + launch)
    return total


def near_eps_leaf(seed, n, p_dt, g_dt):
    """Params ~ 0.02, grads log-uniform in 1e-11..1e-7 with random signs,
    v in [0, 1e-18), m ~ 1e-8: sqrt(v_hat) near eps at steps 1-3."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy((0.02 * rng.standard_normal(n)).astype(F32))
    mag = np.exp(rng.uniform(np.log(1e-11), np.log(1e-7), n))
    g = torch.from_numpy((mag * rng.choice([-1.0, 1.0], n)).astype(F32))
    m = torch.from_numpy((1e-8 * rng.standard_normal(n)).astype(F32))
    v = torch.from_numpy((1e-18 * rng.random(n)).astype(F32))
    return p.to(p_dt), g.to(g_dt), m, v


def tree_of(seed, p_dt, g_dt, g_scale=1.0):
    """A stacked leaf, a matrix and a vector: params, grads, m, v."""
    rng = np.random.default_rng(seed)

    def f(scale, *shape):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(F32))
    params = {"layers": {"w": f(0.05, 3, 6, 5).to(p_dt),
                         "b": f(0.05, 3, 5).to(p_dt)},
              "embed": f(0.05, 7, 4).to(p_dt), "norm": f(0.05, 4).to(p_dt)}
    grads = {"layers": {"w": f(g_scale, 3, 6, 5).to(g_dt),
                        "b": f(g_scale, 3, 5).to(g_dt)},
             "embed": f(g_scale, 7, 4).to(g_dt),
             "norm": f(g_scale, 4).to(g_dt)}
    m = {"layers": {"w": f(0.01, 3, 6, 5), "b": f(0.01, 3, 5)},
         "embed": f(0.01, 7, 4), "norm": f(0.01, 4)}
    v = {"layers": {"w": f(1e-4, 3, 6, 5).abs(), "b": f(1e-4, 3, 5).abs()},
         "embed": f(1e-4, 7, 4).abs(), "norm": f(1e-4, 4).abs()}
    return params, grads, m, v


# ---------------------------------------------------------------------------
# (a) the AdamW kernel's arithmetic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p_dt", DTYPES, ids=["p_f32", "p_bf16"])
@pytest.mark.parametrize("g_dt", DTYPES, ids=["g_f32", "g_bf16"])
@pytest.mark.parametrize("clip", [None, 0.37], ids=["noclip", "clip"])
@pytest.mark.parametrize("step", [1, 3])
def test_emulated_update_is_the_plain_version_bit_for_bit(p_dt, g_dt, clip,
                                                          step):
    """Near eps, every dtype pair, with and without the clip factor: the
    emulation with the CPU's square root equals ``_update_slice`` (the
    plain version) to the bit; with the IEEE square root (the kernel's) p
    differs only where the CPU's square root is one ulp off."""
    p, g, m, v = near_eps_leaf(step, 4099, p_dt, g_dt)
    c1, c2 = TA._bias_corrections(torch.tensor(step, dtype=torch.int32),
                                  HP["b1"], HP["b2"])
    lr = torch.tensor(3e-4)
    scale = None if clip is None else torch.tensor(clip)
    args = (p, g, m, v, float(c1), float(c2), float(lr),
            None if scale is None else float(scale))
    want = [bits(t) for t in TA._update_slice(
        p, g, m, v, c1, c2, lr, HP["b1"], HP["b2"], HP["eps"],
        HP["weight_decay"], scale)]
    for a, b in zip(emulated_bits(*emulate_adamw(*args, sqrt=cpu_sqrt)),
                    want):
        np.testing.assert_array_equal(a, b)
    gf = as_f32(g) * (F32(1) if scale is None else F32(scale))
    vh = (F32(HP["b2"]) * as_f32(v) + F32(1 - HP["b2"]) * (gf * gf)) \
        / F32(c2)
    assert np.median(np.sqrt(vh)) < 1e-7        # the near-eps regime
    cpu, ieee = cpu_sqrt(vh).view(np.int32), np.sqrt(vh).view(np.int32)
    assert np.abs(cpu - ieee).max() <= 1
    p_ieee, m_ieee, v_ieee = emulated_bits(*emulate_adamw(*args))
    np.testing.assert_array_equal(m_ieee, want[1])
    np.testing.assert_array_equal(v_ieee, want[2])
    assert np.all((p_ieee == want[0]) | (cpu != ieee))


@pytest.mark.parametrize("p_dt", DTYPES, ids=["p_f32", "p_bf16"])
@pytest.mark.parametrize("g_dt", DTYPES, ids=["g_f32", "g_bf16"])
@pytest.mark.parametrize("inplace", [False, True],
                         ids=["out_of_place", "in_place"])
def test_emulated_update_is_both_forms_bit_for_bit(p_dt, g_dt, inplace,
                                                   monkeypatch):
    """Over a tree, clip factor given: ``adamw_update`` (out of place, a
    leaf at a time) and ``adamw_update_`` (in place, slices forced small)
    on CPU tensors equal the emulation (with the CPU's square root, over
    the same whole leaves or slices) leaf by leaf to the bit."""
    monkeypatch.setattr(TA, "SLICE_ELEMS", 16)
    params, grads, m, v = tree_of(5, p_dt, g_dt, 3.0)
    state = TO.AdamWState(step=torch.tensor(2, dtype=torch.int32), m=m, v=v)
    c1, c2 = TA._bias_corrections(state.step + 1, HP["b1"], HP["b2"])
    lr = torch.tensor(1e-2)
    scale = TA.clip_scale(TA.global_norm(grads), 1.0)
    four = list(zip(leaves(params), leaves(grads), leaves(m), leaves(v)))
    want = []
    for leaf in four:
        parts = [emulate_adamw(*x, float(c1), float(c2), float(lr),
                               float(scale), sqrt=cpu_sqrt)
                 for x in (TA.slices(*leaf) if inplace else [leaf])]
        want.append([np.concatenate(a) for a in zip(*parts)])
    update = TO.adamw_update_ if inplace else TO.adamw_update
    new_p, new_state = update(params, grads, state, lr=lr, scale=scale)
    assert (new_p is params) == inplace
    got = zip(leaves(new_p), leaves(new_state.m), leaves(new_state.v))
    for w, g3 in zip(want, got):
        for a, b in zip(emulated_bits(*w), g3):
            np.testing.assert_array_equal(a, bits(b).reshape(a.shape))


def test_emulated_update_matches_jax_within_the_optim_tolerances():
    """Three clipped steps of f32 params: the emulation (fed JAX's clip
    scale) against ``repro.optim`` within m, v atol 1e-6, params 1e-5."""
    params, _, _, _ = tree_of(0, torch.float32, torch.float32)
    p_np = {k: (as_f32(x) if not isinstance(x, dict) else
                {k2: as_f32(x2) for k2, x2 in x.items()})
            for k, x in params.items()}
    jp = jax.tree.map(jnp.asarray, p_np)
    jstate = JO.adamw_init(jp)
    ep = jax.tree.map(np.asarray, p_np)
    em = jax.tree.map(np.zeros_like, ep)
    ev = jax.tree.map(np.zeros_like, ep)
    for i in range(3):
        _, g, _, _ = tree_of(20 + i, torch.float32, torch.float32, 0.5)
        g_np = jax.tree.map(as_f32, g)
        lr = 1e-3 * (i + 1)
        jg, gn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g_np), 0.5)
        jp, jstate = JO.adamw_update(jp, jg, jstate, lr=jnp.float32(lr))
        scale = float(min(1.0, 0.5 / max(float(gn), 1e-9)))
        c1 = 1.0 - F32(HP["b1"]) ** F32(i + 1)
        c2 = 1.0 - F32(HP["b2"]) ** F32(i + 1)
        outs = jax.tree.map(
            lambda p, g, m, v: emulate_adamw(
                torch.from_numpy(p), torch.from_numpy(g),
                torch.from_numpy(m), torch.from_numpy(v), c1, c2, lr, scale),
            ep, g_np, em, ev)
        ep = jax.tree.map(lambda o: o[0], outs,
                          is_leaf=lambda o: isinstance(o, tuple))
        em = jax.tree.map(lambda o: o[1], outs,
                          is_leaf=lambda o: isinstance(o, tuple))
        ev = jax.tree.map(lambda o: o[2], outs,
                          is_leaf=lambda o: isinstance(o, tuple))
    close = np.testing.assert_allclose
    jax.tree.map(lambda a, b: close(a, np.asarray(b), rtol=0, atol=1e-6),
                 em, jstate.m)
    jax.tree.map(lambda a, b: close(a, np.asarray(b), rtol=0, atol=1e-6),
                 ev, jstate.v)
    jax.tree.map(lambda a, b: close(a, np.asarray(b), rtol=0, atol=1e-5),
                 ep, jp)


def test_bf16_rounding_is_torchs():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(10000) * 10.0 ** rng.integers(-30, 30, 10000)
         ).astype(F32)
    x[:4] = [np.inf, -np.inf, 0.0, -0.0]
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(bf16_bits(x).view(np.int16), want)


# ---------------------------------------------------------------------------
# (b) sumsq's fixed order
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("aligned", [True, False],
                         ids=["vectors", "elements"])
def test_emulated_sumsq_is_within_1e6_of_an_f64_sum(aligned):
    """Leaves of 3 elements, a tail of 5 after whole vectors, one of five
    whole f32 chunks and a short one (partials not a multiple of four), and
    a bf16 leaf (chunks of twice the elements), f32 and bf16 values, in
    one launch."""
    rng = np.random.default_rng(9)
    f32_chunk = K.sumsq_chunk(torch.float32)
    sizes = (3, 300_005, 5 * f32_chunk + 13)
    leaves = [torch.from_numpy((rng.standard_normal(n)
                                * 10.0 ** rng.uniform(-4, 0)).astype(F32))
              for n in sizes]
    leaves.append(leaves[1].bfloat16())
    assert len(K.sumsq_plan([(t.numel(), t.dtype) for t in leaves])) == 1
    got = emulate_sumsq(leaves, aligned)
    want = sum(float(np.square(as_f32(t).astype(np.float64)).sum())
               for t in leaves)
    assert got.dtype == F32
    assert abs(float(got) - want) <= 1e-6 * want
    assert emulate_sumsq(leaves, aligned) == got      # a fixed order


def test_emulated_sumsq_over_many_launches_is_within_1e6():
    """Past ``SUMSQ_LEAVES`` leaves the call splits into launches in leaf
    order, each adding its total to the last one's: still within 1e-6 of
    an f64 sum, f32 and bf16 leaves mixed."""
    rng = np.random.default_rng(11)
    leaves = [torch.from_numpy(rng.standard_normal(int(n)).astype(F32))
              for n in rng.integers(1, 5000, K.SUMSQ_LEAVES + 7)]
    leaves = [t.bfloat16() if i % 3 == 0 else t
              for i, t in enumerate(leaves)]
    plan = K.sumsq_plan([(t.numel(), t.dtype) for t in leaves])
    assert [(f, c) for f, c, _ in plan] == [(0, K.SUMSQ_LEAVES),
                                           (K.SUMSQ_LEAVES, 7)]
    got = emulate_sumsq(leaves)
    want = sum(float(np.square(as_f32(t).astype(np.float64)).sum())
               for t in leaves)
    assert abs(float(got) - want) <= 1e-6 * want


def test_sumsq_plan():
    f32, bf16 = torch.float32, torch.bfloat16
    c32 = K.CHUNK_BYTES // 4
    assert K.sumsq_chunk(f32) == c32 and K.sumsq_chunk(bf16) == 2 * c32
    assert K.sumsq_plan([(3, f32)]) == [(0, 1, 1)]
    assert K.sumsq_plan([(c32, f32), (c32 + 1, f32), (c32 + 1, bf16)]) \
        == [(0, 3, 4)]
    assert K.sumsq_plan([(1 << 31, bf16)]) == [(0, 1, (1 << 31) // (2 * c32))]
    # lm100m's 11 f32 grads (114.8 M elements) and codeqwen's 16 bf16
    # ones: one launch a step
    many = [(10, f32)] * (2 * K.SUMSQ_LEAVES + 1)
    assert K.sumsq_plan(many) == [(0, K.SUMSQ_LEAVES, K.SUMSQ_LEAVES),
                                  (K.SUMSQ_LEAVES, K.SUMSQ_LEAVES,
                                   K.SUMSQ_LEAVES),
                                  (2 * K.SUMSQ_LEAVES, 1, 1)]


def test_launch_constants_are_the_sources():
    src = (ROOT / "src/repro_torch/csrc/optimizer.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert (const("kThreads"), const("kVec"), const("kChunkBytes"),
            const("kSumsqLeaves")) == (K.THREADS, K.VEC, K.CHUNK_BYTES,
                                       K.SUMSQ_LEAVES)


# ---------------------------------------------------------------------------
# (c) the dispatch
# ---------------------------------------------------------------------------


def _stand_in(device, placements=None):
    return SimpleNamespace(device=torch.device(device),
                           placements=placements)


def test_takes_kernel_by_device():
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    assert K.takes_kernel([cpu, meta]) is False
    assert K.takes_kernel([_stand_in("cuda"), _stand_in("cuda")]) is True
    for device in ("cpu", "meta"):                 # DTensors
        assert K.takes_kernel([_stand_in(device, placements=("Shard(0)",)),
                               cpu]) is False
    with pytest.raises(ValueError, match="DTensor on CUDA"):
        K.takes_kernel([_stand_in("cuda", placements=("Shard(0)",))])
    with pytest.raises(ValueError, match="DTensor on CUDA"):
        K.takes_kernel([_stand_in("cuda"),
                        _stand_in("cuda", placements=("Replicate()",))])
    with pytest.raises(ValueError, match="device xpu"):
        K.takes_kernel([_stand_in("xpu")])
    with pytest.raises(ValueError, match="mix"):
        K.takes_kernel([cpu, _stand_in("cuda")])


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel launch on plain tensors")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_plain_versions(device, monkeypatch):
    monkeypatch.setattr(K, "adamw_update", _refuse)
    monkeypatch.setattr(K, "sumsq", _refuse)
    params, grads, m, v = (
        {k: (t.to(device) if not isinstance(t, dict) else
             {k2: t2.to(device) for k2, t2 in t.items()})
         for k, t in tree.items()}
        for tree in tree_of(1, torch.bfloat16, torch.bfloat16))
    state = TO.AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device), m=m, v=v)
    gn = TA.global_norm(grads)
    assert gn.device.type == device and gn.dtype == torch.float32
    for update in (TO.adamw_update, TO.adamw_update_):
        new_p, new_state = update(params, grads, state, lr=1e-3,
                                  scale=TA.clip_scale(gn, 1.0))
        assert leaves(new_p)[0].device.type == device
        assert leaves(new_state.m)[0].dtype == torch.float32


def _emulating_kernels(monkeypatch):
    """Stand-ins for the two launches on CPU tensors (the emulations),
    counted as the wrappers count, and ``takes_kernel`` true for CPU
    tensors."""
    calls = {"adamw_update": [], "sumsq": 0}

    def adamw(p, g, m, v, c1, c2, lr, b1, b2, eps, wd, scale=None, *,
              inplace):
        calls["adamw_update"].append(inplace)
        pn, m2, v2 = emulate_adamw(p, g, m, v, float(c1), float(c2),
                                   float(lr), None if scale is None
                                   else float(scale), b1=b1, b2=b2, eps=eps,
                                   weight_decay=wd)
        p2 = (torch.from_numpy(pn.copy()).view(torch.bfloat16)
              if p.dtype == torch.bfloat16 else torch.from_numpy(pn))
        outs = (p2.reshape(p.shape), torch.from_numpy(m2).reshape(p.shape),
                torch.from_numpy(v2).reshape(p.shape))
        if not inplace:
            return outs
        for dst, src in zip((p, m, v), outs):
            dst.copy_(src)
        return p, m, v

    def sumsq(tensors):
        calls["sumsq"] += len(K.sumsq_plan([(t.numel(), t.dtype)
                                            for t in tensors if t.numel()]))
        return torch.tensor(emulate_sumsq(tensors))
    monkeypatch.setattr(K, "adamw_update", adamw)
    monkeypatch.setattr(K, "sumsq", sumsq)
    monkeypatch.setattr(K, "takes_kernel", lambda tensors: all(
        t.device.type == "cpu" for t in tensors))
    return calls


@pytest.mark.parametrize("donate", [True, False])
def test_a_kernel_train_step_launches_once_a_leaf(donate, monkeypatch):
    """With the emulations standing in for the kernels (``takes_kernel``
    true), a train step launches the update once a leaf and the norm once
    over every grad, the update in place only when
    donating, leaves a non-donated state alone, and lands within 1e-6 of
    the plain step (the norm's order of sums and the CPU's square root
    differ from the plain version's in the last bits)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.train import train_state_init
    cfg = get_smoke_config("codeqwen15_7b")
    state = train_state_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = {k: torch.from_numpy(x) for k, x in
             synthetic_batch(5, 0, 0, 2, 16, cfg.vocab_size).items()}
    n = len(leaves(state.params))
    before = [t.clone() for t in leaves(state)]
    plain = make_train_step(cfg, warmup_steps=1, donate=False)
    want, wm = plain(state, batch)
    calls = _emulating_kernels(monkeypatch)
    step = make_train_step(cfg, warmup_steps=1, donate=donate)
    got, gm = step(state, batch)
    assert calls["sumsq"] == 1 and calls["adamw_update"] == [donate] * n
    assert float(gm["grad_norm"]) == pytest.approx(float(wm["grad_norm"]),
                                                   rel=1e-6)
    if not donate:     # the out-of-place form leaves the state alone
        assert all(torch.equal(a, b) for a, b in zip(before,
                                                     leaves(state)))
    for a, b in zip(leaves(got.params), leaves(want.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    for a, b in zip(leaves(got.opt), leaves(want.opt)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-12)


def test_non_donating_step_keeps_the_old_clip_then_update_bits():
    """The non-donating step now applies the clip inside the update: the
    same bits as ``clip_by_global_norm`` then the unscaled update."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.train import train_state_init
    from repro_torch.train.steps import _grads
    from repro_torch.models import model as M
    cfg = get_smoke_config("codeqwen15_7b")
    state = train_state_init(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    batch = {k: torch.from_numpy(x) for k, x in
             synthetic_batch(5, 0, 0, 2, 16, cfg.vocab_size).items()}
    for _ in range(2):        # lr is 0 at step 0
        new, _ = make_train_step(cfg, warmup_steps=1)(state, batch)
        _, grads = _grads(lambda p, mb: M.forward_train(p, cfg, mb)[0],
                          state.params, batch)
        clipped, _ = TO.clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(state.opt.step, peak_lr=3e-4, warmup_steps=1,
                             total_steps=1000)
        old_p, old_opt = TO.adamw_update(state.params, clipped, state.opt,
                                         lr=lr)
        for a, b in zip(leaves((new.params, new.opt)),
                        leaves((old_p, old_opt))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        state = new


def test_launch_functions_refuse_cpu_tensors():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        K.adamw_update(p, p, p, p, 1.0, 1.0, 1e-3, 0.9, 0.95, 1e-8, 0.1,
                       inplace=True)
    with pytest.raises(ValueError, match="CUDA"):
        K.sumsq([p])


def test_routes():
    assert K.adamw_route(torch.bfloat16, torch.float32) == "bf16_f32"
    assert [K.adamw_route(p, g) for p in DTYPES for g in DTYPES] == \
        list(K.ADAMW_ROUTES)
    assert [K.sumsq_route([d]) for d in DTYPES] + [K.sumsq_route(DTYPES)] \
        == list(K.SUMSQ_ROUTES)
    with pytest.raises(ValueError, match="float16"):
        K.adamw_route(torch.float16, torch.float32)
    with pytest.raises(ValueError, match="float16"):
        K.sumsq_route([torch.float32, torch.float16])


# ---------------------------------------------------------------------------
# (d) the build and chip_smoke.py's counts
# ---------------------------------------------------------------------------


def test_build_lists_the_optimizer_source():
    assert "optimizer" in _build.KERNEL_SOURCES
    assert (_build.CSRC / "optimizer.cu").exists()


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _routes(adamw: dict, sumsq: dict) -> dict:
    return {"adamw_update": {**dict.fromkeys(K.ADAMW_ROUTES, 0), **adamw},
            "sumsq": {**dict.fromkeys(K.SUMSQ_ROUTES, 0), **sumsq}}


# per phase: tiny (16 leaves) 3 option sets x 4 steps and 4 eager + 4
# graph steps of the bits check; lm100m (11) 40 checkpointed engine + 40
# plain-loop graph + 40 plain-loop eager + 4 resumed + 4 x 40 engine turns
# + 8 bits + 15 pacing steps (307); codeqwen1.5-7b (16) at 16 layers the
# graph, eager, parent-route and plain-gate columns' 4 + 4 + 3 + 3 timed
# and 4 profiled steps and 1 FLOP-counted (19), at 2 layers 8 bits and 4
# remat steps
# (12); the five other families' paths (mamba2 11 leaves, zamba2 19,
# granite 13, whisper 36, chameleon 14), each 8 turns, 2 profiled steps and
# 1 FLOP-counted at full width and 9 bits steps at 2 layers (zamba2 6: 4
# eager, 4 through the graph, 1 profiled): 20 steps a family (step 1's
# grads update nothing), each leaf on
# its own dtype's route (mamba2's and zamba2's A_log, D and dt_bias and
# granite's router are f32), a sumsq launch over their mixed dtypes
# `mixed`; lm20m (11) x train_lm.py's 200 steps; the dry-run's meta
# DTensors none.  The update launches once a leaf a step, the norm once a
# step (a graph's warm-up and replays: the device's count).
FAMILY_STEPS = 11 + 9
FAMILY_LEAVES, FAMILY_F32_LEAVES = 11 + 19 + 13 + 36 + 14, 3 + 3 + 1
EXPECTED_OPTIMIZER_LAUNCHES = {
    "train": _routes({"f32_f32": 20 * 16 + 307 * 11
                      + FAMILY_STEPS * FAMILY_F32_LEAVES,
                      "bf16_bf16": 31 * 16 + FAMILY_STEPS
                      * (FAMILY_LEAVES - FAMILY_F32_LEAVES)},
                     {"f32": 20 + 307, "bf16": 31 + 2 * FAMILY_STEPS,
                      "mixed": 3 * FAMILY_STEPS}),
    "examples": _routes({"f32_f32": 200 * 11}, {"f32": 200}),
    "dryrun": _routes({}, {}),
}


@pytest.mark.parametrize("phase", sorted(EXPECTED_OPTIMIZER_LAUNCHES))
def test_chip_smoke_expected_optimizer_launches(phase):
    cs = _chip_smoke()
    assert cs.expected_optimizer_launches(torch, K, phase) == \
        EXPECTED_OPTIMIZER_LAUNCHES[phase]


def test_chip_smoke_train_steps_are_the_phases_own():
    cs = _chip_smoke()
    assert [(cfg.name, cfg.num_layers, n) for cfg, n in
            cs.optimizer_steps("train")] == [
        ("tiny", 2, 20), ("lm100m", 12, 307), ("codeqwen1.5-7b", 16, 19),
        ("codeqwen1.5-7b", 2, 12), ("mamba2-1.3b", 48, 11),
        ("mamba2-1.3b", 2, 9), ("zamba2-2.7b", 54, 11), ("zamba2-2.7b", 6, 9),
        ("granite-moe-3b-a800m", 32, 11), ("granite-moe-3b-a800m", 2, 9),
        ("whisper-large-v3", 32, 11), ("whisper-large-v3", 2, 9),
        ("chameleon-34b", 4, 11), ("chameleon-34b", 2, 9)]
    assert [(cfg.name, n) for cfg, n in cs.optimizer_steps("examples")] \
        == [("lm20m", 200)]
    assert cs.optimizer_steps("dryrun") == []


def test_chip_smoke_checks_launches_on_host_and_device():
    """``check_phase_launches``: no serve kernel on the host, the train
    kernels by route on the device, and on the host too where no train
    step was captured (``host``); a captured step's host counts (its
    warm-up and capture) are not held."""
    cs = _chip_smoke()
    want = EXPECTED_OPTIMIZER_LAUNCHES["examples"]
    launches = {"flash_attention_bhsd": 0, "adamw_update": 2200,
                "sumsq": 200}
    short = _routes({"f32_f32": 2199}, {"f32": 200})
    for host in (True, False):
        cs.check_phase_launches("examples", launches, want, want, want,
                                host=host)
        for bad in ({**launches, "flash_attention_bhsd": 1},):
            with pytest.raises(SystemExit):
                cs.check_phase_launches("examples", bad, want, want, want,
                                        host=host)
        with pytest.raises(SystemExit):
            cs.check_phase_launches("examples", launches, want, short, want,
                                    host=host)
    with pytest.raises(SystemExit):
        cs.check_phase_launches("examples", launches, short, want, want,
                                host=True)
    captured = _routes({"f32_f32": 2 * 11}, {"f32": 2})
    cs.check_phase_launches("examples", launches, captured, want, want,
                            host=False)
