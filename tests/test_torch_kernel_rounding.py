"""The bf16 tensor-core routes' rounding plans, emulated in plain torch.

The bf16 kernels round at points the plain versions do not:
- flash attention: P (the unnormalised softmax weights of each key tile,
  128 keys on the wgmma route, 32 or 64 on the mma route, against the
  running row max) is rounded to bf16 before P V; the row sums stay f32.
- SSD scan: the three f32 operands of its products (the state, the
  weighted score tile (C B^T) o L o dt, and x o w) enter as hi + lo bf16
  pairs, about 16 mantissa bits; one bf16 rounding of them would miss the
  tolerance (shown below).
Each emulation runs at small shapes from a numpy seed and is held to the
bf16 tolerance of ``chip_smoke.py`` (2e-2, absolute plus relative) against
the port's f32 plain version and against the JAX function on the same
bf16-valued inputs.  The CUDA kernels themselves are checked against the
plain versions on the card by ``chip_smoke.py``.  Also here: the pure-Python
route choice ((dtype, head dim) -> kernel instance) and what the kernels
refuse.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_bhsd as jax_ssd  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

TOL = 2e-2          # chip_smoke.py's bf16 tolerance, absolute and relative


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def bf16_values(a):
    """numpy f32 array of the bf16-rounded values of a."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def within(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want),
                                 TOL + TOL * np.abs(want) + 1e-30)


def bf16(t):
    return t.bfloat16().float()


# ------------------------------------------------------------------ flash

def kernel_block_k(d):
    """Keys a kv tile of the bf16 route at head dim d: 128 on wgmma_bf16
    (D = 64 and 128); on mma_bf16 64 at D <= 80, 32 above."""
    if fa.route(torch.bfloat16, d) == "wgmma_bf16":
        return 128
    return 64 if d <= 80 else 32


def flash_emulated(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                   round_p=True):
    """The bf16 kernels' arithmetic: online softmax over key tiles (the
    route's, ``kernel_block_k``), P rounded to bf16 before P V (unless not
    round_p), f32 row sums, output rounded to bf16."""
    b, hq, sq, d = q.shape
    block_k = kernel_block_k(d)
    group = hq // k.shape[1]
    sk = k.shape[2]
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / math.sqrt(d)
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    rows = torch.arange(sq)[:, None]
    cols = torch.arange(sk)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= (rows - cols) < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = torch.full((b, hq, sq), -1e30)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, sk, block_k):
        st = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(st - m_new[..., None])
        l = l * corr + p.sum(-1)
        p_v = bf16(p) if round_p else p
        acc = acc * corr[..., None] + p_v @ vf[:, :, k0:k0 + block_k]
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).bfloat16()


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,window,cap", [
    (2, 4, 4, 128, 128, 128, True, 0, 0.0),      # path-like, 2 kv tiles
    (1, 4, 1, 96, 96, 64, True, 0, 0.0),         # GQA 4:1
    (1, 4, 4, 17, 33, 8, True, 0, 0.0),          # ragged_17x33
    (2, 2, 2, 48, 80, 32, False, 0, 0.0),        # ragged_noncausal
    (1, 4, 2, 200, 200, 64, True, 16, 50.0),     # window16_cap50
    (1, 2, 1, 100, 100, 256, True, 0, 0.0),      # d256
    (1, 2, 1, 20, 10, 8, True, 3, 0.0),          # no_visible_key
    (1, 4, 2, 130, 130, 40, True, 0, 0.0),       # D not a multiple of 16
    (1, 2, 2, 130, 130, 80, True, 0, 0.0),       # zamba2's D=80
    (1, 4, 2, 200, 200, 128, True, 16, 50.0),    # window16_cap50 at D=128
    (1, 2, 1, 20, 10, 128, True, 3, 0.0),        # no_visible_key at D=128
    # the wgmma route's 128-key tiles: several of them, ragged ends
    (1, 4, 2, 300, 300, 128, False, 0, 0.0),     # noncausal, 3 kv tiles
    (1, 4, 4, 17, 33, 64, True, 0, 0.0),         # ragged_17x33 at D=64
    (1, 2, 2, 48, 80, 128, False, 0, 0.0),       # ragged_noncausal, D=128
    (1, 4, 2, 130, 130, 64, True, 0, 0.0),       # 130 keys at D=64
    (1, 2, 1, 20, 10, 64, True, 3, 0.0),         # no_visible_key at D=64
])
def test_flash_rounding_plan(b, hq, hkv, sq, sk, d, causal, window, cap):
    qn, kn, vn = (bf16_values(rnd(seed, shape)) for seed, shape in (
        (70, (b, hq, sq, d)), (71, (b, hkv, sk, d)), (72, (b, hkv, sk, d))))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (qn, kn, vn))
    opts = dict(causal=causal, window=window, logit_cap=cap)
    got = flash_emulated(q, k, v, **opts).float()
    within(got, fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         **opts))
    within(got, jref.mha_reference(jnp.asarray(qn), jnp.asarray(kn),
                                   jnp.asarray(vn), **opts))


def test_flash_emulation_without_rounding_is_the_plain_version():
    """Without the P rounding the online emulation is the plain version up
    to f32 order and the one final bf16 rounding: the bf16 P is the only
    rounding point the kernel adds."""
    q, k, v = (torch.from_numpy(rnd(s, (1, 2, 150, 32))) for s in (73, 74, 75))
    exact = flash_emulated(q, k, v, round_p=False).float()
    want = fa.flash_attention_plain(q, k, v).float()
    torch.testing.assert_close(exact, want, atol=1e-2, rtol=1e-2)
    assert not torch.equal(flash_emulated(q, k, v).float(), exact)


# -------------------------------------------------------------------- ssd

def split(t):
    """t as the sum of its hi and lo bf16 halves."""
    hi = bf16(t)
    return hi + bf16(t - hi)


def ssd_emulated(x, dt, a, b, c, chunk, operand=split):
    """The bf16 kernel's arithmetic: C B^T in f32 from bf16 inputs; the f32
    state (carried in f32), the weighted score tile and x o w passed
    through ``operand`` (the kernel's hi + lo split) before their products;
    y and the final state rounded to bf16."""
    B, H, S, P = x.shape
    rep = H // b.shape[1]
    xf, dtf, af = x.float(), dt.float(), a.float()[None, :, None]
    bf = b.float().repeat_interleave(rep, dim=1)
    cf = c.float().repeat_interleave(rep, dim=1)
    state = torch.zeros((B, H, b.shape[-1], P))
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        xq, dtq, bq, cq = xf[:, :, sl], dtf[:, :, sl], bf[:, :, sl], cf[:, :, sl]
        cum = torch.cumsum(dtq * af, dim=-1)
        L = torch.where(tri, torch.exp(cum[..., :, None] - cum[..., None, :]),
                        0.0)
        w_scores = operand(torch.einsum("bhin,bhjn->bhij", cq, bq) * L
                           * dtq[..., None, :])
        y = (torch.exp(cum)[..., None]
             * torch.einsum("bhin,bhnp->bhip", cq, operand(state))
             + torch.einsum("bhij,bhjp->bhip", w_scores, xq))
        w = dtq * torch.exp(cum[..., -1:] - cum)
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + torch.einsum("bhjn,bhjp->bhnp", bq,
                                operand(xq * w[..., None])))
        ys.append(y)
    return torch.cat(ys, dim=2).bfloat16(), state.bfloat16()


def ssd_inputs(seed, b, h, g, s, p, n, decay):
    x = bf16_values(rnd(seed, (b, h, s, p), 0.5))
    dt = np.log1p(np.exp(rnd(seed + 1, (b, h, s)))).astype(np.float32)
    a = -np.exp(rnd(seed + 2, (h,), 0.3))
    if decay == "strong":            # exp(cum) underflows within a chunk
        a, dt = np.full_like(a, -8.0), dt + 4.0
    elif decay == "weak":            # almost no decay over the sequence
        a = -1e-3 * np.exp(rnd(seed + 3, (h,), 0.3))
    bm = bf16_values(rnd(seed + 4, (b, g, s, n), 0.5))
    cm = bf16_values(rnd(seed + 5, (b, g, s, n), 0.5))
    return x, dt, a.astype(np.float32), bm, cm


@pytest.mark.parametrize("b,h,g,s,p,n,chunk,decay", [
    (1, 2, 1, 128, 64, 128, 64, "normal"),       # path-like, 2 chunks
    (2, 4, 2, 64, 16, 8, 16, "normal"),          # groups_2_of_4
    (1, 2, 1, 128, 64, 64, 128, "normal"),       # single_chunk
    (1, 3, 1, 192, 40, 48, 96, "normal"),        # ragged_c96_p40_n48
    (1, 2, 1, 256, 32, 64, 128, "strong"),       # strong_decay
    (1, 2, 1, 256, 32, 64, 128, "weak"),         # weak_decay
])
def test_ssd_rounding_plan(b, h, g, s, p, n, chunk, decay):
    arrs = ssd_inputs(80, b, h, g, s, p, n, decay)
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in arrs)
    y, st = ssd_emulated(x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16(),
                         chunk)
    y0, st0 = ss.ssd_scan_plain(x, dt, a, bm, cm, chunk)
    within(y.float(), y0)
    within(st.float(), st0)
    rep = h // g
    jy, jst = jax_ssd(*(jnp.asarray(v) for v in (
        arrs[0], arrs[1], arrs[2], np.repeat(arrs[3], rep, axis=1),
        np.repeat(arrs[4], rep, axis=1))), chunk, interpret=True)
    within(y.float(), jy)
    within(st.float(), jst)


def test_ssd_hi_lo_split_keeps_16_bits():
    """hi + lo carries an f32 value to about 16 mantissa bits; hi alone
    (one bf16 rounding) to 8."""
    st = torch.from_numpy(rnd(90, (4096,), 30.0))
    rel_hilo = ((split(st) - st).abs() / st.abs()).max()
    rel_hi = ((bf16(st) - st).abs() / st.abs()).max()
    assert rel_hilo < 2.0 ** -15 < rel_hi


def test_ssd_one_rounding_would_miss_the_tolerance():
    """Why the kernel splits: rounding the weighted scores and x o w to
    bf16 once puts errors of 2^-9 of the typical |y| on every element, and
    with weak decay (|y| in the tens) that breaks 2e-2 where y is near 0."""
    arrs = ssd_inputs(80, 1, 2, 1, 256, 32, 64, "weak")
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in arrs)
    y0, _ = ss.ssd_scan_plain(x, dt, a, bm, cm, 128)
    y, _ = ssd_emulated(x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16(),
                        128, operand=bf16)
    with pytest.raises(AssertionError):
        within(y.float(), y0)


# ----------------------------------------------------------------- routes

# (dtype, head dim, flash's route, the SSD scan's route); None: refused.
# Only flash reads the head dim: bf16 at D = 64 and 128 runs wgmma_bf16.
ROUTE_CASES = [
    pytest.param(torch.bfloat16, 40, "mma_bf16", "mma_bf16",
                 id="dtype0-mma_bf16"),
    pytest.param(torch.float32, 40, "scalar_f32", "scalar_f32",
                 id="dtype1-scalar_f32"),
    pytest.param(torch.float16, 40, None, None, id="dtype2-None"),
    pytest.param(torch.float64, 40, None, None, id="dtype3-None"),
    pytest.param(torch.bfloat16, 64, "wgmma_bf16", "mma_bf16",
                 id="bf16-d64-wgmma_bf16"),
    pytest.param(torch.bfloat16, 128, "wgmma_bf16", "mma_bf16",
                 id="bf16-d128-wgmma_bf16"),
    pytest.param(torch.bfloat16, 8, "mma_bf16", "mma_bf16",
                 id="bf16-d8-mma_bf16"),
    pytest.param(torch.bfloat16, 80, "mma_bf16", "mma_bf16",
                 id="bf16-d80-mma_bf16"),
    pytest.param(torch.bfloat16, 256, "mma_bf16", "mma_bf16",
                 id="bf16-d256-mma_bf16"),
    pytest.param(torch.float32, 64, "scalar_f32", "scalar_f32",
                 id="f32-d64-scalar_f32"),
    pytest.param(torch.float32, 128, "scalar_f32", "scalar_f32",
                 id="f32-d128-scalar_f32"),
    pytest.param(torch.float16, 64, None, None, id="f16-d64-None"),
    pytest.param(torch.float64, 128, None, None, id="f64-d128-None"),
]


@pytest.mark.parametrize("mod", [fa, ss], ids=["flash", "ssd"])
@pytest.mark.parametrize("dtype,d,flash_want,ssd_want", ROUTE_CASES)
def test_route_by_dtype(mod, dtype, d, flash_want, ssd_want):
    want = flash_want if mod is fa else ssd_want
    call = (lambda: fa.route(dtype, d)) if mod is fa else \
        (lambda: ss.route(dtype))
    if want is None:
        with pytest.raises(ValueError, match="not supported"):
            call()
    else:
        assert call() == want


@pytest.mark.parametrize("fn,dtype,d", [
    pytest.param(fa.flash_attention_bhsd, torch.bfloat16, 16, id="flash"),
    pytest.param(ss.ssd_scan_bhsd, torch.bfloat16, 8, id="ssd"),
    pytest.param(fa.flash_attention_bhsd, torch.bfloat16, 64,
                 id="flash-bf16-d64"),
    pytest.param(fa.flash_attention_bhsd, torch.bfloat16, 128,
                 id="flash-bf16-d128"),
    pytest.param(fa.flash_attention_bhsd, torch.bfloat16, 80,
                 id="flash-bf16-d80"),
    pytest.param(fa.flash_attention_bhsd, torch.float32, 128,
                 id="flash-f32-d128"),
])
def test_launch_counts_per_route(fn, dtype, d):
    want = ({"wgmma_bf16", "mma_bf16", "scalar_f32"}
            if fn is fa.flash_attention_bhsd else {"mma_bf16", "scalar_f32"})
    assert set(fn.launches_by_route) == want
    before = dict(fn.launches_by_route)
    if fn is fa.flash_attention_bhsd:
        q = torch.zeros((1, 2, 16, d), dtype=dtype)
        fn(q, q, q)
    else:
        x = torch.zeros((1, 2, 16, d), dtype=dtype)
        b = torch.zeros((1, 1, 16, 8), dtype=dtype)
        fn(x, torch.zeros((1, 2, 16)), torch.zeros(2), b, b, 8)
    assert fn.launches_by_route == before       # the CPU launches nothing


@pytest.mark.parametrize("p,n,dtype,msg", [
    (12, 8, torch.bfloat16, "multiples of 8"),
    (8, 4, torch.bfloat16, "multiples of 8"),
    (12, 4, torch.float32, None),                # scalar route takes any
    (40, 48, torch.bfloat16, None),
    (8, 264, torch.bfloat16, "N"),
])
def test_ssd_kernel_shapes_by_route(p, n, dtype, msg):
    x = torch.zeros((1, 2, 16, p), dtype=dtype)
    b = torch.zeros((1, 1, 16, n), dtype=dtype)
    args = (x, torch.zeros((1, 2, 16)), torch.zeros(2), b, b, 8)
    if msg is None:
        ss._check(*args)
    else:
        with pytest.raises(ValueError, match=msg):
            ss._check(*args)


@pytest.mark.parametrize("b,g,s,chunk,want", [
    (4, 1, 512, 256, 4 * 2 * 10 * 4096),     # mamba2: 1.3 MB
    (2, 3, 192, 96, 2 * 3 * 2 * 3 * 4096),
    (1, 2, 64, 16, 1 * 2 * 4 * 1 * 4096),
])
def test_ssd_scratch_size(b, g, s, chunk, want):
    assert ss.scratch_numel(b, g, s, chunk) == want


@pytest.mark.parametrize("d", [8, 40, 64, 80, 128, 136, 256])
def test_flash_takes_every_head_dim_on_both_routes(d):
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros((1, 2, 16, d), dtype=dtype)
        fa._check(q, q, q, 0)
