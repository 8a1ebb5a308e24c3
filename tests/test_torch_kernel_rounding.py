"""The bf16 tensor-core routes' rounding plans, emulated in plain torch.

The bf16 kernels round at points the plain versions do not:
- flash attention: P (the unnormalised softmax weights of each key tile,
  128 keys on the wgmma route, 32 or 64 on the mma route, against the
  running row max) is rounded to bf16 before P V; the row sums stay f32.
- SSD scan, ``mma_bf16`` route: the three f32 operands of its products
  (the state, the weighted score tile (C B^T) o L o dt, and x o w) enter
  as hi + lo bf16 pairs, about 16 mantissa bits; one bf16 rounding of them
  would miss the tolerance (shown below).
- SSD scan, ``wgmma_bf16`` route: x, B and C stay as they are (bf16 shared
  tiles); the f32-valued factors are split hi + lo on the side wgmma takes
  from registers where they have one: the weighted score tile of each
  64 x 64 (query, key) tile, and (B o w)^T in place of B^T (x o w), so x is
  never split.  The chunk-boundary state S_c, carried in f32 from chunk to
  chunk, is the shared-memory B operand of C_i S_c as a hi and a lo bf16
  tile.  Each of the three splits is needed (shown below).
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
from repro_torch.kernels import _build  # noqa: E402
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
    (D = 64, 80 and 128); on mma_bf16 64 at D <= 80, 32 above."""
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
    # zamba2's D = 80 on wgmma_bf16's 128-key tiles at every option
    (1, 4, 4, 17, 33, 80, True, 0, 0.0),         # ragged_17x33 at D=80
    (1, 2, 2, 48, 80, 80, False, 0, 0.0),        # ragged_noncausal, D=80
    (1, 4, 2, 200, 200, 80, True, 16, 50.0),     # window16_cap50, GQA 2:1
    (1, 2, 1, 20, 10, 80, True, 3, 0.0),         # no_visible_key at D=80
    (1, 8, 2, 300, 300, 80, True, 0, 0.0),       # GQA 4:1, 3 kv tiles
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


def ssd_wgmma_emulated(x, dt, a, b, c, chunk, w_op=split, state_op=split,
                       bw_op=split, tile=64):
    """The ``wgmma_bf16`` kernels' arithmetic in their tile order.

    Pass 1 (the state kernel) carries the f32 state over the chunks,
    S_{c+1} = exp(cum_last) S_c + (B_c o w_c)^T x_c, with (B o w) passed
    through ``bw_op``; the state entering each chunk is kept.  Pass 2 (the
    y kernel) takes each chunk's 64-row query tiles i on their own:
    y_i = exp(cum_i) o (C_i state_op(S_c)) + sum over key tiles j <= i of
    w_op(C_i B_j^T o L_ij o dt_j) x_j, L selected where row >= key.  x, B,
    C are bf16-valued; y and the final state are rounded to bf16."""
    B, H, S, P = x.shape
    rep = H // b.shape[1]
    xf, dtf, af = x.float(), dt.float(), a.float()[None, :, None]
    bf = b.float().repeat_interleave(rep, dim=1)
    cf = c.float().repeat_interleave(rep, dim=1)
    state = torch.zeros((B, H, b.shape[-1], P))
    entering = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        entering.append(state)
        cum = torch.cumsum(dtf[:, :, sl] * af, dim=-1)
        w = dtf[:, :, sl] * torch.exp(cum[..., -1:] - cum)
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + torch.einsum("bhjn,bhjp->bhnp",
                                bw_op(bf[:, :, sl] * w[..., None]),
                                xf[:, :, sl]))
    ys = []
    for ci, c0 in enumerate(range(0, S, chunk)):
        sl = slice(c0, c0 + chunk)
        xq, dtq, bq, cq = xf[:, :, sl], dtf[:, :, sl], bf[:, :, sl], cf[:, :, sl]
        cum = torch.cumsum(dtq * af, dim=-1)
        st = state_op(entering[ci])
        for i0 in range(0, chunk, tile):
            rows = torch.arange(i0, min(i0 + tile, chunk))
            y = (torch.exp(cum[..., rows])[..., None]
                 * torch.einsum("bhin,bhnp->bhip", cq[:, :, rows], st))
            for j0 in range(0, i0 + 1, tile):
                keys = torch.arange(j0, min(j0 + tile, chunk))
                scores = torch.einsum("bhin,bhjn->bhij", cq[:, :, rows],
                                      bq[:, :, keys])
                # select, never multiply: exp(cum_i - cum_j) overflows i < j
                L = torch.where(rows[:, None] >= keys[None, :],
                                torch.exp(cum[..., rows, None]
                                          - cum[..., None, keys]), 0.0)
                wts = w_op(scores * L * dtq[..., None, keys])
                y = y + torch.einsum("bhij,bhjp->bhip", wts, xq[:, :, keys])
            ys.append(y)
    return torch.cat(ys, dim=2).bfloat16(), state.bfloat16()


# the wgmma_bf16 route's shapes (P = 64, N = 64 or 128) at the kernel
# phase's options: 2 chunks of 2 query tiles, one chunk, chunks that are no
# multiple of the 64-row tile, groups, strong and weak decay
WGMMA_PLAN_CASES = [
    (1, 2, 1, 128, 64, 128, 64, "normal"),       # mamba2-like, 2 chunks
    (1, 2, 1, 256, 64, 64, 128, "normal"),       # zamba2-like
    (2, 4, 1, 128, 64, 128, 128, "normal"),      # single_chunk
    (1, 3, 1, 192, 64, 64, 96, "normal"),        # ragged tiles, chunk 96
    (2, 4, 2, 64, 64, 64, 16, "normal"),         # groups, chunk 16
    (1, 2, 1, 256, 64, 64, 128, "strong"),       # strong_decay
    (1, 2, 1, 256, 64, 128, 128, "weak"),        # weak_decay
    (1, 2, 1, 512, 64, 128, 256, "weak"),        # weak, the path's chunk
]


@pytest.mark.parametrize("b,h,g,s,p,n,chunk,decay", WGMMA_PLAN_CASES)
def test_ssd_wgmma_rounding_plan(b, h, g, s, p, n, chunk, decay):
    arrs = ssd_inputs(81, b, h, g, s, p, n, decay)
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in arrs)
    y, st = ssd_wgmma_emulated(x.bfloat16(), dt, a, bm.bfloat16(),
                               cm.bfloat16(), chunk)
    y0, st0 = ss.ssd_scan_plain(x, dt, a, bm, cm, chunk)
    within(y.float(), y0)
    within(st.float(), st0)
    rep = h // g
    jy, jst = jax_ssd(*(jnp.asarray(v) for v in (
        arrs[0], arrs[1], arrs[2], np.repeat(arrs[3], rep, axis=1),
        np.repeat(arrs[4], rep, axis=1))), chunk, interpret=True)
    within(y.float(), jy)
    within(st.float(), jst)


@pytest.mark.parametrize("decay", ["normal", "strong", "weak"])
def test_ssd_wgmma_weight_exponents(decay):
    """The y kernel forms exp(cum_r - cum_k) dt_k as one ex2 of the
    difference of two f32 exponents that the state kernel writes, cum_r
    log2(e) and cum_k log2(e) - log2(dt_k): never for r < k, never as
    exp(cum_r) exp(-cum_k).  With strong decay (|cum| ~ 1e4) the rounding of
    the exponents moves a weight by ~1e-3 of itself, far inside 2e-2."""
    _, dt, a, _, _ = ssd_inputs(83, 1, 2, 1, 256, 64, 64, decay)
    dt, a = torch.from_numpy(dt), torch.from_numpy(a)
    cum = torch.cumsum(dt * a[None, :, None], dim=-1)          # f32
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    rows = cum * log2e
    keys = cum * log2e - torch.log2(dt)
    lower = torch.ones((256, 256), dtype=torch.bool).tril()
    got = torch.where(lower, torch.exp2(rows[..., :, None]
                                        - keys[..., None, :]), 0.0)
    want = torch.where(lower, torch.exp(cum.double()[..., :, None]
                                        - cum.double()[..., None, :])
                       * dt.double()[..., None, :], 0.0)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.double(), want, rtol=2e-3, atol=1e-30)


@pytest.mark.parametrize("rounded", ["w", "state", "bw"])
def test_ssd_wgmma_each_split_is_needed(rounded):
    """With weak decay (|y| and the state in the tens) one bf16 rounding
    of any one of the three split operands, the others split, misses the
    tolerance: each split of the plan is needed."""
    arrs = ssd_inputs(81, 1, 2, 1, 256, 64, 128, "weak")
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in arrs)
    y0, st0 = ss.ssd_scan_plain(x, dt, a, bm, cm, 128)
    y, st = ssd_wgmma_emulated(x.bfloat16(), dt, a, bm.bfloat16(),
                               cm.bfloat16(), 128,
                               **{f"{rounded}_op": bf16})
    with pytest.raises(AssertionError):
        within(y.float(), y0)


def test_ssd_wgmma_emulation_without_splits_is_the_plain_version():
    """With every operand in f32 the tiled two-pass emulation is the plain
    version up to f32 order and the final bf16 rounding."""
    arrs = ssd_inputs(82, 1, 2, 1, 192, 64, 64, "normal")
    x, dt, a, bm, cm = (torch.from_numpy(v) for v in arrs)
    y, st = ssd_wgmma_emulated(x, dt, a, bm, cm, 96, w_op=lambda t: t,
                               state_op=lambda t: t, bw_op=lambda t: t)
    y0, st0 = ss.ssd_scan_plain(x, dt, a, bm, cm, 96)
    torch.testing.assert_close(y.float(), y0.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(st.float(), st0.float(), atol=1e-2,
                               rtol=1e-2)


# ----------------------------------------------------------------- routes

# (dtype, head dim, flash's route, the SSD scan's route); None: refused.
# Flash reads the head dim: bf16 at D = 64 and 128 runs wgmma_bf16, f32 at
# D <= 128 mma_3xtf32 (split-f32 products on the tensor cores).  The
# SSD scan is asked at P = 64 and N = the head dim: bf16 at N = 64 and 128
# runs wgmma_bf16.
ROUTE_CASES = [
    pytest.param(torch.bfloat16, 40, "mma_bf16", "mma_bf16",
                 id="dtype0-mma_bf16"),
    pytest.param(torch.float32, 40, "mma_3xtf32", "scalar_f32",
                 id="dtype1-scalar_f32"),
    pytest.param(torch.float16, 40, None, None, id="dtype2-None"),
    pytest.param(torch.float64, 40, None, None, id="dtype3-None"),
    pytest.param(torch.bfloat16, 64, "wgmma_bf16", "wgmma_bf16",
                 id="bf16-d64-wgmma_bf16"),
    pytest.param(torch.bfloat16, 128, "wgmma_bf16", "wgmma_bf16",
                 id="bf16-d128-wgmma_bf16"),
    pytest.param(torch.bfloat16, 8, "mma_bf16", "mma_bf16",
                 id="bf16-d8-mma_bf16"),
    pytest.param(torch.bfloat16, 80, "wgmma_bf16", "mma_bf16",
                 id="bf16-d80-mma_bf16"),
    pytest.param(torch.bfloat16, 256, "mma_bf16", "mma_bf16",
                 id="bf16-d256-mma_bf16"),
    pytest.param(torch.float32, 64, "mma_3xtf32", "scalar_f32",
                 id="f32-d64-scalar_f32"),
    pytest.param(torch.float32, 128, "mma_3xtf32", "scalar_f32",
                 id="f32-d128-scalar_f32"),
    pytest.param(torch.float32, 256, "scalar_f32", "scalar_f32",
                 id="f32-d256-scalar_f32"),
    pytest.param(torch.float16, 64, None, None, id="f16-d64-None"),
    pytest.param(torch.float64, 128, None, None, id="f64-d128-None"),
]


@pytest.mark.parametrize("mod", [fa, ss], ids=["flash", "ssd"])
@pytest.mark.parametrize("dtype,d,flash_want,ssd_want", ROUTE_CASES)
def test_route_by_dtype(mod, dtype, d, flash_want, ssd_want):
    want = flash_want if mod is fa else ssd_want
    call = (lambda: fa.route(dtype, d)) if mod is fa else \
        (lambda: ss.route(dtype, 64, d))
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
    # flash's f32 route on the tensor cores, mma_3xtf32, is its fourth
    assert set(fn.launches_by_route) == {"wgmma_bf16", "mma_bf16",
                                         "scalar_f32"} | (
        {"mma_3xtf32"} if fn is fa.flash_attention_bhsd else set())
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
    (64, 128, torch.bfloat16, None),             # wgmma_bf16
    (64, 64, torch.bfloat16, None),              # wgmma_bf16
    (64, 264, torch.bfloat16, "N"),
    (64, 12, torch.bfloat16, "multiples of 8"),  # mma_bf16 at P = 64
    (64, 128, torch.float16, "not supported"),
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


# (dtype, P, N, route): the SSD scan's route is a pure function of them
SSD_ROUTE_SHAPES = [
    (torch.bfloat16, 64, 128, "wgmma_bf16"),     # mamba2-1.3b
    (torch.bfloat16, 64, 64, "wgmma_bf16"),      # zamba2-2.7b
    (torch.bfloat16, 64, 48, "mma_bf16"),
    (torch.bfloat16, 64, 256, "mma_bf16"),
    (torch.bfloat16, 32, 128, "mma_bf16"),
    (torch.bfloat16, 128, 128, "mma_bf16"),
    (torch.bfloat16, 16, 8, "mma_bf16"),
    (torch.bfloat16, 40, 48, "mma_bf16"),
    (torch.float32, 64, 128, "scalar_f32"),
    (torch.float32, 64, 64, "scalar_f32"),
    (torch.float32, 8, 4, "scalar_f32"),
]


@pytest.mark.parametrize("dtype,p,n,want", SSD_ROUTE_SHAPES)
def test_ssd_route_by_dtype_p_n(dtype, p, n, want):
    assert ss.route(dtype, p, n) == want
    assert ss.route(dtype, p, n) == ss.route(dtype, p, n)
    assert set(ss.route_kernels({want: 3})) == set(ss.ROUTE_KERNELS[want])
    assert all(v == 3 for v in ss.route_kernels({want: 3}).values())


def test_ssd_route_kernels_are_the_librarys():
    """Every device kernel the library counts belongs to one route, and
    each bf16 route launches two kernels a call."""
    assert sorted(k for ks in ss.ROUTE_KERNELS.values() for k in ks) \
        == sorted(ss.KERNELS)
    assert set(ss.ROUTE_KERNELS) == set(ss.ROUTES)
    assert ss.route_kernels({"wgmma_bf16": 2, "mma_bf16": 0,
                             "scalar_f32": 1}) == {
        "ssd_wg_state_kernel": 2, "ssd_wg_y_kernel": 2, "ssd_f32_kernel": 1}
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    enum = src[src.index("enum Kernel {"):]
    enum = enum[:enum.index("}")]
    order = ["ssd_cbt_kernel", "ssd_mma_kernel", "ssd_wg_state_kernel",
             "ssd_wg_y_kernel", "ssd_f32_kernel"]
    assert list(ss.KERNELS) == order
    assert [t.strip() for t in enum[len("enum Kernel {"):].split(",")][:5] \
        == ["kCbt", "kMma", "kWgState", "kWgY", "kF32"]
    for name in order:
        assert f"{name}(" in src or f"{name}\n(" in src


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", _build.CSRC.parents[2] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_ssd_cases_routes():
    """chip_smoke.py's SSD cases: the route each takes (both path shapes
    on wgmma_bf16; the small bf16 option cases on mma_bf16)."""
    src = (_build.CSRC.parents[2] / "chip_smoke.py").read_text()
    body = src[src.index("def phase_ssd_kernel"):]
    body = body[body.index("cases = ["):body.index("    ]\n") + 6]
    cases = eval(body[len("cases = "):],
                 {"bf16": torch.bfloat16, "f32": torch.float32})
    routes = {c[0]: ss.route(c[8], c[5], c[6]) for c in cases}
    assert routes["mamba2_path"] == routes["zamba2_path"] == "wgmma_bf16"
    assert routes["groups_2_of_4_bf16"] == "mma_bf16"
    assert routes["ragged_c96_p40_n48_bf16"] == "mma_bf16"
    for name in ("single_chunk_bf16", "strong_decay_bf16", "weak_decay_bf16",
                 "ragged_c96_p64_n64_bf16", "groups_2_of_4_c16_p64_bf16"):
        assert routes[name] == "wgmma_bf16"
    assert {r for n, r in routes.items() if cases[[c[0] for c in cases]
            .index(n)][8] == torch.float32} == {"scalar_f32"}
    assert len(cases) == 18


@pytest.mark.parametrize("b,h,s,p,n,chunk,want", [
    # mamba2: 8.4 MB of states, 1 MB of exponents
    (4, 64, 512, 64, 128, 256, 4 * 4 * 64 * 128 * 64 + 8 * 4 * 64 * 512),
    (4, 80, 512, 64, 64, 256, 4 * 4 * 80 * 64 * 64 + 8 * 4 * 80 * 512),
    (2, 3, 192, 64, 64, 96, 4 * 2 * 3 * 64 * 64 + 8 * 2 * 3 * 192),
    (2, 4, 256, 64, 128, 256, 8 * 2 * 4 * 256),             # one chunk
])
def test_ssd_state_scratch_size(b, h, s, p, n, chunk, want):
    assert ss.state_scratch_bytes(b, h, s, p, n, chunk) == want


def test_ssd_wgmma_flops_count():
    """The wgmma route's own work at the mamba2 shape: about 14.5 GFLOP
    with the splits (chip_smoke.ssd_wgmma_flops)."""
    flops = _chip_smoke().ssd_wgmma_flops(4, 64, 1, 512, 128, 256, 2)
    assert flops == 110592 * 2 * 64 * 64 * 16


@pytest.mark.parametrize("chunk,msg", [(8, None), (4, None),
                                       (6, "multiple of 4"),
                                       (2, "multiple of 4")])
def test_ssd_wgmma_route_chunk(chunk, msg):
    """The wgmma route reads cum and dt by TMA in 16-byte rows: its chunk
    must be a multiple of 4; the other routes take any chunk."""
    s = 12 * chunk
    x = torch.zeros((1, 2, s, 64), dtype=torch.bfloat16)
    b = torch.zeros((1, 1, s, 64), dtype=torch.bfloat16)
    args = (x, torch.zeros((1, 2, s)), torch.zeros(2), b, b, chunk)
    if msg is None:
        ss._check(*args)
    else:
        with pytest.raises(ValueError, match=msg):
            ss._check(*args)
    bo = torch.zeros((1, 1, s, 48), dtype=torch.bfloat16)
    ss._check(x, args[1], args[2], bo, bo, chunk)          # mma_bf16


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
