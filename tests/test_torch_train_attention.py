"""The train step's attention: ``kernels/train_attention.py`` and the plain
core it shares with the model (``kernels/ref.py`` ``attention_core``).

The CUDA kernels (``csrc/train_attention.cu``) run only on the card, where
``chip_smoke.py`` holds them to the plain version at the tolerance stated
below.  Here, on the CPU, at small sizes:

(a) the plain core (the plain route of ``models.attention._attend`` and
    the kernels' plain version) against the JAX package's training
    attention (``_gqa_scores``, ``softcap``, the mask, ``jax.nn.softmax``,
    ``_gqa_out``): o and its vjp (dq, dk, dv) from the same numpy inputs,
    every option of chip_smoke's cases (causal and not, a window with a
    cap, GQA 6:1 and 3:1, D 16 to 128, S != T, S not a multiple of the
    tile), in f32, in bf16 and with bf16 q against f32 k and v.  f32:
    within 1e-5 x max|b| (the same f32 ops, summed in other orders); bf16
    results are one rounding of f32 values that agree that closely, so
    within one bf16 ulp (2^-7 |b|) plus 1e-5 x max|b|;
(b) an emulation of the kernels' arithmetic (the online softmax and its
    log-sum-exp, P recomputed from it in the backward, delta = rowsum(dO
    o32), P and dS as hi + lo bf16 halves against exact bf16 operands on
    the bf16 routes, every f32 operand as a TF32 big part and its TF32
    remainder on ``mma_3xtf32`` (three products, small terms first, a
    tile's product summed before it joins the sum), f32 sums, each result
    rounded once), its tile sizes
    and sum order parameters: ``mma_bf16``'s (64-row query tiles and
    64-key tiles, 16-row dK dV tiles at D = 128, each tile's hi and lo
    products summed before they join the sum), ``wgmma_bf16``'s (128-row
    forward and dQ items over 64-key tiles, 64-row dK dV tiles, hi then lo
    joining the running sum 16 deep at a time), ``mma_3xtf32``'s (32-row
    query tiles, 32-key tiles, 32-row dK dV tiles, 16 past D 64, each
    block's tiles dealt to two warps and merged) and ``scalar_f32``'s,
    against JAX's f32 values at chip_smoke's tolerance: bf16 within 2^-8
    |b| (half an ulp) + 1e-5 x max|b|, f32 within 1e-5 x max|b|; P rounded
    once to bf16, as the serve flash routes do, misses it, and so does one
    TF32 rounding of each f32 operand;
(c) the choice: calls autograd records on CUDA take the kernels (the
    emulation standing in for the launches, a train step through them
    close to the plain step, a forward launch twice under remat) when
    their positions are stated ``arange``, and masked calls on other
    positions the plain ops, held to JAX's ``attention``; CPU and
    meta tensors and DTensors on them take the plain ops, a DTensor on
    CUDA raises, unrecorded calls stay plain, the serve kernels still
    refuse grad; the wrapper's routes and checks;
(d) the build lists the source and the old routes' builds; chip_smoke.py's
    expected launches.
"""
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, NamedTuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.models.common import softcap as jax_softcap  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import train_attention as TA  # noqa: E402
from repro_torch.kernels.ref import attention_core  # noqa: E402
from repro_torch.models import attention as MA  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TILE = 64            # the kernels' query and key tiles
REL_TOL = 1e-5       # x max|b|: chip_smoke.TA_REL_TOL


class Plan(NamedTuple):
    """A route's tiles and sum order: query rows a forward / dQ tile
    (keys a dK dV block), keys a tile, query rows a dK dV tile (by head
    dim), how a split product joins its sum: "tile" (the whole tile's
    pieces summed, then added) or "k16" (hi then lo into the running sum,
    16 deep at a time), and the halves a block's tiles (items) are dealt
    to in turns, each with its own softmax or sum, merged at the end
    (``x3::merge_softmax``, ``x3::merge_sum``)."""
    rows: int
    keys: int
    dkdv_rows: Callable[[int], int]
    order: str
    halves: int = 1          # warps a strip splits its tiles (items) among


class Route(NamedTuple):
    """A route's tile plan and how its products round their operands
    (``halves``)."""
    plan: Plan
    split: object


# csrc/train_attention.cu: mma_bf16 (dkdv_rows<DP>: 16 rows past D 80)
# and wgmma_bf16 (kWgItem, kWgTile)
MMA_PLAN = Plan(TILE, TILE, lambda d: 16 if d > 80 else TILE, "tile")
WGMMA_PLAN = Plan(128, TILE, lambda d: TILE, "k16")
# mma_3xtf32 (kX3Rows, x3::kKeys, x3_item_rows: 16 past D 64, where D is
# padded to 128) and scalar_f32 (64-row tiles at D <= 128: its sums in f32
# FMAs, emulated as exact f32 products)
X3_PLAN = Plan(32, 32, lambda d: 32 if d <= 64 else 16, "tile", halves=2)
SCALAR_PLAN = Plan(TILE, TILE, lambda d: TILE, "tile")
ROUTE_MATH = {"mma_bf16": Route(MMA_PLAN, True),
              "wgmma_bf16": Route(WGMMA_PLAN, True),
              "mma_3xtf32": Route(X3_PLAN, "3xtf32"),
              "scalar_f32": Route(SCALAR_PLAN, None)}
BF16_HALF_ULP = 2.0 ** -8
BF16_ULP = 2.0 ** -7

# (name, B, S, T, Hq, Hkv, D, causal, window, cap): chip_smoke's options at
# CPU sizes; 72 and 136 rows cross a 64-row tile
CASES = (
    ("gqa6_d128", 1, 72, 72, 6, 1, 128, True, 0, 0.0),
    ("gqa3_d64", 2, 72, 72, 6, 2, 64, True, 0, 0.0),
    ("mha_d80", 1, 72, 72, 2, 2, 80, True, 0, 0.0),
    ("window40_cap5", 1, 136, 136, 4, 2, 64, True, 40, 5.0),
    ("cap5", 1, 72, 72, 4, 2, 64, True, 0, 5.0),
    ("cross", 2, 40, 72, 4, 4, 64, False, 0, 0.0),
    ("encoder_d16", 2, 72, 72, 4, 4, 16, False, 0, 0.0),
)


def draw(case, seed: int = 0):
    """q, k, v and the grad of o as f32 numpy arrays; the capped cases'
    scores spread past the cap."""
    _, B, S, T, Hq, Hkv, D, _, _, cap = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D), dtype=np.float32)
    if cap:
        q *= 4
    k = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    v = rng.standard_normal((B, T, Hkv, D), dtype=np.float32)
    do = rng.standard_normal((B, S, Hq, D), dtype=np.float32)
    return q, k, v, do


def opts_of(case) -> dict:
    return dict(causal=case[7], window=case[8], logit_cap=case[9])


def jax_core(q, k, v, *, causal, window, logit_cap):
    """The reference's training attention core, its lines as written."""
    scores = JA._gqa_scores(q, k, None)
    scores = jax_softcap(scores, logit_cap)
    S, T = q.shape[1], k.shape[1]
    qpos = jnp.arange(S)[None, :][:, None, None, :, None]
    kpos = jnp.arange(T)[None, :][:, None, None, None, :]
    mask = jnp.ones_like(scores, dtype=bool)
    if causal:
        mask = mask & (kpos <= qpos)
    if window:
        mask = mask & (qpos - kpos < window)
    scores = jnp.where(mask, scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1)
    return JA._gqa_out(probs, v)


def jax_vjp(q, k, v, do, opts):
    """JAX's o, (dq, dk, dv) and per-row log-sum-exp, as f32 numpy."""
    o, vjp = jax.vjp(lambda a, b, c: jax_core(a, b, c, **opts), q, k, v)
    grads = vjp(jnp.asarray(do, o.dtype))
    qf, kf = jnp.asarray(q, jnp.float32), jnp.asarray(k, jnp.float32)
    s = jax_softcap(JA._gqa_scores(qf, kf, None), opts["logit_cap"])
    S, T = q.shape[1], k.shape[1]
    rows, cols = np.arange(S)[:, None], np.arange(T)[None, :]
    seen = np.ones((S, T), bool)
    if opts["causal"]:
        seen &= cols <= rows
    if opts["window"]:
        seen &= rows - cols < opts["window"]
    lse = jax.nn.logsumexp(jnp.where(seen, s, -1e30), axis=-1)
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return (f32(o), [f32(g) for g in grads],
            f32(lse).reshape(q.shape[0], q.shape[2], S))


def to_torch(x: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def within(got, want, *, ulp: float) -> None:
    """|got - want| <= ulp |want| + 1e-5 max|want|, elementwise."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = ulp * np.abs(want) + REL_TOL * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), (
        f"{bad.sum()} of {bad.size} off; worst "
        f"{np.abs(got - want).max()} at max|b| {np.abs(want).max()}")


DTYPE_MODES = {"f32": (torch.float32, torch.float32, jnp.float32,
                       jnp.float32),
               "bf16": (torch.bfloat16, torch.bfloat16, jnp.bfloat16,
                        jnp.bfloat16),
               "mixed": (torch.bfloat16, torch.float32, jnp.bfloat16,
                         jnp.float32)}
MODE_CASES = [(c, m) for c in CASES for m in ("f32", "bf16")] + \
    [(c, "mixed") for c in CASES if c[0] == "cross"]


# ---------------------------------------------------------------------------
# (a) the plain core against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,mode", MODE_CASES,
                         ids=[f"{c[0]}-{m}" for c, m in MODE_CASES])
def test_plain_core_and_its_vjp_match_jax(case, mode):
    q, k, v, do = draw(case)
    tq, tkv, jq, jkv = DTYPE_MODES[mode]
    opts = opts_of(case)
    jo, jgrads, _ = jax_vjp(jnp.asarray(q, jq), jnp.asarray(k, jkv),
                            jnp.asarray(v, jkv), do, opts)
    leaves = [to_torch(q, tq).requires_grad_(True),
              to_torch(k, tkv).requires_grad_(True),
              to_torch(v, tkv).requires_grad_(True)]
    o = kops.train_attention(*leaves, **opts)        # CPU: the plain core
    assert o.dtype == torch.float32
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    within(o, jo, ulp=0.0)
    for g, jg, leaf in zip(grads, jgrads, leaves):
        assert g.dtype == leaf.dtype
        within(g, jg, ulp=BF16_ULP if g.dtype == torch.bfloat16 else 0.0)


def test_attend_plain_route_is_the_core_on_positions():
    """``_attend``'s plain route is ``attention_core`` on the positions it
    is given, bit for bit (the ops the model ran before this module)."""
    case = CASES[3]
    q, k, v, _ = draw(case)
    cfg = SimpleNamespace(attn_softcap=case[9])
    pos = torch.arange(case[2]).expand(case[1], case[2])
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = MA._attend(tq, tk, tv, cfg, pos, case[8], False, causal=True)
    want = attention_core(tq, tk, tv, pos, causal=True, window=case[8],
                          logit_cap=case[9])
    assert torch.equal(got, want)
    # the kernels' plain version: the same core at positions arange
    assert torch.equal(TA.train_attention_plain(
        tq, tk, tv, causal=True, window=case[8], logit_cap=case[9]), want)


# ---------------------------------------------------------------------------
# (b) the kernels' arithmetic, emulated
# ---------------------------------------------------------------------------


TF32_SPLITS = ("3xtf32", "tf32")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero): ``cvt.rna.tf32.f32`` with the low 13 bits cleared
    (``x3::tf32``)."""
    mag = x.float().abs().contiguous().view(torch.int32)
    r = ((mag + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(x < 0, -r, r)


def halves(x: torch.Tensor, split):
    """The pieces an f32 tile enters a product as, in f32: hi and lo bf16
    halves (``tc::pack_split_bf16``: split True), one bf16 rounding
    (False), a TF32 big part and its TF32 remainder ("3xtf32",
    ``x3::split``), one TF32 rounding ("tf32") or f32 itself (None)."""
    if split is None:
        return [x]
    if split in TF32_SPLITS:
        big = tf32(x)
        return [big, tf32(x - big)] if split == "3xtf32" else [big]
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()] if split else [hi]


def pieces(a: torch.Tensor, b: torch.Tensor, split) -> tuple:
    """The operands' pieces: a's ``halves``, and b's on the TF32 routes
    (else b as it is: exact bf16 values)."""
    return halves(a, split), (halves(b, split) if split in TF32_SPLITS
                              else [b])


def terms(pa: list, pb: list, split) -> list:
    """The tensor cores' products of pieces ``pa`` and ``pb`` that make
    a @ b, in the order they join a sum: 3xTF32's small a x big b, big a x
    small b, big x big (small x small dropped: ``x3::mma3``); else each of
    a's pieces against b."""
    if split == "3xtf32":
        return [pa[1] @ pb[0], pa[0] @ pb[1], pa[0] @ pb[0]]
    return [h @ pb[0] for h in pa]


def product(a: torch.Tensor, b: torch.Tensor, split) -> torch.Tensor:
    """a @ b from ``terms``, summed in f32."""
    return sum(terms(*pieces(a, b, split), split))


def accumulate(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, split,
               order: str) -> torch.Tensor:
    """acc + a @ b in a plan's order: "tile" adds the tile's product
    (``product``: ``x3::product_nn`` sums a tile in a fresh accumulator),
    "k16" adds each 16-deep slice's ``terms`` to the running sum one by
    one."""
    if order == "tile":
        return acc + product(a, b, split)
    pa, pb = pieces(a, b, split)
    for k0 in range(0, a.shape[-1], 16):
        for term in terms([x[..., k0:k0 + 16] for x in pa],
                          [x[..., k0:k0 + 16, :] for x in pb], split):
            acc = acc + term
    return acc


def raw_product(a: torch.Tensor, b: torch.Tensor, split) -> torch.Tensor:
    """Q K^T or dO V^T: f32 on the TF32 routes' pieces, else exact (bf16
    values, or scalar f32)."""
    return product(a, b, split if split in TF32_SPLITS else None)


def scales(opts, D) -> dict:
    """The wrapper's f32 reciprocals of sqrt(D) and the cap."""
    _, inv_cap, inv_sqrt_d = TA._scales(opts["logit_cap"], D)
    return {"inv_sqrt_d": np.float32(inv_sqrt_d),
            "inv_cap": np.float32(inv_cap)}


def tile_scores(a, qt, kt, rows, cols, opts, split=None):
    """The kernels' ``masked_score`` of a (rows, cols) tile: the raw
    products (``raw_product``) times 1 / sqrt(D), the cap, -1e30 where the
    mask hides the pair; and the tanh for the backward."""
    x = raw_product(qt, kt.transpose(-1, -2), split) * a["inv_sqrt_d"]
    th = torch.zeros_like(x)
    if opts["logit_cap"]:
        th = torch.tanh(x * a["inv_cap"])
        x = opts["logit_cap"] * th
    r, c = rows[:, None], cols[None, :]
    seen = torch.ones_like(x, dtype=torch.bool)
    if opts["causal"]:
        seen &= c <= r
    if opts["window"]:
        seen &= r - c < opts["window"]
    return x.masked_fill(~seen, -1e30), th


def key_range(S, T, q0, opts, rows=TILE, keys=TILE):
    """The key tiles [begin, end) of ``keys`` keys that a query tile of
    ``rows`` rows from q0 walks (the kernels' ``key_tiles``)."""
    q_last = min(q0 + rows, S) - 1
    end = min(T, q_last + 1) if opts["causal"] else T
    begin = max(0, q0 - opts["window"] + 1) if opts["window"] else 0
    return begin // keys, -(-end // keys)


def query_range(S, T, k0, opts, keys, rows):
    """The query tiles [begin, end) of ``rows`` rows that see some key of
    the key block [k0, k0 + keys) (the kernels' ``query_tiles``)."""
    k_last = min(k0 + keys, T) - 1
    q_begin = k0 if opts["causal"] else 0
    q_end = min(S, k_last + opts["window"]) if opts["window"] else S
    begin = q_begin // rows
    return begin, (-(-q_end // rows) if q_end > q_begin else begin)


def dealt(seq, plan):
    """``seq`` dealt to the plan's halves in turns: one list a half."""
    return [list(seq)[hh::plan.halves] for hh in range(plan.halves)]


def emulate_forward(q, k, v, opts, split, plan=MMA_PLAN):
    """The forward kernel on (B, S, H, D) tensors of the route's dtype:
    (o in it, o32, lse (B, Hq, S)), in ``plan``'s tiles and sum order."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    a = scales(opts, D)
    qf, kf, vf = q.float(), k.float(), v.float()
    o32 = torch.zeros((B, S, Hq, D))
    lse = torch.zeros((B, Hq, S))
    for h in range(Hq):
        for q0 in range(0, S, plan.rows):
            rows = torch.arange(q0, min(q0 + plan.rows, S))
            state = []
            for tiles in dealt(range(*key_range(S, T, q0, opts, plan.rows,
                                                plan.keys)), plan):
                m = torch.full((B, len(rows)), -float("inf"))
                l = torch.zeros((B, len(rows)))
                acc = torch.zeros((B, len(rows), D))
                for it in tiles:
                    cols = torch.arange(it * plan.keys,
                                        min(it * plan.keys + plan.keys, T))
                    x, _ = tile_scores(a, qf[:, rows, h],
                                       kf[:, cols, h // G], rows, cols,
                                       opts, split)
                    mx = torch.maximum(m, x.max(-1).values)
                    corr = torch.exp(m - mx)
                    p = torch.exp(x - mx[..., None])
                    l = l * corr + p.sum(-1)
                    acc = accumulate(acc * corr[..., None], p,
                                     vf[:, cols, h // G], split, plan.order)
                    m = mx
                state.append((m, l, acc))
            m, l, acc = state[0]
            for m1, l1, acc1 in state[1:]:       # x3::merge_softmax
                mx = torch.maximum(m, m1)
                c0, c1 = torch.exp(m - mx), torch.exp(m1 - mx)
                l = l * c0 + l1 * c1
                acc = acc * c0[..., None] + acc1 * c1[..., None]
                m = mx
            o32[:, rows, h] = acc / l[..., None]
            lse[:, h, rows] = m + torch.log(l)
    return o32.to(q.dtype), o32, lse


def emulate_backward(q, k, v, o32, lse, do, opts, split, plan=MMA_PLAN):
    """The delta, dQ and dK dV kernels: (dq, dk, dv) in the route's
    dtype, each summed in f32 in ``plan``'s tiles and order and rounded
    once: dq over the key tiles of each query tile, dk and dv over the G
    query heads of their kv head in order, then their dK dV query tiles
    (with halves: each half's tiles or items summed apart, then added)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    a = scales(opts, D)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o32).sum(-1).permute(0, 2, 1)        # (B, Hq, S)
    dq = torch.zeros((B, S, Hq, D))
    dk = torch.zeros((B, T, Hkv, D))
    dv = torch.zeros((B, T, Hkv, D))
    cap = opts["logit_cap"]

    def grads(h, rows, cols):
        hk = h // G
        x, th = tile_scores(a, qf[:, rows, h], kf[:, cols, hk], rows, cols,
                            opts, split)
        p = torch.exp(x - lse[:, h, rows][..., None])
        dp = raw_product(dof[:, rows, h], vf[:, cols, hk].transpose(-1, -2),
                         split)
        g = p * (dp - delta[:, h, rows][..., None])
        if cap:
            g = (g * cap) * (1 - th * th) * a["inv_cap"]
        return p, g * a["inv_sqrt_d"]

    for h in range(Hq):
        for q0 in range(0, S, plan.rows):            # dQ
            rows = torch.arange(q0, min(q0 + plan.rows, S))
            parts = []
            for tiles in dealt(range(*key_range(S, T, q0, opts, plan.rows,
                                                plan.keys)), plan):
                part = torch.zeros((B, len(rows), D))
                for it in tiles:
                    cols = torch.arange(it * plan.keys,
                                        min(it * plan.keys + plan.keys, T))
                    _, g = grads(h, rows, cols)
                    part = accumulate(part, g, kf[:, cols, h // G], split,
                                      plan.order)
                parts.append(part)
            dq[:, rows, h] = sum(parts[1:], parts[0])
    qr = plan.dkdv_rows(D)
    if plan.halves == 1:
        for h in range(Hq):                           # dK dV
            hk = h // G
            for q0 in range(0, S, qr):
                rows = torch.arange(q0, min(q0 + qr, S))
                tb, te = key_range(S, T, q0, opts, qr, 1)
                cols = torch.arange(tb, te)
                p, g = grads(h, rows, cols)
                dv[:, cols, hk] = accumulate(dv[:, cols, hk],
                                             p.transpose(-1, -2),
                                             dof[:, rows, h], split,
                                             plan.order)
                dk[:, cols, hk] = accumulate(dk[:, cols, hk],
                                             g.transpose(-1, -2),
                                             qf[:, rows, h], split,
                                             plan.order)
        return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
    for hk in range(Hkv):          # dK dV by key block, items dealt to halves
        for k0 in range(0, T, plan.rows):
            cols = torch.arange(k0, min(k0 + plan.rows, T))
            qb, qe = query_range(S, T, k0, opts, plan.rows, qr)
            items = [(hk * G + gi, qt) for gi in range(G)
                     for qt in range(qb, qe)]
            parts = []
            for mine in dealt(items, plan):
                pk = torch.zeros((B, len(cols), D))
                pv = torch.zeros((B, len(cols), D))
                for h, qt in mine:
                    rows = torch.arange(qt * qr, min(qt * qr + qr, S))
                    p, g = grads(h, rows, cols)
                    pv = accumulate(pv, p.transpose(-1, -2),
                                    dof[:, rows, h], split, plan.order)
                    pk = accumulate(pk, g.transpose(-1, -2), qf[:, rows, h],
                                    split, plan.order)
                parts.append((pk, pv))
            for n, out in enumerate((dk, dv)):   # x3::merge_sum
                out[:, cols, hk] = sum((pr[n] for pr in parts[1:]),
                                       parts[0][n])
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# each case on its route: bf16 on its bf16 route, and in mma_bf16's plan
# too where that is wgmma_bf16 (the old route, kept at every shape by
# -DTRAIN_ATTN_FORCE_MMA); f32 and bf16 q against f32 k and v (after the
# wrapper's exact upcast) on mma_3xtf32, and f32 in scalar_f32's plan too
# (D > 128, and every shape under -DTRAIN_ATTN_FORCE_SCALAR)
EMULATED = [(c, m) for c in CASES for m in ("f32", "bf16")]
EMULATED += [(c, "mixed") for c in CASES if c[0] == "cross"]
EMULATED += [(c, "bf16-mma_plan") for c in CASES if c[6] in TA.WGMMA_HEAD_DIMS]
EMULATED += [(c, "f32-scalar_plan") for c in CASES]
OLD_ROUTES = {"bf16-mma_plan": "mma_bf16", "f32-scalar_plan": "scalar_f32"}


def route_inputs(case, mode, seed=1):
    """A case's q, k, v in a mode's dtypes as the kernels receive them
    (f32 after the wrapper's exact upcast on the f32 routes), its grad of
    o in the kernels' dtype, and the wrapper's route."""
    q, k, v, do = draw(case, seed=seed)
    tq_dt, tkv_dt = DTYPE_MODES[mode.split("-")[0]][:2]
    tq, tk, tv = to_torch(q, tq_dt), to_torch(k, tkv_dt), to_torch(v, tkv_dt)
    r = TA.route(tq_dt, tkv_dt, case[6])
    if r in TA.F32_ROUTES:
        tq, tk, tv = tq.float(), tk.float(), tv.float()
    return tq, tk, tv, to_torch(do, tq.dtype), r


def emulate_route(name, q, k, v, do, opts):
    """o, lse and (dq, dk, dv) of route ``name``'s emulated kernels."""
    plan, split = ROUTE_MATH[name]
    o, o32, lse = emulate_forward(q, k, v, opts, split, plan)
    return o, lse, emulate_backward(q, k, v, o32, lse, do, opts, split, plan)


@pytest.mark.parametrize("case,mode", EMULATED,
                         ids=[f"{c[0]}-{m}" for c, m in EMULATED])
def test_emulated_kernels_match_jax_at_the_chip_tolerance(case, mode):
    """The route's arithmetic (the bf16 routes: hi + lo halves in their
    plan's tiles and sum order; mma_3xtf32: every f32 operand as a TF32
    big part and remainder; scalar_f32: f32) against JAX's f32 o, lse and
    grads of the same values."""
    tq, tk, tv, tdo, r = route_inputs(case, mode)
    opts = opts_of(case)
    want = {64: "wgmma_bf16", 128: "wgmma_bf16"}.get(case[6], "mma_bf16")
    assert r == (want if mode.startswith("bf16") else "mma_3xtf32")
    jo, jgrads, jlse = jax_vjp(*(np.asarray(t.float()) for t in (tq, tk, tv)),
                               np.asarray(tdo.float()), opts)
    o, lse, grads = emulate_route(OLD_ROUTES.get(mode, r), tq, tk, tv, tdo,
                                  opts)
    ulp = BF16_HALF_ULP if tq.dtype == torch.bfloat16 else 0.0
    within(o, jo, ulp=ulp)
    within(lse, jlse, ulp=0.0)
    for g, jg in zip(grads, jgrads):
        within(g, jg, ulp=ulp)


def test_tf32_rounded_once_misses_the_tolerance():
    """One TF32 rounding of each f32 operand (what TF32 tensor cores do to
    f32 inputs) moves the results past the f32 tolerance: the split into
    a big part and its remainder is what meets it."""
    case = CASES[1]
    tq, tk, tv, tdo, _ = route_inputs(case, "f32")
    opts = opts_of(case)
    jo, jgrads, _ = jax_vjp(*(np.asarray(t) for t in (tq, tk, tv)),
                            np.asarray(tdo), opts)
    o, o32, lse = emulate_forward(tq, tk, tv, opts, "tf32", X3_PLAN)
    grads = emulate_backward(tq, tk, tv, o32, lse, tdo, opts, "tf32",
                             X3_PLAN)
    misses = 0
    for g, jg in zip((o, *grads), (jo, *jgrads)):
        try:
            within(g, jg, ulp=0.0)
        except AssertionError:
            misses += 1
    assert misses == 4


def test_tf32_split_is_exact_and_rounds_to_nearest():
    """The emulation's TF32 rounding: 10 mantissa bits, to nearest, ties
    away from zero; the remainder is exact and its TF32 rounding leaves
    ~2^-22 of x."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, 3.0, 1e-3])
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    assert tf32(x)[:4].tolist() == want
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    big, small = halves(x, "3xtf32")
    assert torch.equal(tf32(big), big) and torch.equal(tf32(small), small)
    assert torch.equal(x - big + big, x)            # the remainder is exact
    rel = (big.double() + small.double() - x.double()).abs() / \
        x.double().abs()
    assert float(rel.max()) < 2.0 ** -21


def test_p_rounded_once_misses_the_tolerance():
    """P rounded once to bf16 (the serve flash routes' plan) moves the
    results past the stated tolerance: the halves are what meets it."""
    case = CASES[1]
    q, k, v, do = draw(case, seed=1)
    tq, tk, tv = (to_torch(x, torch.bfloat16) for x in (q, k, v))
    opts = opts_of(case)
    _, jgrads, _ = jax_vjp(*(np.asarray(t.float()) for t in (tq, tk, tv)),
                           np.asarray(to_torch(do, torch.bfloat16).float()),
                           opts)
    _, o32, lse = emulate_forward(tq, tk, tv, opts, False)
    grads = emulate_backward(tq, tk, tv, o32, lse,
                             to_torch(do, torch.bfloat16), opts, False)
    misses = 0
    for g, jg in zip(grads, jgrads):
        try:
            within(g, jg, ulp=BF16_HALF_ULP)
        except AssertionError:
            misses += 1
    assert misses > 0


# ---------------------------------------------------------------------------
# (c) the choice
# ---------------------------------------------------------------------------


def _stand_in(device, placements=None):
    return SimpleNamespace(device=torch.device(device),
                           placements=placements)


def test_takes_kernel_by_device():
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    assert TA.takes_kernel([cpu, meta]) is False
    assert TA.takes_kernel([_stand_in("cuda")] * 3) is True
    for device in ("cpu", "meta"):                 # DTensors
        assert TA.takes_kernel([_stand_in(device, ("Shard(0)",)),
                                cpu]) is False
    with pytest.raises(ValueError, match="DTensor on CUDA"):
        TA.takes_kernel([_stand_in("cuda", ("Shard(2)",))])
    with pytest.raises(ValueError, match="device xpu"):
        TA.takes_kernel([_stand_in("xpu")])
    with pytest.raises(ValueError, match="mix"):
        TA.takes_kernel([cpu, _stand_in("cuda")])


def _refuse(*args, **kwargs):
    raise AssertionError("a training attention launch on plain tensors")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_plain_route(device, monkeypatch):
    monkeypatch.setattr(TA, "train_attention_forward", _refuse)
    monkeypatch.setattr(TA, "train_attention_backward", _refuse)
    case = CASES[1]
    q, k, v, _ = (torch.from_numpy(x).to(device).requires_grad_(True)
                  for x in draw(case))
    cfg = SimpleNamespace(attn_softcap=0.0)
    pos = torch.arange(case[2], device=device).expand(case[1], case[2])
    o = MA._attend(q, k, v, cfg, pos, 0, False)
    assert o.shape == q.shape and o.dtype == torch.float32
    assert o.device.type == device
    if device == "cpu":
        o.sum().backward()
        assert q.grad is not None and k.grad is not None


def _fake_cuda(monkeypatch):
    """CPU tensors take the kernel route, the emulations standing in for
    the launches (counted as the wrappers count)."""
    calls = {"forward": 0, "backward": 0}

    def forward(q, k, v, *, causal, window, logit_cap):
        calls["forward"] += 1
        plan, split = ROUTE_MATH[TA.route(q.dtype, k.dtype, q.shape[3])]
        return emulate_forward(q, k, v, dict(
            causal=causal, window=window, logit_cap=logit_cap), split, plan)

    def backward(q, k, v, o32, lse, dout, *, causal, window, logit_cap):
        calls["backward"] += 1
        plan, split = ROUTE_MATH[TA.route(q.dtype, k.dtype, q.shape[3])]
        return emulate_backward(q, k, v, o32, lse, dout, dict(
            causal=causal, window=window, logit_cap=logit_cap), split, plan)
    monkeypatch.setattr(TA, "train_attention_forward", forward)
    monkeypatch.setattr(TA, "train_attention_backward", backward)
    monkeypatch.setattr(TA, "takes_kernel", lambda ts: all(
        t.device.type == "cpu" for t in ts))
    return calls


def test_recorded_calls_alone_take_the_kernels(monkeypatch):
    calls = _fake_cuda(monkeypatch)
    case = CASES[0]
    q, k, v, do = (torch.from_numpy(x) for x in draw(case))
    cfg = SimpleNamespace(attn_softcap=0.0)
    pos = torch.arange(case[2]).expand(case[1], case[2])
    with torch.no_grad():                      # not recorded: plain
        MA._attend(q.requires_grad_(True), k, v, cfg, pos, 0, False,
                   arange_positions=True)
    MA._attend(q.detach(), k, v, cfg, pos, 0, False,   # nothing needs grad
               arange_positions=True)
    assert calls == {"forward": 0, "backward": 0}
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = MA._attend(*leaves, cfg, pos, 0, False, arange_positions=True)
    grads = torch.autograd.grad(o, leaves, do)
    assert calls == {"forward": 1, "backward": 1}
    plain = [t.detach().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(attention_core(*plain, pos, causal=True),
                               plain, do)
    for g, w in zip(grads, want):
        within(g, w, ulp=0.0)


def test_a_train_step_on_the_kernels_is_the_plain_step(monkeypatch):
    """A remat train step (tiny smoke config, 2 layers) with the emulation
    standing in for the kernels: two forward launches a layer (remat's
    recompute) and one backward; loss and grad norm within 1e-5 of the
    plain step's (f32: the sums' order)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.train import make_train_step, train_state_init
    cfg = get_smoke_config("codeqwen15_7b")
    state = train_state_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    batch = {k: torch.from_numpy(x) for k, x in
             synthetic_batch(5, 0, 0, 2, 72, cfg.vocab_size).items()}
    _, want = make_train_step(cfg, warmup_steps=1)(state, batch)
    calls = _fake_cuda(monkeypatch)
    _, got = make_train_step(cfg, warmup_steps=1)(state, batch)
    assert calls == {"forward": 2 * cfg.num_layers,
                     "backward": cfg.num_layers}
    for key in ("loss", "grad_norm"):
        assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-5)


def _attention_params(cfg, seed: int = 3) -> dict:
    """Numpy weights of one attention block of ``cfg``."""
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    shapes = {"wq": (d, nq, hd), "wk": (d, nkv, hd), "wv": (d, nkv, hd),
              "wo": (nq, hd, d)}
    if cfg.use_bias:
        shapes.update(bq=(nq, hd), bk=(nkv, hd), bv=(nkv, hd), bo=(d,))
    return {n: (rng.standard_normal(sh) / np.sqrt(d)).astype(np.float32)
            for n, sh in shapes.items()}


POSITION_CASES = {"shifted3": lambda S: np.arange(S) + 3,
                  "reversed": lambda S: np.arange(S)[::-1].copy(),
                  "arange": np.arange}


@pytest.mark.parametrize("name", sorted(POSITION_CASES))
@pytest.mark.parametrize("window", [0, 5])
def test_positions_choose_the_route_and_match_jax(name, window,
                                                  monkeypatch):
    """``models.attention.attention`` under autograd on (stand-in) CUDA
    tensors: positions other than ``arange`` take the plain ops on those
    positions, ``arange`` stated by the caller takes the kernels (which
    mask by index); both match the reference's ``attention`` on the same
    positions (RoPE and the mask read them)."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_smoke_config
    calls = _fake_cuda(monkeypatch)
    cfg, jcfg = get_smoke_config("codeqwen15_7b"), jax_smoke("codeqwen15_7b")
    params = _attention_params(cfg)
    B, S = 2, 24
    x = np.random.default_rng(4).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(POSITION_CASES[name](S), (B, S)).copy()
    want = JA.attention({n: jnp.asarray(w) for n, w in params.items()},
                        jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                        window=window)
    tp = {n: torch.from_numpy(w).requires_grad_(True)
          for n, w in params.items()}
    # the output projection's bias is the caller's add (the block's norm)
    got = MA.attention(tp, torch.from_numpy(x), cfg,
                       positions=torch.from_numpy(pos), window=window,
                       arange_positions=name == "arange") + tp["bo"]
    kernel = name == "arange"
    assert calls["forward"] == int(kernel)
    within(got, np.asarray(want), ulp=0.0)
    # an unstated arange takes the plain route too, and gives its bits
    if kernel:
        plain = MA.attention(tp, torch.from_numpy(x), cfg,
                             positions=torch.from_numpy(pos),
                             window=window) + tp["bo"]
        assert calls["forward"] == 1
        within(plain, np.asarray(want), ulp=0.0)


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "whisper_large_v3"])
def test_model_callers_state_arange_positions(arch, monkeypatch):
    """``forward_train`` states its positions (and ``encode`` its
    encoder's): under autograd every attention call of the model takes
    the kernels, whisper's encoder and cross-attention among them."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic_batch
    from repro_torch.models import model as TM
    calls = _fake_cuda(monkeypatch)
    cfg = get_smoke_config(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = {k: torch.from_numpy(x) for k, x in
             synthetic_batch(5, 0, 0, 2, 16, cfg.vocab_size).items()}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(np.random.default_rng(6)
                                           .standard_normal(
            (2, 16 // cfg.encoder_ratio, cfg.d_model)).astype(np.float32))
    from repro_torch.tree import leaves
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    loss, _ = TM.forward_train(params, cfg, batch, remat=False)
    assert loss.requires_grad
    assert calls["forward"] == _chip_smoke().attention_calls(cfg) > 0


def test_serve_kernels_still_refuse_grad_and_name_the_training_route():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError,
                       match="no backward.*kernels.train_attention"):
        fa.flash_attention_bhsd(q, q.detach(), q.detach())


def test_routes():
    bf, f32 = torch.bfloat16, torch.float32
    assert TA.route(bf, bf, 128) == "wgmma_bf16"
    assert TA.route(bf, bf, 64) == "wgmma_bf16"
    assert TA.route(bf, bf, 80) == "mma_bf16"
    assert TA.route(bf, bf, 72) == "mma_bf16"
    assert TA.route(bf, bf, 16) == "mma_bf16"
    assert TA.route(bf, bf, 136) == "scalar_f32"     # upcast first
    assert TA.route(bf, bf, 60) == "scalar_f32"
    assert TA.route(f32, f32, 64) == "mma_3xtf32"
    assert TA.route(f32, f32, 128) == "mma_3xtf32"
    assert TA.route(f32, f32, 16) == "mma_3xtf32"    # tiny
    assert TA.route(f32, f32, 80) == "mma_3xtf32"
    assert TA.route(bf, f32, 64) == "mma_3xtf32"     # whisper's cross
    assert TA.route(f32, bf, 128) == "mma_3xtf32"
    assert TA.route(f32, f32, 136) == "scalar_f32"   # past 128
    assert TA.route(f32, f32, 256) == "scalar_f32"
    assert TA.route(f32, f32, 60) == "scalar_f32"    # not a multiple of 8
    assert TA.route(bf, f32, 20) == "scalar_f32"
    assert TA.F32_ROUTES == ("mma_3xtf32", "scalar_f32")
    assert TA.ROUTES.index("mma_3xtf32") == 3        # the C route id
    with pytest.raises(ValueError, match="float16"):
        TA.route(torch.float16, torch.float16, 64)
    with pytest.raises(ValueError, match="head dim"):
        TA.route(f32, f32, 264)


def test_launch_functions_check_their_inputs():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        TA.train_attention_forward(q, q, q, causal=True, window=0,
                                   logit_cap=0.0)
    with pytest.raises(ValueError, match="S == T"):
        TA.train_attention_forward(q, torch.zeros(1, 4, 2, 16),
                                   torch.zeros(1, 4, 2, 16), causal=True,
                                   window=0, logit_cap=0.0)
    with pytest.raises(ValueError, match="multiple"):
        TA.train_attention_forward(torch.zeros(1, 8, 3, 16), q, q,
                                   causal=False, window=0, logit_cap=0.0)


def test_strided_views_are_read_in_place():
    x = torch.zeros(2, 8, 6, 16, dtype=torch.bfloat16)
    q = x[:, :, :4]
    assert TA._readable(q) is q                     # rows 96 elements apart
    odd = torch.zeros(2, 8, 6, 20, dtype=torch.bfloat16)[..., :12]
    assert TA._readable(odd).is_contiguous()
    # chip_smoke's "q_head_major" cases: a (B, H, S, D) tensor's (B, S, H,
    # D) view, read by its strides
    heads = torch.zeros(2, 6, 200, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert TA._readable(heads) is heads and not heads.is_contiguous()


# ---------------------------------------------------------------------------
# (d) the build and chip_smoke.py's counts
# ---------------------------------------------------------------------------


def test_build_lists_the_source():
    assert "train_attention" in _build.KERNEL_SOURCES
    assert (_build.CSRC / "train_attention.cu").exists()


def test_build_lists_the_old_route_variant():
    """The -DTRAIN_ATTN_FORCE_MMA build (wgmma_bf16 calls run mma_bf16):
    a library of its own, built beside the others by chip_smoke.py and
    read by its checks and times."""
    assert TA.FORCE_MMA_DEFINES == ("TRAIN_ATTN_FORCE_MMA",)
    src = (_build.CSRC / "train_attention.cu").read_text()
    assert "#ifdef TRAIN_ATTN_FORCE_MMA" in src
    assert _build.lib_path("train_attention", TA.FORCE_MMA_DEFINES) != \
        _build.lib_path("train_attention")
    chip = (ROOT / "chip_smoke.py").read_text()
    assert '("train_attention", ta.FORCE_MMA_DEFINES)' in chip
    # the checks and times launch wgmma_bf16's cases from that build
    assert _chip_smoke().TA_OLD_ROUTES["wgmma_bf16"][1] == \
        TA.FORCE_MMA_DEFINES
    assert "ta._lib(defs)" in chip


def test_build_lists_the_force_scalar_variant():
    """The -DTRAIN_ATTN_FORCE_SCALAR build (mma_3xtf32 calls run
    scalar_f32, counted there) and flash's -DFLASH_FORCE_SCALAR: libraries
    of their own, built beside the others by chip_smoke.py, which checks
    the f32 cases on them and times them in turns with the new route."""
    assert TA.FORCE_SCALAR_DEFINES == ("TRAIN_ATTN_FORCE_SCALAR",)
    assert fa.FORCE_SCALAR_DEFINES == ("FLASH_FORCE_SCALAR",)
    for name, defines in (("train_attention", TA.FORCE_SCALAR_DEFINES),
                          ("flash_attention", fa.FORCE_SCALAR_DEFINES)):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f"#ifdef {defines[0]}" in src or \
            f"#ifndef {defines[0]}" in src
        assert '#include "f32_split.cuh"' in src
        assert _build.lib_path(name, defines) != _build.lib_path(name)
    cs = _chip_smoke()
    assert cs.TA_OLD_ROUTES["mma_3xtf32"] == ("scalar_f32",
                                              TA.FORCE_SCALAR_DEFINES)
    assert cs.TA_OLD_ROUTES["wgmma_bf16"] == ("mma_bf16",
                                              TA.FORCE_MMA_DEFINES)
    assert cs.FLASH_OLD_ROUTES["mma_3xtf32"] == ("scalar_f32",
                                                 fa.FORCE_SCALAR_DEFINES)
    chip = (ROOT / "chip_smoke.py").read_text()
    assert '("train_attention", ta.FORCE_SCALAR_DEFINES)' in chip
    assert '("flash_attention", fa.FORCE_SCALAR_DEFINES)' in chip


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


# train: tiny (2 layers, f32) 4 steps each of 1, 2 and 1 microbatches and
# 8 of 2 (the bits check), remat: 32 microbatch passes; lm100m (12 layers,
# f32) 307 steps without remat; codeqwen1.5-7b (bf16, D 128) 10 steps at
# 16 layers with remat (the graph's and the eager columns'), at 2 layers 10
# with and 2 without; the other families with remat, 11 steps at full
# width (8 turns, 2 profiled, step 1's grads) and 10 at the bits check's
# depth (4 eager, 4 through the graph, 1 profiled, step 1's grads):
# zamba2's shared
# block (D 80, mma_bf16) 9 calls and 1, granite (D 64) 32 and 2, whisper
# (D 64, bf16 frames: the encoder, the decoder's self and cross calls) 96
# and 6, chameleon (D 128) 4 and 2, mamba2 none, and once more each in f32
# (step 1 on the kernels in f32: mma_3xtf32); examples: lm20m (6 layers) x
# 200 steps without remat
def _launches(**by_route):
    return {**dict.fromkeys(TA.ROUTES, 0), **by_route}


FAMILY_WGMMA = 11 * (32 + 96 + 4) + 10 * (2 + 6 + 2)
EXPECTED_ATTENTION = {
    "train": {"train_attention_forward": _launches(
        mma_3xtf32=2 * 32 * 2 + 12 * 307 + (9 + 32 + 96 + 4) * 2,
        mma_bf16=(11 * 9 + 10 * 1) * 2,
        wgmma_bf16=16 * 10 * 2 + 2 * 10 * 2 + 2 * 2 + FAMILY_WGMMA * 2),
        "train_attention_backward": _launches(
            mma_3xtf32=2 * 32 + 12 * 307 + 9 + 32 + 96 + 4,
            mma_bf16=11 * 9 + 10 * 1,
            wgmma_bf16=16 * 10 + 2 * 10 + 2 * 2 + FAMILY_WGMMA)},
    "examples": {"train_attention_forward": _launches(mma_3xtf32=6 * 200),
                 "train_attention_backward": _launches(mma_3xtf32=6 * 200)},
    "dryrun": {"train_attention_forward": _launches(),
               "train_attention_backward": _launches()},
}


@pytest.mark.parametrize("phase", sorted(EXPECTED_ATTENTION))
def test_chip_smoke_expected_attention_launches(phase):
    cs = _chip_smoke()
    assert cs.expected_attention_launches(TA, phase) == \
        EXPECTED_ATTENTION[phase]


def test_chip_smoke_backward_kernels_must_agree(monkeypatch):
    cs = _chip_smoke()
    zero = {k: dict.fromkeys(TA.ROUTES, 0) for k in TA.KERNELS}
    opt = SimpleNamespace(kernel_launches=lambda lib: {}, _lib=lambda: None)
    after = {k: dict(v) for k, v in zero.items()}
    ta = SimpleNamespace(kernel_launches=lambda lib: after,
                         _lib=lambda: None, DELTA_IN_DQ=TA.DELTA_IN_DQ)
    mods = {"adamw_update": opt, "train_attention_forward": ta}
    after["forward"]["mma_bf16"] = 2
    for k in ("delta", "dkdv", "dq"):
        after[k]["mma_bf16"] = 1
    got = cs.device_delta(mods, ({}, zero))
    assert got["train_attention_forward"]["mma_bf16"] == 2
    assert got["train_attention_backward"]["mma_bf16"] == 1
    after["dq"]["mma_bf16"] = 2
    with pytest.raises(SystemExit):
        cs.device_delta(mods, ({}, zero))
    # mma_3xtf32's dQ kernel computes delta: no delta launch there
    after["dq"]["mma_bf16"] = 1
    after["forward"]["mma_3xtf32"] = 3
    after["dq"]["mma_3xtf32"] = after["dkdv"]["mma_3xtf32"] = 3
    got = cs.device_delta(mods, ({}, zero))
    assert got["train_attention_backward"]["mma_3xtf32"] == 3
    after["delta"]["mma_3xtf32"] = 3
    with pytest.raises(SystemExit):
        cs.device_delta(mods, ({}, zero))


def test_chip_smoke_profile_names_every_training_attention_kernel():
    """Every kernel of csrc/train_attention.cu is counted in the train
    step's "attention_kernels" part by name (``NAMED_KERNEL_PARTS``)."""
    import re
    cs = _chip_smoke()
    src = (_build.CSRC / "train_attention.cu").read_text()
    names = set(re.findall(
        r"\b(\w+_kernel)\(const (?:Args|__grid_constant__)", src))
    assert {"fwd_wgmma_kernel", "dq_wgmma_kernel", "dkdv_wgmma_kernel",
            "fwd_mma_kernel", "delta_kernel", "fwd_3xtf32_kernel",
            "dq_3xtf32_kernel", "dkdv_3xtf32_kernel"} <= names
    for name in names:
        parts = [p for k, p in cs.NAMED_KERNEL_PARTS.items() if k in name]
        assert parts[:1] == ["attention_kernels"], name


def test_chip_smoke_op_families():
    cs = _chip_smoke()
    dims = dict(seq=512, heads=(32, 32), head_dim=128, d_model=4096,
                d_ff=13440, vocab=92416)
    for shapes, family in (([[8, 32, 1, 512, 512]], "attention_core"),
                           ([[8, 512, 32, 128], []], "rope_upcasts"),
                           ([[8, 512, 32, 64]], "rope_upcasts"),
                           ([[8, 512, 4096]], "norms_residual"),
                           ([[8, 512, 13440]], "mlp_gate"),
                           ([[4096, 92416]], "loss_head"),
                           ([[16]], "casts_copies"), ([], "casts_copies")):
        assert cs.op_family(shapes, dims) == family


def test_chip_smoke_tolerance_is_the_stated_one():
    cs = _chip_smoke()
    want = torch.tensor([1.0, -2.0, 0.5])
    assert cs.TA_REL_TOL == REL_TOL and cs.TA_BF16_ULP == BF16_HALF_ULP
    assert cs.ta_within(torch, want.bfloat16(), want)["ok"]
    off = torch.tensor([1.0 + 2 ** -7, -2.0, 0.5]).bfloat16()
    assert not cs.ta_within(torch, off, want)["ok"]
    assert not cs.ta_within(torch, want + 1e-4, want)["ok"]
