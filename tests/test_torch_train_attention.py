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
    the tensor-core routes, f32 sums, each result rounded once), its tile
    sizes and sum order parameters: ``mma_bf16``'s (64-row query tiles and
    64-key tiles, 16-row dK dV tiles at D = 128, each tile's hi and lo
    products summed before they join the sum) and ``wgmma_bf16``'s
    (128-row forward and dQ items over 64-key tiles, 64-row dK dV tiles,
    hi then lo joining the running sum 16 deep at a time), against JAX's
    f32 values at chip_smoke's tolerance: bf16 within 2^-8 |b| (half an
    ulp) + 1e-5 x max|b|, f32 within 1e-5 x max|b|; P rounded once to
    bf16, as the serve flash routes do, misses it;
(c) the choice: calls autograd records on CUDA take the kernels (the
    emulation standing in for the launches, a train step through them
    close to the plain step, a forward launch twice under remat), CPU and
    meta tensors and DTensors on them take the plain ops, a DTensor on
    CUDA raises, unrecorded calls stay plain, the serve kernels still
    refuse grad; the wrapper's routes and checks;
(d) the build lists the source; chip_smoke.py's expected launches.
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
    """A route's tiles and sum order: query rows a forward / dQ tile,
    keys a tile, query rows a dK dV tile (by head dim), and how a split
    product joins its sum: "tile" (hi B + lo B of the whole tile, then
    added) or "k16" (hi then lo into the running sum, 16 deep at a
    time)."""
    rows: int
    keys: int
    dkdv_rows: Callable[[int], int]
    order: str


# csrc/train_attention.cu: mma_bf16 (dkdv_rows<DP>: 16 rows past D 80)
# and wgmma_bf16 (kWgItem, kWgTile)
MMA_PLAN = Plan(TILE, TILE, lambda d: 16 if d > 80 else TILE, "tile")
WGMMA_PLAN = Plan(128, TILE, lambda d: TILE, "k16")
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


def halves(x: torch.Tensor, split: bool):
    """The bf16 operand(s) an f32 tile enters a product as, in f32: hi and
    lo halves (``tc::pack_split_bf16``), one rounding, or f32 itself."""
    if split is None:
        return [x]
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()] if split else [hi]


def product(a: torch.Tensor, b: torch.Tensor, split) -> torch.Tensor:
    """a @ b with a as ``halves``: the tensor cores' exact bf16 products,
    summed in f32."""
    return sum(h @ b for h in halves(a, split))


def accumulate(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, split,
               order: str) -> torch.Tensor:
    """acc + a @ b in a plan's order: "tile" adds the tile's product
    (``product``), "k16" adds hi then lo of each 16-deep slice of a to the
    running sum."""
    if order == "tile":
        return acc + product(a, b, split)
    for k0 in range(0, a.shape[-1], 16):
        for h in halves(a[..., k0:k0 + 16], split):
            acc = acc + h @ b[..., k0:k0 + 16, :]
    return acc


def scales(opts, D) -> dict:
    """The wrapper's f32 reciprocals of sqrt(D) and the cap."""
    _, inv_cap, inv_sqrt_d = TA._scales(opts["logit_cap"], D)
    return {"inv_sqrt_d": np.float32(inv_sqrt_d),
            "inv_cap": np.float32(inv_cap)}


def tile_scores(a, qt, kt, rows, cols, opts):
    """The kernels' ``masked_score`` of a (rows, cols) tile: the raw
    products times 1 / sqrt(D), the cap, -1e30 where the mask hides the
    pair; and the tanh for the backward."""
    x = (qt @ kt.transpose(-1, -2)) * a["inv_sqrt_d"]
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
            m = torch.full((B, len(rows)), -float("inf"))
            l = torch.zeros((B, len(rows)))
            acc = torch.zeros((B, len(rows), D))
            tb, te = key_range(S, T, q0, opts, plan.rows, plan.keys)
            for it in range(tb, te):
                cols = torch.arange(it * plan.keys,
                                    min(it * plan.keys + plan.keys, T))
                x, _ = tile_scores(a, qf[:, rows, h], kf[:, cols, h // G],
                                   rows, cols, opts)
                mx = torch.maximum(m, x.max(-1).values)
                corr = torch.exp(m - mx)
                p = torch.exp(x - mx[..., None])
                l = l * corr + p.sum(-1)
                acc = accumulate(acc * corr[..., None], p,
                                 vf[:, cols, h // G], split, plan.order)
                m = mx
            o32[:, rows, h] = acc / l[..., None]
            lse[:, h, rows] = m + torch.log(l)
    return o32.to(q.dtype), o32, lse


def emulate_backward(q, k, v, o32, lse, do, opts, split, plan=MMA_PLAN):
    """The delta, dQ and dK dV kernels: (dq, dk, dv) in the route's
    dtype, each summed in f32 in ``plan``'s tiles and order and rounded
    once: dq over the key tiles of each query tile, dk and dv over the G
    query heads of their kv head in order, then their dK dV query tiles."""
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
                            opts)
        p = torch.exp(x - lse[:, h, rows][..., None])
        dp = dof[:, rows, h] @ vf[:, cols, hk].transpose(-1, -2)
        g = p * (dp - delta[:, h, rows][..., None])
        if cap:
            g = (g * cap) * (1 - th * th) * a["inv_cap"]
        return p, g * a["inv_sqrt_d"]

    for h in range(Hq):
        for q0 in range(0, S, plan.rows):            # dQ
            rows = torch.arange(q0, min(q0 + plan.rows, S))
            tb, te = key_range(S, T, q0, opts, plan.rows, plan.keys)
            for it in range(tb, te):
                cols = torch.arange(it * plan.keys,
                                    min(it * plan.keys + plan.keys, T))
                _, g = grads(h, rows, cols)
                dq[:, rows, h] = accumulate(dq[:, rows, h], g,
                                            kf[:, cols, h // G], split,
                                            plan.order)
    qr = plan.dkdv_rows(D)
    for h in range(Hq):                               # dK dV
        hk = h // G
        for q0 in range(0, S, qr):
            rows = torch.arange(q0, min(q0 + qr, S))
            tb, te = key_range(S, T, q0, opts, qr, 1)
            cols = torch.arange(tb, te)
            p, g = grads(h, rows, cols)
            dv[:, cols, hk] = accumulate(dv[:, cols, hk],
                                         p.transpose(-1, -2),
                                         dof[:, rows, h], split, plan.order)
            dk[:, cols, hk] = accumulate(dk[:, cols, hk],
                                         g.transpose(-1, -2),
                                         qf[:, rows, h], split, plan.order)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


EMULATED = [(c, m) for c in CASES for m in ("f32", "bf16")]
# each case's bf16 route, and in mma_bf16's plan too where that is
# wgmma_bf16 (the old route, kept at every shape by -DTRAIN_ATTN_FORCE_MMA)
PLANS = {"mma_bf16": MMA_PLAN, "wgmma_bf16": WGMMA_PLAN}
EMULATED += [(c, "bf16-mma_plan") for c in CASES if c[6] in TA.WGMMA_HEAD_DIMS]


@pytest.mark.parametrize("case,mode", EMULATED,
                         ids=[f"{c[0]}-{m}" for c, m in EMULATED])
def test_emulated_kernels_match_jax_at_the_chip_tolerance(case, mode):
    """The route's arithmetic (the tensor-core routes: hi + lo halves in
    their plan's tiles and sum order; f32: scalar f32) against JAX's f32 o,
    lse and grads of the same values."""
    q, k, v, do = draw(case, seed=1)
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    tq, tk, tv = (to_torch(x, dt) for x in (q, k, v))
    opts = opts_of(case)
    r = TA.route(dt, dt, case[6])
    want = {64: "wgmma_bf16", 128: "wgmma_bf16"}.get(case[6], "mma_bf16")
    assert r == (want if dt == torch.bfloat16 else "scalar_f32")
    split = None if r == "scalar_f32" else True
    plan = MMA_PLAN if mode == "bf16-mma_plan" else PLANS.get(r, MMA_PLAN)
    jo, jgrads, jlse = jax_vjp(*(np.asarray(t.float()) for t in (tq, tk, tv)),
                               np.asarray(to_torch(do, dt).float()), opts)
    o, o32, lse = emulate_forward(tq, tk, tv, opts, split, plan)
    dq, dk, dv = emulate_backward(tq, tk, tv, o32, lse, to_torch(do, dt),
                                  opts, split, plan)
    ulp = BF16_HALF_ULP if dt == torch.bfloat16 else 0.0
    within(o, jo, ulp=ulp)
    within(lse, jlse, ulp=0.0)
    for g, jg in zip((dq, dk, dv), jgrads):
        within(g, jg, ulp=ulp)


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
        split = True if q.dtype == torch.bfloat16 else None
        return emulate_forward(q, k, v, dict(
            causal=causal, window=window, logit_cap=logit_cap), split)

    def backward(q, k, v, o32, lse, dout, *, causal, window, logit_cap):
        calls["backward"] += 1
        split = True if q.dtype == torch.bfloat16 else None
        return emulate_backward(q, k, v, o32, lse, dout, dict(
            causal=causal, window=window, logit_cap=logit_cap), split)
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
        MA._attend(q.requires_grad_(True), k, v, cfg, pos, 0, False)
    MA._attend(q.detach(), k, v, cfg, pos, 0, False)   # nothing needs grad
    assert calls == {"forward": 0, "backward": 0}
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    o = MA._attend(*leaves, cfg, pos, 0, False)
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
    assert TA.route(f32, f32, 64) == "scalar_f32"
    assert TA.route(f32, f32, 128) == "scalar_f32"
    assert TA.route(bf, f32, 64) == "scalar_f32"     # whisper's cross
    assert TA.route(f32, bf, 128) == "scalar_f32"
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
    assert "prior_lib = ta._lib(ta.FORCE_MMA_DEFINES)" in chip


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


# train: tiny (2 layers, f32) 4 steps each of 1, 2 and 1 microbatches,
# remat; lm100m (12 layers, f32) 84 steps without remat; codeqwen1.5-7b
# (bf16, D 128) 5 steps at 16 layers with remat, 1 at 2 layers with and 1
# without; examples: lm20m (6 layers) x 200 steps without remat
EXPECTED_ATTENTION = {
    "train": {"train_attention_forward": {
        "mma_bf16": 0, "scalar_f32": 2 * 16 * 2 + 12 * 84,
        "wgmma_bf16": 16 * 5 * 2 + 2 * 2 + 2},
        "train_attention_backward": {
            "mma_bf16": 0, "scalar_f32": 2 * 16 + 12 * 84,
            "wgmma_bf16": 16 * 5 + 2 + 2}},
    "examples": {"train_attention_forward": {"mma_bf16": 0,
                                             "scalar_f32": 6 * 200,
                                             "wgmma_bf16": 0},
                 "train_attention_backward": {"mma_bf16": 0,
                                              "scalar_f32": 6 * 200,
                                              "wgmma_bf16": 0}},
    "dryrun": {"train_attention_forward": {"mma_bf16": 0, "scalar_f32": 0,
                                           "wgmma_bf16": 0},
               "train_attention_backward": {"mma_bf16": 0,
                                            "scalar_f32": 0,
                                            "wgmma_bf16": 0}},
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
                         _lib=lambda: None)
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


def test_chip_smoke_profile_names_every_training_attention_kernel():
    """Every kernel of csrc/train_attention.cu is counted in the train
    step's "attention_kernels" part by name (``NAMED_KERNEL_PARTS``)."""
    import re
    cs = _chip_smoke()
    src = (_build.CSRC / "train_attention.cu").read_text()
    names = set(re.findall(
        r"\b(\w+_kernel)\(const (?:Args|__grid_constant__)", src))
    assert {"fwd_wgmma_kernel", "dq_wgmma_kernel", "dkdv_wgmma_kernel",
            "fwd_mma_kernel", "delta_kernel"} <= names
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
