"""The MoE route's wrapper and plain version (``repro_torch.kernels.
moe_dispatch.moe_route``) against the reference's routing, on the CPU.

The kernel itself (``moe_route_kernel`` in ``csrc/moe_dispatch.cu``) runs
only on the card, where ``chip_smoke.py`` holds it to the plain version.
Here:

* ``moe_route_plain``'s idx, pos, keep and src equal the reference's
  routing (``repro/models/moe.py``: softmax, ``lax.top_k``, the slot
  positions) recomputed with jnp from the same logits, its gates and aux
  loss within ``tests/test_torch_moe_dispatch.py``'s tolerance: granite's
  and grok's smoke configs (weights from the JAX ``init_moe``) at 1, 2 and
  B groups, a forced capacity overflow, and exact ties (equal router
  columns: the lower expert first);
* a numpy emulation of the kernel (its softmax in torch's CUDA order, k
  rounds of warp argmax, tiles of 16 tokens ranked by warp matches, the
  chained scan over tiles in any order of publication, windows of earlier
  tiles, the aux loss's partials in tile order) equals the plain version;
* ``moe_block(use_kernel=True)`` with tied router columns equals JAX's
  block; the dispatch's buffer is laid out as its map (e-major from the
  route), at any row width and offset, and ``chip_smoke``'s slot-scan
  stand-in swaps only the block's route;
* the wrapper refuses grads, non-f32 logits, more than 256 experts and
  k > e; meta tensors give the shapes.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import moe_dispatch as MD  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite_moe_3b_a800m", "grok_1_314b"]
TOL = dict(atol=1e-4, rtol=1e-4)        # tests/test_torch_moe.py's
B, S = 2, 12
TILE = 16                               # csrc: kRouteTokens


def _setup(arch, s=S, ties=False, **kw):
    """The smoke config (``kw`` replaced), the JAX init's MoE weights (with
    ``ties``, each odd expert's router column the even one's before it),
    tokens (B, s, d) from numpy."""
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    jcfg = dataclasses.replace(jax_smoke(arch), **kw)
    tree = jax.tree.map(np.asarray, JMoE.init_moe(
        KeyGen(jax.random.PRNGKey(0)), jcfg, jnp.dtype(jcfg.dtype)))
    if ties:
        tree["router"] = tree["router"].copy()
        tree["router"][:, 1::2] = tree["router"][:, 0::2]
    x = np.random.default_rng(3).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, tree, x


def _logits(tree, x, g):
    """The router's f32 logits (g, sg, e), as ``models.moe`` computes them
    from the bridged weights."""
    p = params_from_numpy(tree, "cpu")
    xg = torch.from_numpy(x).reshape(g, -1, x.shape[-1])
    return torch.einsum("gsd,de->gse", xg.float(), p["router"])


def _ref_route(logits, k, cap):
    """The reference's routing (``repro/models/moe.py``) with jnp from the
    logits: idx, gates, pos, keep, the inverse map (g, e, cap) and aux."""
    g, sg, e = logits.shape
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gates, idx = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    me = probs.mean(axis=(0, 1))
    ce = jax.nn.one_hot(idx[..., 0], e).mean(axis=(0, 1))
    aux = e * jnp.sum(me * ce)
    flat = idx.reshape(g, sg * k)
    one = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(one, axis=1) - 1, flat[..., None],
                              axis=-1)[..., 0]
    keep = pos < cap
    pos, keep, flat = map(np.asarray, (pos, keep, flat))
    src = np.full((g, e, cap), -1)
    for gi, j in zip(*np.nonzero(keep)):
        src[gi, flat[gi, j], pos[gi, j]] = j // k
    return tuple(map(np.asarray, (idx, gates, pos, keep, src, aux)))


# name, arch, groups (None: B), tokens a sequence, replaced config fields,
# tied router columns
CASES = [
    ("granite_b", "granite_moe_3b_a800m", None, S, {}, False),
    ("granite_g1", "granite_moe_3b_a800m", 1, S, {}, False),
    ("granite_g2", "granite_moe_3b_a800m", 2, S, {}, False),
    ("granite_overflow", "granite_moe_3b_a800m", 1, 48,
     dict(capacity_factor=0.25), False),
    ("granite_ties", "granite_moe_3b_a800m", None, S, {}, True),
    ("grok_b", "grok_1_314b", None, S, {}, False),
    ("grok_g1", "grok_1_314b", 1, S, {}, False),
    ("grok_g2", "grok_1_314b", 2, S, {}, False),
    ("grok_overflow", "grok_1_314b", 2, 48, dict(capacity_factor=0.25),
     False),
    ("grok_ties_overflow", "grok_1_314b", 1, 48, dict(capacity_factor=0.25),
     True),
]


def _case_inputs(case):
    _, arch, groups, s, kw, ties = case
    cfg, jcfg, tree, x = _setup(arch, s, ties, **kw)
    g = groups or B
    sg = B * s // g
    logits = _logits(tree, x, g)
    return cfg, jcfg, tree, x, g, logits, TMoE.expert_capacity(cfg, sg)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_route_plain_is_the_references(case):
    cfg, _, _, _, g, logits, cap = _case_inputs(case)
    k = cfg.top_k
    got = MD.moe_route_plain(logits, k, cap)
    want = _ref_route(logits.numpy(), k, cap)
    idx, gates, pos, keep, src, aux = got
    assert idx.dtype == torch.int64 and gates.dtype == torch.float32
    assert pos.dtype == src.dtype == torch.int32 and keep.dtype == torch.bool
    assert tuple(src.shape) == (g, cfg.num_experts, cap) and MD.is_e_major(
        src) == (g > 1)
    for a, b in ((idx, want[0]), (pos, want[2]), (keep, want[3]),
                 (src, want[4])):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(gates.numpy(), want[1], **TOL)
    np.testing.assert_allclose(aux.numpy(), want[5], **TOL)
    if "overflow" in case[0]:
        assert not keep.all()
    if case[-1]:
        # every token's experts come in tied pairs, the lower one first
        probs = torch.softmax(logits, -1)
        assert torch.equal(probs[..., 1::2], probs[..., 0::2])
        top = idx.numpy()
        pairs = top[..., 0::2] // 2 == top[..., 1::2] // 2
        assert pairs.all() and (top[..., 0::2] % 2 == 0).all()


# --- a numpy emulation of moe_route_kernel ---------------------------------


def _softmax_cuda(row):
    """One token's probabilities as the kernel (and torch's CUDA warp
    softmax) computes them: lane l takes experts l + 32 i, the exps summed
    in i order from 0, then xor butterflies over 16, 8, 4, 2, 1; an IEEE
    division."""
    e = row.shape[0]
    f32 = np.float32
    m = row.max()
    ex = np.exp((row - m).astype(f32)).astype(f32)
    lanes = np.zeros(32, f32)
    for x in range(e):
        lanes[x % 32] = f32(lanes[x % 32] + ex[x])
    for off in (16, 8, 4, 2, 1):
        lanes = (lanes + lanes[np.arange(32) ^ off]).astype(f32)
    return (ex / lanes[0]).astype(f32)


def _top_k_warp(probs, k):
    """k rounds of argmax: the larger probability, then the lower expert;
    the gates renormalised by their sum in rank order."""
    p = probs.astype(np.float64).copy()
    idx, picked = [], []
    total = np.float32(0)
    for _ in range(k):
        best = max(range(len(p)), key=lambda x: (p[x], -x))
        idx.append(best)
        picked.append(np.float32(probs[best]))
        total = np.float32(total + picked[-1])
        p[best] = -np.inf
    denom = max(total, np.float32(1e-9))
    return idx, [np.float32(v / denom) for v in picked]


def _emulated_route(logits, k, cap, window=32, order_seed=0):
    """The kernel's algorithm: a tile of 16 tokens a block, the token's
    softmax and top k, the tile's slots ranked (token order, top-1 before
    top-2) and counted an expert; then the chained scan: every tile
    publishes its counts (an aggregate, or the inclusive prefix for a
    group's first tile), and reads its earlier tiles' words in windows of
    ``window`` tiles down to the first inclusive prefix of each expert,
    some of the earlier tiles having published theirs (a random order of
    finishing, ``order_seed``); pos = prefix + rank, the map -1 past each
    expert's count, aux from the partials in tile order."""
    g, sg, e = logits.shape
    tpg = -(-sg // TILE)
    tiles = g * tpg
    idx = np.zeros((g, sg, k), np.int64)
    gates = np.zeros((g, sg, k), np.float32)
    pos = np.zeros((g, sg * k), np.int32)
    src = np.full((e, g, cap), -7, np.int32)
    counts = np.zeros((tiles, e), np.int64)
    ranks, psum, top1 = {}, np.zeros((tiles, e)), np.zeros((tiles, e))
    for tile in range(tiles):
        gi, ti = divmod(tile, tpg)
        toks = range(ti * TILE, min(sg, ti * TILE + TILE))
        slots = []
        for t in toks:
            probs = _softmax_cuda(logits[gi, t])
            psum[tile] += probs.astype(np.float64)
            ix, gt = _top_k_warp(probs, k)
            idx[gi, t], gates[gi, t] = ix, gt
            top1[tile, ix[0]] += 1
            slots += ix
        seen = np.zeros(e, np.int64)
        for s, x in enumerate(slots):
            ranks[tile, s] = seen[x]
            seen[x] += 1
        counts[tile] = seen
    # the scan: words 1 << 30 | count (aggregate) or 2 << 30 | prefix
    rng = np.random.default_rng(order_seed)
    words = {}
    for tile in range(tiles):
        if tile % tpg == 0:
            words[tile] = [(2, c) for c in counts[tile]]
        else:
            words[tile] = [(1, c) for c in counts[tile]]
    excl = np.zeros((tiles, e), np.int64)
    for tile in rng.permutation(tiles):
        gi, ti = divmod(tile, tpg)
        if ti == 0:
            continue
        for x in range(e):
            acc, hi = 0, ti
            while hi > 0:
                lo = max(0, hi - window)
                done = False
                for j in range(hi - 1, lo - 1, -1):
                    status, c = words[gi * tpg + j][x]
                    acc += c
                    if status == 2:
                        done = True
                        break
                if done:
                    break
                hi = lo
            excl[tile, x] = acc
        words[tile] = [(2, excl[tile, x] + counts[tile, x])
                       for x in range(e)]
    for tile in range(tiles):
        gi, ti = divmod(tile, tpg)
        t0 = ti * TILE
        slots = idx[gi, t0:t0 + TILE].reshape(-1)
        for s, x in enumerate(slots):
            p = excl[tile, x] + ranks[tile, s]
            pos[gi, t0 * k + s] = p
            if p < cap:
                src[x, gi, p] = t0 + s // k
        if ti == tpg - 1:
            for x in range(e):
                src[x, gi, min(cap, excl[tile, x] + counts[tile, x]):] = -1
    n = g * sg
    aux = e * np.sum((psum.sum(0) / n) * (top1.sum(0) / n))
    return idx, gates, pos, pos < cap, src.transpose(1, 0, 2), np.float32(
        aux)


def _random_logits(g, sg, e, seed, skew=0.0, ties=False):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((g, sg, e)) - skew * np.arange(e)).astype(
        np.float32)
    if ties:
        logits[..., 1::2] = logits[..., 0::2]
    return logits


# name, groups, tokens a group, k, experts, capacity, skew, ties, window
EMU_CASES = [
    ("granite_prefill_cut", 2, 80, 8, 40, 32, 0.0, False, 32),
    ("granite_overflow", 2, 80, 8, 40, 8, 0.5, False, 32),
    ("ties", 1, 48, 8, 40, 16, 0.0, True, 32),
    ("window_2", 2, 100, 4, 8, 16, 0.0, False, 2),
    ("window_1_ties", 1, 70, 2, 4, 24, 0.0, True, 1),
    ("e256", 1, 40, 8, 256, 8, 0.02, False, 16),
    ("decode", 1, 4, 8, 40, 8, 0.0, False, 32),
]


@pytest.mark.parametrize("case", EMU_CASES, ids=[c[0] for c in EMU_CASES])
def test_emulated_route_kernel_is_the_plain_version(case):
    _, g, sg, k, e, cap, skew, ties, window = case
    logits = _random_logits(g, sg, e, seed=sg, skew=skew, ties=ties)
    want = MD.moe_route_plain(torch.from_numpy(logits), k, cap)
    for order in (0, 1):
        got = _emulated_route(logits, k, cap, window, order)
        for i in (0, 2, 3, 4):
            np.testing.assert_array_equal(got[i], want[i].numpy())
        np.testing.assert_allclose(got[1], want[1].numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got[5], want[5].numpy(), rtol=1e-5)
    if skew:
        assert not want[3].all()


def test_emulated_softmax_is_within_an_ulp_of_torch():
    """The kernel's softmax order against torch's CPU softmax (another sum
    order and numpy's exp against SLEEF's): within a few ulps (1e-6
    relative), and exact ties stay exact."""
    logits = _random_logits(3, 20, 40, seed=7, ties=True)
    want = torch.softmax(torch.from_numpy(logits), -1).numpy()
    got = np.stack([[_softmax_cuda(r) for r in grp] for grp in logits])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (got[..., 1::2] == got[..., 0::2]).all()


# --- the block and the wrappers ---------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_block_with_tied_router_columns_is_jax(arch):
    """Equal router columns: ``moe_block(use_kernel=True)`` (the route's
    plain version on the CPU) picks JAX's experts, the lower one first, and
    gives JAX's y and aux loss."""
    cfg, jcfg, tree, x = _setup(arch, ties=True)
    jy, jaux = JMoE.moe_block(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(x), jcfg)
    p, tx = params_from_numpy(tree, "cpu"), torch.from_numpy(x)
    y, aux = TMoE.moe_block(p, tx, cfg, use_kernel=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **TOL)


def test_dispatch_lays_the_buffer_out_as_its_map():
    """The route's e-major map gives an e-major buffer (the experts'
    einsums then batch it without a copy), the slot scan's group-major map
    a group-major one; the values are the plain dispatch's either way."""
    logits = torch.from_numpy(_random_logits(3, 24, 8, seed=1))
    x = torch.randn((3, 24, 32))
    route = MD.moe_route(logits, 2, 16)
    slots = MD.moe_slots(route[0], 8, 16)
    assert MD.is_e_major(route[4]) and not MD.is_e_major(slots[2])
    assert torch.equal(route[4], slots[2])
    e_buf, g_buf = MD.moe_dispatch(x, route[4]), MD.moe_dispatch(x, slots[2])
    assert e_buf.transpose(0, 1).is_contiguous() and g_buf.is_contiguous()
    assert torch.equal(e_buf, g_buf)
    assert torch.equal(e_buf, MD.moe_dispatch_plain(x, slots[2]))


@pytest.mark.parametrize("d,dtype,offset", [
    (77, torch.bfloat16, 0), (64, torch.float32, 1), (1536, torch.bfloat16, 0)])
def test_dispatch_layouts_at_any_row(d, dtype, offset):
    """Odd widths and rows off a 16-byte boundary (the kernel's one element
    a lane) keep the map's layout and the plain dispatch's values."""
    logits = torch.from_numpy(_random_logits(2, 16, 8, seed=2))
    n = 2 * 16 * d
    x = torch.randn(n + offset)[offset:].view(2, 16, d).to(dtype)
    route = MD.moe_route(logits, 2, 8)
    slots = MD.moe_slots(route[0], 8, 8)
    want = MD.moe_dispatch_plain(x, slots[2])
    e_buf, g_buf = MD.moe_dispatch(x, route[4]), MD.moe_dispatch(x, slots[2])
    assert e_buf.transpose(0, 1).is_contiguous() and g_buf.is_contiguous()
    assert torch.equal(e_buf, want) and torch.equal(g_buf, want)
    with pytest.raises(ValueError, match="moe_dispatch"):
        MD.moe_dispatch(x, slots[2].long())


def test_route_refuses_grads_dtypes_and_widths():
    logits = torch.zeros((1, 4, 8), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        MD.moe_route(logits, 2, 8)
    with pytest.raises(ValueError, match="float32"):
        MD.moe_route(torch.zeros((1, 4, 8), dtype=torch.bfloat16), 2, 8)
    with pytest.raises(ValueError, match="float32"):
        MD.moe_route(torch.zeros((4, 8)), 2, 8)
    for e, k in ((257, 2), (8, 9), (8, 0)):
        with pytest.raises(ValueError, match="experts"):
            MD.moe_route(torch.zeros((1, 4, e)), k, 8)
    with pytest.raises(ValueError, match="capacity"):
        MD.moe_route(torch.zeros((1, 4, 8)), 2, 0)


def test_route_on_meta_gives_the_shapes():
    got = MD.moe_route(torch.zeros((2, 6, 8), device="meta"), 2, 8)
    assert [tuple(t.shape) for t in got] == [(2, 6, 2), (2, 6, 2), (2, 12),
                                             (2, 12), (2, 8, 8), ()]
    assert all(t.device.type == "meta" for t in got)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_chip_smoke_counts_the_route_kernels():
    """``chip_smoke``'s MoE kernels are the library's, in its order; its
    check's device launches: 3 of the route, slots and combine, 6 of each
    dispatch route that takes x; its cases cover ties, overflow and both
    dispatch routes."""
    cs = _chip_smoke()
    assert cs.MOE_KERNELS == MD.KERNELS
    assert set(cs.MOE_DEVICE_KERNELS) == set(MD.KERNELS)
    assert cs.moe_expected_check(MD, "bf16")["moe_dispatch"] == {
        "f32": 0, "bf16": 6}
    want = cs.moe_expected_check(MD, "f32")
    assert want["moe_dispatch"] == {"f32": 6, "bf16": 0}
    assert all(want[n] == {r: 3 if r in ("f32", "int64") else 0
                           for r in MD.ROUTES[n]}
               for n in ("moe_route", "moe_slots", "moe_combine"))
    names = {c[0]: c for c in cs.MOE_CASES}
    assert sum(c[9] for c in cs.MOE_CASES) >= 2
    assert any(c[9] and c[7] for c in cs.MOE_CASES)
    assert names["odd_d77_bf16"][5] % 8 and names["unaligned_f32"][8]
    routes = cs.moe_serve_routes(MD, get_smoke_config(ARCHS[0]))
    assert routes == {"moe_route": "f32", "moe_dispatch": "f32",
                      "moe_combine": "f32", "moe_slots": "int64"}


def test_chip_smokes_slot_scan_swaps_only_the_blocks_route():
    """``chip_smoke.slot_scan_moe`` (the route before ``moe_route``, timed
    in turns on the card) runs the block's kernel route with the slot scan
    of the router's idx in place of ``moe_route``: the same y and aux loss
    as the plain route, the group-major map, and the wrappers untouched."""
    cs = _chip_smoke()
    cfg, _, tree, x = _setup(ARCHS[0])
    p, tx = params_from_numpy(tree, "cpu"), torch.from_numpy(x)
    wrappers = {n: getattr(MD, n) for n in MD.KERNELS}
    with cs.slot_scan_moe():
        assert TMoE.MD is not MD
        route = TMoE.MD.moe_route(_logits(tree, x, B), cfg.top_k, 8)
        y, aux = TMoE.moe_block(p, tx, cfg, use_kernel=True)
    assert TMoE.MD is MD
    assert {n: getattr(MD, n) for n in MD.KERNELS} == wrappers
    assert not MD.is_e_major(route[4])
    wy, waux = TMoE.moe_block(p, tx, cfg, use_kernel=False)
    torch.testing.assert_close(y, wy, **TOL)
    torch.testing.assert_close(aux, waux, **TOL)


def test_build_lists_the_plain_copy_variant():
    """The -DMOE_DISPATCH_FORCE_PLAIN_COPY build (a vector a load, default
    stores): a library of its own, built beside the others by
    chip_smoke.py, which times it in turns and checks it against the plain
    dispatch; off the card its stand-in is the wrapper's plain version."""
    from repro_torch.kernels import _build
    assert MD.FORCE_PLAIN_COPY_DEFINES == ("MOE_DISPATCH_FORCE_PLAIN_COPY",)
    src = (_build.CSRC / "moe_dispatch.cu").read_text()
    assert "#ifdef MOE_DISPATCH_FORCE_PLAIN_COPY" in src
    assert _build.lib_path("moe_dispatch", MD.FORCE_PLAIN_COPY_DEFINES) != \
        _build.lib_path("moe_dispatch")
    assert '("moe_dispatch", md.FORCE_PLAIN_COPY_DEFINES)' in (
        ROOT / "chip_smoke.py").read_text()
    x = torch.randn((2, 8, 16))
    src_map = MD.moe_route(torch.from_numpy(_random_logits(2, 8, 4, seed=4)),
                           2, 8)[4]
    assert torch.equal(_chip_smoke().plain_copy_dispatch(MD, x, src_map),
                       MD.moe_dispatch(x, src_map))
