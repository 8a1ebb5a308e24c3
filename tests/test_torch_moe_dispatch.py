"""The MoE dispatch's wrappers and plain versions (``repro_torch.kernels.
moe_dispatch``) against the reference's MoE block, on the CPU.

The kernels themselves (``csrc/moe_dispatch.cu``) run only on the card,
where ``chip_smoke.py`` holds them to the plain versions.  Here:

* ``moe_slots_plain``'s pos and keep equal the reference's
  ``cumsum(one_hot) - 1`` recomputed with jnp from the same idx (smoke
  widths of granite and grok, 1, 2 and B groups, a forced capacity
  overflow, the decode's one group), and its inverse map names every kept
  slot once; a numpy emulation of the slot kernel's tiles, warp matches
  and scan gives the same pos, keep and map;
* ``moe_dispatch_plain``'s buffer equals the reference's
  ``buf.at[...].add(mode="drop")`` by value, in f32 and bf16;
* ``moe_combine_plain``'s y is within 1e-6 x max|y| (f32) and 2^-8 |y| +
  1e-6 x max|y| (bf16) of the reference's f32 sum (bf16 rounds it once:
  at most half an ulp, 2^-8 |y|), the experts' output read e-major by
  strides as the einsum returns it;
* ``moe_block(use_kernel=True)`` equals JAX's block and the plain route,
  and granite's smoke prefill and decode steps through it give JAX's
  greedy tokens;
* the wrappers refuse a tensor that requires grad and more than 256
  experts; ``forward_train`` keeps the plain route;
* ``chip_smoke.py``'s count of the kernels' launches in a serve run.
"""
import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro.train import make_decode_step as jax_decode_step  # noqa: E402
from repro.train import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import moe_dispatch as MD  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite_moe_3b_a800m", "grok_1_314b"]
TOL = dict(atol=1e-4, rtol=1e-4)        # tests/test_torch_moe.py's
B, S = 2, 12


def _idx(g, sg, k, e, seed=0, skew=0.0):
    """Top-k experts (g, sg, k) int64 of seeded router logits; ``skew``
    adds a bias that falls with the expert's number, so that the first
    experts take most slots (a capacity overflow)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((g, sg, e)) - skew * np.arange(e)
    return np.argsort(-logits, axis=-1, kind="stable")[..., :k].astype(
        np.int64)


def _gates(idx, seed=1):
    g = np.random.default_rng(seed).random(idx.shape).astype(np.float32)
    return g / g.sum(-1, keepdims=True)


def _ref_slots(idx, e, cap):
    """The reference's pos and keep (``repro/models/moe.py``'s slot
    positions), recomputed with jnp."""
    g = idx.shape[0]
    flat = jnp.asarray(idx.reshape(g, -1))
    one = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(one, axis=1) - 1, flat[..., None],
                              axis=-1)[..., 0]
    return np.asarray(pos), np.asarray(pos < cap)


def _ref_buf(xg, idx, e, cap, dtype):
    """The reference's dispatch buffer: each slot's token added into zeros
    at (g, expert, pos), dropped slots out of bounds (mode="drop")."""
    g, sg, k = idx.shape
    d = xg.shape[-1]
    pos, keep = _ref_slots(idx, e, cap)
    flat = jnp.asarray(idx.reshape(g, -1))
    pos_safe = jnp.where(keep, pos, cap)
    src = jnp.broadcast_to(jnp.repeat(jnp.arange(sg), k)[None], (g, sg * k))
    vals = jnp.take_along_axis(jnp.asarray(xg, dtype), src[..., None],
                               axis=1)
    g_ids = jnp.broadcast_to(jnp.arange(g)[:, None], (g, sg * k))
    buf = jnp.zeros((g, e, cap, d), dtype)
    return buf.at[g_ids, flat, pos_safe].add(vals, mode="drop")


def _ref_y(out_buf, idx, gates, e, cap):
    """The reference's combine summed in f32 and not rounded: the gather
    of each slot (clamped when dropped), masked by keep, weighted by the
    gates and summed over k."""
    g, sg, k = idx.shape
    pos, keep = _ref_slots(idx, e, cap)
    flat = jnp.asarray(idx.reshape(g, -1))
    g_ids = jnp.broadcast_to(jnp.arange(g)[:, None], (g, sg * k))
    gathered = out_buf[g_ids, flat, jnp.where(keep, pos, cap)]
    gathered = jnp.where(keep[..., None], gathered, 0.0)
    gathered = gathered.reshape(g, sg, k, -1)
    return np.asarray(jnp.einsum("gskd,gsk->gsd",
                                 gathered.astype(jnp.float32), gates))


# (name, groups, tokens a group, k, experts, capacity, skew): granite's
# and grok's smoke widths at B, 2 and 1 groups, a forced overflow, the
# decode's one group, 256 experts
SLOT_CASES = [
    ("granite_b", 2, 12, 4, 8, 8, 0.0),
    ("granite_g2", 2, 12, 4, 8, 8, 0.0),
    ("granite_g1", 1, 24, 4, 8, 16, 0.0),
    ("granite_overflow", 2, 48, 4, 8, 8, 2.0),
    ("granite_decode", 1, 2, 4, 8, 8, 0.0),
    ("grok_b", 2, 12, 2, 4, 8, 0.0),
    ("grok_g1", 1, 24, 2, 4, 16, 0.0),
    ("grok_overflow", 3, 40, 2, 4, 8, 3.0),
    ("e256_tiles", 2, 300, 8, 256, 16, 0.01),
]


@pytest.mark.parametrize("case", SLOT_CASES, ids=[c[0] for c in SLOT_CASES])
def test_slots_plain_are_the_references(case):
    _, g, sg, k, e, cap, skew = case
    idx = _idx(g, sg, k, e, seed=sg, skew=skew)
    pos, keep, src = MD.moe_slots_plain(torch.from_numpy(idx), e, cap)
    want_pos, want_keep = _ref_slots(idx, e, cap)
    assert pos.dtype == src.dtype == torch.int32 and keep.dtype == torch.bool
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if skew:
        assert not keep.all()
    # the inverse map: every kept slot once, by its token row; -1 elsewhere
    flat = idx.reshape(g, -1)
    want_src = np.full((g, e, cap), -1)
    for gi, j in zip(*np.nonzero(want_keep)):
        want_src[gi, flat[gi, j], want_pos[gi, j]] = j // k
    np.testing.assert_array_equal(src.numpy(), want_src)


def _emulated_slots(idx, e, cap, threads=1024):
    """The slot kernel's algorithm in numpy: a block a group, tiles of
    min(threads, n rounded up to a warp) slots; in each warp a slot's rank
    among the earlier lanes of its expert (``__match_any_sync``), the
    warps' counts turned into offsets in warp order from the expert's
    total so far; then -1 past each expert's count."""
    g, sg, k = idx.shape
    n = sg * k
    block = min(threads, -(-n // 32) * 32)
    flat = idx.reshape(g, n)
    pos = np.zeros((g, n), np.int32)
    src = np.zeros((g, e, cap), np.int32)
    for gi in range(g):
        carry = np.zeros(e, np.int64)
        for base in range(0, n, block):
            ids = np.full(block, -1)
            ids[:min(block, n - base)] = flat[gi, base:base + block]
            lanes = ids.reshape(-1, 32)
            rank = np.array([[np.sum(w[:i] == w[i]) for i in range(32)]
                             for w in lanes])
            counts = np.array([[np.sum(w == x) for x in range(e)]
                               for w in lanes])
            offsets = carry + np.cumsum(counts, axis=0) - counts
            carry = carry + counts.sum(axis=0)
            for t in range(min(block, n - base)):
                w, x = divmod(t, 32)
                p = offsets[w, ids[t]] + rank[w, x]
                pos[gi, base + t] = p
                if p < cap:
                    src[gi, ids[t], p] = (base + t) // k
        for x in range(e):
            src[gi, x, min(carry[x], cap):] = -1
    return pos, pos < cap, src


@pytest.mark.parametrize("case", [c for c in SLOT_CASES if c[0] in (
    "granite_overflow", "granite_decode", "grok_overflow", "e256_tiles")],
    ids=lambda c: c[0])
def test_emulated_slot_kernel_is_the_plain_version(case):
    """Tiles of 1024 slots (``e256_tiles``: 2400 slots, three tiles), and
    of 64 to test the carry between tiles at the smaller widths."""
    _, g, sg, k, e, cap, skew = case
    idx = _idx(g, sg, k, e, seed=sg, skew=skew)
    want = MD.moe_slots_plain(torch.from_numpy(idx), e, cap)
    for threads in (1024, 64):
        got = _emulated_slots(idx, e, cap, threads)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy())


def test_slot_kernel_constants_are_the_wrappers():
    src = (_build.CSRC / "moe_dispatch.cu").read_text()
    assert int(re.search(r"constexpr int kMaxExperts = (\d+);",
                         src).group(1)) == MD.MAX_EXPERTS
    for name in ("moe_slots", "moe_dispatch", "moe_combine", "moe_route",
                 "moe_route_scratch_bytes", "moe_dispatch_launches"):
        assert re.search(rf'extern "C" \w+(?: \w+)* {name}\(', src), name
    assert set(re.findall(r"\b(moe_\w+_kernel)\b", src)) == {
        "moe_slots_kernel", "moe_dispatch_kernel", "moe_combine_kernel",
        "moe_route_kernel"}
    assert "moe_dispatch" in _build.KERNEL_SOURCES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [c for c in SLOT_CASES if c[0] in (
    "granite_b", "granite_overflow", "granite_decode", "grok_g1")],
    ids=lambda c: c[0])
def test_dispatch_plain_is_the_references(case, dtype):
    _, g, sg, k, e, cap, skew = case
    d = 13
    idx = _idx(g, sg, k, e, seed=sg, skew=skew)
    x = np.random.default_rng(5).standard_normal((g, sg, d)).astype(
        np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    _, _, src = MD.moe_slots_plain(torch.from_numpy(idx), e, cap)
    buf = MD.moe_dispatch_plain(tx, src)
    want = _ref_buf(x, idx, e, cap, jnp.dtype(dtype))
    assert buf.dtype == tx.dtype and tuple(buf.shape) == want.shape
    np.testing.assert_array_equal(buf.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [c for c in SLOT_CASES if c[0] in (
    "granite_b", "granite_overflow", "granite_decode", "grok_overflow",
    "e256_tiles")], ids=lambda c: c[0])
def test_combine_plain_is_within_tolerance_of_the_reference(case, dtype):
    _, g, sg, k, e, cap, skew = case
    d = 24
    idx = _idx(g, sg, k, e, seed=sg, skew=skew)
    gates = _gates(idx)
    out = np.random.default_rng(7).standard_normal((e, g, cap, d)).astype(
        np.float32)
    # the experts' einsum returns its output e-major: (g, e, cap, d) by
    # strides
    t_out = torch.from_numpy(out).to(getattr(torch, dtype)).permute(
        1, 0, 2, 3)
    pos, keep, _ = MD.moe_slots_plain(torch.from_numpy(idx), e, cap)
    y = MD.moe_combine_plain(t_out, torch.from_numpy(idx), pos, keep,
                             torch.from_numpy(gates), t_out.dtype)
    want = _ref_y(jnp.asarray(t_out.float().numpy(), jnp.dtype(dtype)),
                  idx, gates, e, cap)
    assert y.dtype == t_out.dtype and tuple(y.shape) == (g, sg, d)
    err = np.abs(y.float().numpy() - want)
    big = np.abs(want).max()
    bound = 1e-6 * big + (2.0 ** -8 * np.abs(want)
                          if dtype == "bfloat16" else 0.0)
    assert (err <= bound).all(), err.max()


def _block_inputs(arch, b, s, seed=1, **kw):
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    jcfg = dataclasses.replace(jax_smoke(arch), **kw)
    tree = jax.tree.map(np.asarray, JMoE.init_moe(
        KeyGen(jax.random.PRNGKey(0)), jcfg, jnp.dtype(jcfg.dtype)))
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, tree, x


@pytest.mark.parametrize("kw", [dict(), dict(num_groups=1),
                                dict(num_groups=2),
                                dict(capacity_factor=0.25)],
                         ids=["b_groups", "one_group", "two_groups",
                              "overflow"])
@pytest.mark.parametrize("arch", ARCHS)
def test_block_with_kernels_is_jax_and_the_plain_route(arch, kw):
    kw = dict(kw)
    groups = kw.pop("num_groups", None)
    s = 48 if kw else S
    cfg, jcfg, tree, x = _block_inputs(arch, B, s, **kw)
    jy, jaux = JMoE.moe_block(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(x), jcfg, num_groups=groups)
    p, tx = params_from_numpy(tree, "cpu"), torch.from_numpy(x)
    y, aux = TMoE.moe_block(p, tx, cfg, num_groups=groups, use_kernel=True)
    plain_y, plain_aux = TMoE.moe_block(p, tx, cfg, num_groups=groups)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **TOL)
    assert torch.equal(y, plain_y) and torch.equal(aux, plain_aux)


def test_block_with_kernels_in_bf16_is_the_plain_route():
    cfg, _, tree, x = _block_inputs("granite_moe_3b_a800m", B, S,
                                    dtype="bfloat16")
    p = params_from_numpy(tree, "cpu")
    tx = torch.from_numpy(x).bfloat16()
    y, _ = TMoE.moe_block(p, tx, cfg, use_kernel=True)
    plain, _ = TMoE.moe_block(p, tx, cfg)
    assert y.dtype == torch.bfloat16 and torch.equal(y, plain)


def test_granite_serve_through_the_kernels_gives_jax_tokens(monkeypatch):
    """Granite's smoke prefill and 3 decode steps with ``use_kernel=True``
    (the MoE wrappers' plain versions on the CPU) give the greedy tokens
    of JAX's jitted prefill and decode steps."""
    steps, s = 3, 16
    cfg, jcfg = (get_smoke_config("granite_moe_3b_a800m"),
                 jax_smoke("granite_moe_3b_a800m"))
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(B, s)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    first, jcache = jax.jit(jax_prefill_step(jcfg))(jp, {"tokens": tokens})
    jcache = jax.tree.map(
        lambda dst, src: jnp.pad(
            src, [(0, d - n) for d, n in zip(dst.shape, src.shape)]
        ).astype(dst.dtype), JM.init_cache(jcfg, B, s + steps), jcache)
    step = jax.jit(jax_decode_step(jcfg))
    tok, want = first[:, None], [np.asarray(first)[:, None]]
    for i in range(steps):
        tok, jcache = step(jp, jcache, tok, jnp.int32(s + i))
        want.append(np.asarray(tok))

    calls = _spy(monkeypatch)
    tp = params_from_numpy(tree, "cpu")
    with torch.inference_mode():
        logits, cache = TM.prefill(tp, cfg,
                                   {"tokens": torch.from_numpy(tokens)},
                                   use_kernel=True, max_seq=s + steps)
        tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
        got = [tok]
        for i in range(steps):
            logits, cache = TM.decode_step(tp, cfg, cache, tok, s + i,
                                           use_kernel=True)
            tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
            got.append(tok)
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(),
                                  np.concatenate(want, axis=1))
    # one call a layer a prefill and a decode step; the slot scan of the
    # router's idx gave way to the route
    assert calls == {**dict.fromkeys(MD.KERNELS,
                                     cfg.num_layers * (1 + steps)),
                     "moe_slots": 0}


def _spy(monkeypatch):
    """Counts the calls of the three wrappers as ``models.moe`` makes
    them."""
    calls = dict.fromkeys(MD.KERNELS, 0)
    for name in MD.KERNELS:
        def spy(*a, _real=getattr(MD, name), _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(MD, name, spy)
    return calls


def test_wrappers_refuse_grads_and_too_many_experts():
    idx = torch.from_numpy(_idx(1, 4, 2, 8))
    x = torch.zeros((1, 4, 16), requires_grad=True)
    _, _, src = MD.moe_slots(idx, 8, 8)
    with pytest.raises(RuntimeError, match="no backward"):
        MD.moe_dispatch(x, src)
    out = torch.zeros((1, 8, 8, 16), requires_grad=True)
    pos, keep, _ = MD.moe_slots(idx, 8, 8)
    gates = torch.from_numpy(_gates(idx.numpy()))
    with pytest.raises(RuntimeError, match="no backward"):
        MD.moe_combine(out, idx, pos, keep, gates, out.dtype)
    with pytest.raises(RuntimeError, match="no backward"):
        MD.moe_combine(out.detach(), idx, pos, keep,
                       gates.requires_grad_(), out.dtype)
    for e, k in ((257, 2), (8, 9)):
        with pytest.raises(ValueError, match="experts"):
            MD.moe_slots(torch.zeros((1, 4, k), dtype=torch.int64), e, 8)
    with pytest.raises(ValueError):
        MD.moe_dispatch(x.detach(), torch.zeros((1, 257, 8),
                                                dtype=torch.int32))
    with pytest.raises(ValueError):      # y in another dtype than out_buf's
        MD.moe_combine(out.detach(), idx, pos, keep, gates.detach(),
                       torch.bfloat16)


def test_cpu_and_meta_take_the_plain_versions():
    idx = torch.from_numpy(_idx(2, 6, 2, 4))
    got = MD.moe_slots(idx, 4, 8)
    want = MD.moe_slots_plain(idx, 4, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pos, keep, src = MD.moe_slots(idx.to("meta"), 4, 8)
    assert pos.device.type == "meta" and tuple(src.shape) == (2, 4, 8)
    with pytest.raises(ValueError, match="inputs on"):
        MD.moe_dispatch(torch.zeros((2, 6, 8), device="meta"), got[2])


def test_forward_train_keeps_the_plain_route(monkeypatch):
    """The train path on the MoE smoke config calls no wrapper (they have
    no backward): every block runs on the plain route, and the experts
    get finite, nonzero grads through its ops."""
    cfg = get_smoke_config("granite_moe_3b_a800m")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(B, S + 1)))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    leaves = {k: v.detach().requires_grad_()
              for k, v in params["layers"]["moe"].items()}
    p = {**params, "layers": {**params["layers"], "moe": leaves}}
    calls, seen, real = _spy(monkeypatch), [], TM.moe_block

    def block(*a, **kw):
        seen.append(kw.get("use_kernel", False))
        return real(*a, **kw)
    monkeypatch.setattr(TM, "moe_block", block)
    loss = TM.forward_train(p, cfg, batch, remat=False)[0]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert calls == dict.fromkeys(MD.KERNELS, 0)
    assert seen == [False] * cfg.num_layers
    assert all(torch.isfinite(gr).all() and gr.abs().max() > 0
               for gr in grads)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "codeqwen15_7b"])
def test_serve_launches_are_chip_smokes(arch, monkeypatch):
    """A serve run of the smoke config, its blocks sent to the wrappers as
    on the card, calls each wrapper as often as
    ``chip_smoke.expected_moe_serve`` counts launches on the device (on
    the CPU every decode step runs eagerly, as the card's replays run)."""
    from repro_torch.launch.serve import run_serving
    cs = _chip_smoke()
    cfg = get_smoke_config(arch)
    shape = dict(num_requests=4, microbatch=2, decode_steps=4, prompt_len=12)
    calls, real = _spy(monkeypatch), TM.moe_block
    monkeypatch.setattr(TM, "moe_block", lambda *a, **kw: real(
        *a, **{**kw, "use_kernel": True}))
    run_serving(cfg, device="cpu", **shape)
    want = cs.expected_moe_serve(cfg, 2, shape["decode_steps"])
    assert calls == {n: w["device"] for n, w in want.items()}
    assert all(w["host"] == (2 * cfg.num_layers * 3
                             if cfg.family == "moe" and n != "moe_slots"
                             else 0)
               for n, w in want.items())
