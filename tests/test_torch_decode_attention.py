"""Port parity: the decode step's attention over a KV cache.

The port runs it through ``repro_torch/kernels/decode_attention.py``: a
hand-written CUDA kernel on the card, its plain version (the torch ops
the model ran before) on the CPU.  Here, on the CPU:

(a) the port's ``decode_attention`` / ``decode_cross_attention`` on both
    routes (the kernel route takes its plain version on CPU tensors)
    against JAX's (``repro/models/attention.py``), GQA 1, 2 and 3, window,
    softcap, ``pos`` an int and a tensor, f32 at 1e-4; and the model's CPU
    decode logits equal to the bit to those of the formula the model ran
    before the kernel (a copy of it below);
(b) the kernel's split-K algorithm emulated in torch (the wrapper's split
    count, the per-split row ranges worked out from ``pos``, the partials
    combined in split order) against JAX's formula, f32 and bf16 caches,
    1e-4 on the f32 outputs;
(c) the wrapper: CPU tensors take the plain version and count no launch;
    meta tensors raise; inputs that require grad are refused; what the
    kernel does not take raises before a launch;
(d) ``chip_smoke.py``'s pure helpers for the kernel: the decode
    launches each serve path must count and the byte bound.

The CUDA kernel itself is held to the plain version on the card by
``chip_smoke.py``.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro.models.common import softcap as jax_softcap  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)


def h100_like(per_sm, rows, sms=132, gpc=16):
    """A made-up occupancy of the kind the card reports: ``per_sm`` blocks
    an SM, whole clusters of s blocks within GPCs of ``gpc`` SMs, and
    ``rows`` K / V rows in flight a block."""
    slots = per_sm * gpc
    return da.Occupancy({s: sms // gpc * (slots // s) * s
                         for s in range(1, da.MAX_SPLITS + 1)}, rows)


# the splitk routes: at most 8 blocks an SM, 128 rows in flight a block
SPLITK_OCC = h100_like(8, 128)


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _configs(nq, nkv, hd, cap=0.0, bias=False):
    """gemma2's smoke config (d_model 64) with these heads and softcap, for
    both packages."""
    kw = dict(num_heads=nq, num_kv_heads=nkv, head_dim=hd, attn_softcap=cap,
              use_bias=bias)
    return (dataclasses.replace(get_smoke_config("gemma2_27b"), **kw),
            dataclasses.replace(jax_smoke("gemma2_27b"), **kw))


def _attn_params(jcfg, seed=0):
    tree = jax.tree.map(np.asarray, JA.init_attention(
        KeyGen(jax.random.PRNGKey(seed)), jcfg, jnp.float32))
    rng = np.random.default_rng(seed + 1)
    for k in ("bq", "bk", "bv", "bo"):       # non-zero biases
        if k in tree:
            tree[k] = (0.1 * rng.standard_normal(tree[k].shape)).astype(
                np.float32)
    return tree


# ---------------------------------------------------------------- (a)

# nq, nkv, window, cap, pos as a tensor
SELF_CASES = {
    "mha": (4, 4, 0, 0.0, False),
    "gqa2_tensor_pos": (4, 2, 0, 0.0, True),
    "gqa3_window": (6, 2, 8, 0.0, False),
    "gqa2_window_cap_tensor_pos": (4, 2, 8, 50.0, True),
    "mha_cap": (2, 2, 0, 5.0, False),
}


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel_route"])
@pytest.mark.parametrize("pos", [0, 13, 23])
@pytest.mark.parametrize("case", sorted(SELF_CASES))
def test_decode_attention_matches_jax(case, pos, use_kernel):
    nq, nkv, window, cap, as_tensor = SELF_CASES[case]
    cfg, jcfg = _configs(nq, nkv, 16, cap, bias=True)
    tree = _attn_params(jcfg)
    b, t = 2, 24
    x = rnd(3, (b, 1, cfg.d_model))
    k, v = rnd(4, (b, t, nkv, 16)), rnd(5, (b, t, nkv, 16))
    jy, jcache = JA.decode_attention(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jnp.int32(pos), jcfg,
        window=window or None)
    cache = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())}
    at = torch.tensor(pos) if as_tensor else pos
    tp = params_from_numpy(tree, "cpu")
    y, out = TA.decode_attention(tp, torch.from_numpy(x), cache, at, cfg,
                                 window=window, use_kernel=use_kernel)
    assert out is cache
    y = y + TA.out_bias(tp, cfg)  # the caller's (the block's norm) add
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]),
                                   **TOL)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel_route"])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (4, 2), (6, 2)])
def test_decode_cross_attention_matches_jax(nq, nkv, use_kernel):
    """Every row attended, the zero rows past the encoder output too."""
    cfg, jcfg = _configs(nq, nkv, 16, bias=True)
    tree = _attn_params(jcfg, seed=2)
    x = rnd(6, (2, 1, cfg.d_model))
    k, v = rnd(7, (2, 10, nkv, 16)), rnd(8, (2, 10, nkv, 16))
    k[:, 7:] = v[:, 7:] = 0.0
    jy = JA.decode_cross_attention(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(x), jnp.asarray(k),
                                   jnp.asarray(v), jcfg)
    tp = params_from_numpy(tree, "cpu")
    y = TA.decode_cross_attention(tp, torch.from_numpy(x),
                                  torch.from_numpy(k), torch.from_numpy(v),
                                  cfg, use_kernel=use_kernel)
    y = y + TA.out_bias(tp, cfg)  # the caller's (the block's norm) add
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def _parent_scores(q, k):
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nq // nkv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    return scores / math.sqrt(hd)


def _parent_out(probs, v):
    b, nkv, g, s, t = probs.shape
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(b, s, nkv * g, -1)


def _parent_softcap(x, cap):
    return x.div(cap).tanh_().mul_(cap) if cap else x


def _parent_decode_attention(p, x, cache, pos, cfg, *, window=0,
                             use_rope=True, use_kernel=False):
    """The model's decode attention before the kernel, op for op (the
    output projection's bias left to the caller)."""
    b = x.shape[0]
    at = TA.position(pos, x.device)
    positions = at.view(1, 1).expand(b, 1)
    t_max = cache["k"].shape[1]
    q, k_new, v_new = TA._project_qkv(p, x, cfg, positions,
                                      use_rope=use_rope)
    TA._write_row(cache["k"], pos, k_new)
    TA._write_row(cache["v"], pos, v_new)
    scores = _parent_softcap(_parent_scores(q, cache["k"]), cfg.attn_softcap)
    kpos = torch.arange(t_max, device=x.device)[None, None, None, None, :]
    mask = kpos <= at
    if window:
        mask = mask & (at - kpos < window)
    scores = scores.masked_fill(~mask, -1e30)
    out = _parent_out(torch.softmax(scores, dim=-1), cache["v"]).to(x.dtype)
    return TA._out_proj(p, out), cache


def _parent_decode_cross_attention(p, x, k, v, cfg, *, use_kernel=False):
    q = TA.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.use_bias:
        q = q + p["bq"]
    probs = torch.softmax(_parent_scores(q, k), dim=-1)
    return TA._out_proj(p, _parent_out(probs, v).to(x.dtype))


def _clone(tree):
    return {k: (_clone(v) if isinstance(v, dict) else v.clone())
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma2_27b", "whisper_large_v3",
                                  "zamba2_2_7b", "granite_moe_3b_a800m"])
def test_cpu_decode_logits_bitwise_equal_to_the_parent_formula(
        arch, dtype, monkeypatch):
    """The plain route (the CPU's, ``use_kernel`` None or False) and the
    kernel route on CPU tensors give the bits of the formula the model ran
    before; gemma2 decodes past its 32-token smoke window."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, ssm_chunk=8)
    params = TM.init_params(cfg, device="cpu")
    s = 40 if cfg.local_window else 16
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, s)))
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rnd(
            1, (2, s // cfg.encoder_ratio, cfg.d_model)))
    with torch.inference_mode():
        _, cache = TM.prefill(params, cfg, batch, max_seq=s + 4)
    tok = toks[:, -1:]

    def logits(c, **kw):
        with torch.inference_mode():
            out = [TM.decode_step(params, cfg, c, tok, s + i, **kw)[0]
                   for i in range(2)]
        return torch.cat(out, 1)

    routes = {"plain": logits(_clone(cache)),
              "kernel_route": logits(_clone(cache), use_kernel=True)}
    monkeypatch.setattr(TM, "decode_attention", _parent_decode_attention)
    monkeypatch.setattr(TM, "decode_cross_attention",
                        _parent_decode_cross_attention)
    want = logits(_clone(cache))
    for name, got in routes.items():
        assert torch.equal(got, want), name


# ---------------------------------------------------------------- (b)

def emulate(q, k, v, pos, window=0, cap=0.0, all_rows=False,
            occ=SPLITK_OCC):
    """The kernel's algorithm on the CPU: the wrapper's split count (from
    a made-up occupancy ``occ``), the rows of each split from ``pos`` as
    the kernel works them out, a partial (max, sum, P V) a split in f32,
    the partials combined in split order (an empty one: max -inf, sum 0).
    q (B, nq, D) -> f32."""
    b, nq, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    splits = da.num_splits(b * nkv, da.row_bound(t, window, all_rows),
                           2 * d * k.element_size(), occ)
    ranges = da.split_rows(pos, t, window, all_rows, splits)
    qf = q.float().reshape(b, nkv, g, d)
    out = torch.empty((b, nkv, g, d))
    for bi in range(b):
        for h in range(nkv):
            parts = []
            for r0, r1 in ranges:
                if r1 <= r0:
                    parts.append((torch.full((g,), -math.inf),
                                  torch.zeros(g), torch.zeros(g, d)))
                    continue
                kk, vv = k[bi, r0:r1, h].float(), v[bi, r0:r1, h].float()
                s = qf[bi, h] @ kk.T / math.sqrt(d)
                if cap:
                    s = cap * torch.tanh(s / cap)
                m = s.max(-1).values
                p = torch.exp(s - m[:, None])
                parts.append((m, p.sum(-1), p @ vv))
            mx = torch.stack([m for m, _, _ in parts]).max(0).values
            acc, den = torch.zeros(g, d), torch.zeros(g)
            for m, l_, a in parts:
                f = torch.where(m == -math.inf, torch.zeros(()),
                                torch.exp(m - mx))
                acc = acc + a * f[:, None]
                den = den + l_ * f
            out[bi, h] = acc / den[:, None]
    return out.reshape(b, nq, d)


def jax_attend(q, k, v, pos, window=0, cap=0.0, all_rows=False):
    """JAX's decode attention over a cache (``repro/models/attention.py``
    ``decode_attention`` after the row is written, or
    ``decode_cross_attention``), from its own pieces: q (B, nq, D)."""
    qj = jnp.asarray(q)[:, None]
    kj, vj = jnp.asarray(k), jnp.asarray(v)
    scores = JA._gqa_scores(qj, kj, None)
    if all_rows:
        probs = jax.nn.softmax(scores, axis=-1)
    else:
        scores = jax_softcap(scores, cap)
        kpos = jnp.arange(k.shape[1])[None, None, None, None, :]
        mask = kpos <= pos
        if window:
            mask = mask & (pos - kpos < window)
        probs = jax.nn.softmax(jnp.where(mask, scores, -1e30), axis=-1)
    return np.asarray(JA._gqa_out(probs, vj))[:, 0]


# name: B, nq, nkv, T, D, pos, window, cap, all_rows
EMULATION_CASES = {
    "d16_mha_pos0": (2, 2, 2, 300, 16, 0, 0, 0.0, False),
    "d16_mha_last": (2, 2, 2, 300, 16, 299, 0, 0.0, False),
    "d80_gqa2": (2, 4, 2, 300, 80, 211, 0, 0.0, False),
    "d128_gqa6_cap": (1, 12, 2, 257, 128, 256, 0, 50.0, False),
    "d128_gqa8": (2, 16, 2, 200, 128, 150, 0, 0.0, False),
    # two chunks of 6 query heads a kv head (command-r-plus-104b's group)
    "d128_gqa12": (2, 24, 2, 300, 128, 250, 0, 0.0, False),
    # the window's first row inside a split, not on its edge
    "d80_gqa2_window_across_splits": (2, 4, 2, 400, 80, 350, 300, 5.0,
                                      False),
    "d16_gqa8_window_pos_below_it": (1, 8, 1, 200, 16, 40, 150, 0.0, False),
    # pos in the first split: the later splits are empty
    "d128_gqa1_empty_splits": (2, 2, 2, 512, 128, 9, 0, 0.0, False),
    "d80_cross_all_rows": (2, 4, 4, 300, 80, 0, 0, 0.0, True),
    "d64_cross_one_split": (2, 4, 4, 66, 64, 0, 0, 0.0, True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_split_k_emulation_matches_jax(case, dtype):
    b, nq, nkv, t, d, pos, window, cap, all_rows = EMULATION_CASES[case]
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rnd(1, (b, nq, d))).to(dt)
    k = torch.from_numpy(rnd(2, (b, t, nkv, d))).to(dt)
    v = torch.from_numpy(rnd(3, (b, t, nkv, d))).to(dt)
    # JAX reads the same (rounded) values, as f32
    want = jax_attend(q.float().numpy(), k.float().numpy(),
                      v.float().numpy(), pos, window, cap, all_rows)
    got = emulate(q, k, v, pos, window, cap, all_rows)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = da.decode_attention_plain(q, k, v, torch.tensor(pos),
                                      window=window, logit_cap=cap,
                                      all_rows=all_rows)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)


def test_emulation_cases_cover_the_split_edges():
    """The cases above hold what they are named for."""
    def ranges(name):
        b, nq, nkv, t, d, pos, window, cap, all_rows = EMULATION_CASES[name]
        splits = da.num_splits(b * nkv, da.row_bound(t, window, all_rows),
                               2 * d * 4, SPLITK_OCC)
        return splits, da.split_rows(pos, t, window, all_rows, splits)
    splits, r = ranges("d128_gqa1_empty_splits")
    assert splits == 4 and r[0] == (0, 10) and all(e <= s for s, e in r[1:])
    splits, r = ranges("d80_gqa2_window_across_splits")
    assert splits == 3 and r[0][0] == 51 and r[0][0] % da.ROW_ALIGN
    assert r[-1][1] == 351
    splits, r = ranges("d16_gqa8_window_pos_below_it")
    assert splits == 2 and r == [(0, 32), (32, 41)]
    assert ranges("d16_mha_last")[1][-1][1] == 300
    assert ranges("d80_cross_all_rows")[1] == [(0, 112), (112, 224),
                                               (224, 300)]
    assert ranges("d64_cross_one_split")[1] == [(0, 66)]


# blocks resident at 1..8 splits a cluster, as the H100 (NVIDIA H100 80GB
# HBM3, 700 W) reported them for each instance (``tune.py --decode``), and
# the rows a block keeps in flight
OCC = {
    "splitk_g1_d128": da.Occupancy(dict(zip(range(1, 9), (
        528, 528, 489, 496, 470, 474, 483, 496))), 64),
    "splitk_g1_d64": da.Occupancy(dict(zip(range(1, 9), (
        528, 528, 489, 496, 470, 474, 483, 496))), 128),
    "mma_d128": da.Occupancy(dict(zip(range(1, 9), (
        396, 396, 372, 368, 345, 372, 329, 360))), 128),
    "mma_d64": da.Occupancy(dict(zip(range(1, 9), (
        792, 792, 744, 744, 730, 744, 707, 736))), 128),
    "mma_d128_16_heads": da.Occupancy(dict(zip(range(1, 9), (
        264, 264, 237, 248, 235, 234, 224, 240))), 128),
}


@pytest.mark.parametrize("items,rows,row_bytes,occ,want", [
    # the serve paths' shapes on their routes: (b, kv head, chunk)s, the
    # static row bound, K + V bytes a row
    (128, 528, 512, "splitk_g1_d128", 3),   # codeqwen: 3 fit one wave
    (32, 8208, 512, "mma_d128", 5),         # gemma2 global: 10 MiB in flight
    (32, 4096, 512, "mma_d128", 5),         # gemma2 local: its window
    (32, 528, 512, "mma_d128", 5),          # nemotron, chameleon: 5 x 128 rows
    (32, 528, 256, "mma_d64", 5),           # granite
    (80, 528, 256, "splitk_g1_d64", 4),     # whisper self: 10 MiB in flight
    (80, 66, 256, "splitk_g1_d64", 1),      # whisper cross: 66 rows, in flight
    (128, 528, 320, "splitk_g1_d128", 3),   # zamba2 (D 80)
    (32, 528, 512, "mma_d128_16_heads", 5),  # command-r-plus: 1 chunk
    (1, 100000, 512, "mma_d128", 8),        # at most MAX_SPLITS
    (1000, 100000, 512, "mma_d128", 1),     # no count fits one wave
    (4, 10, 512, "mma_d128", 1),
])
def test_num_splits(items, rows, row_bytes, occ, want):
    assert da.num_splits(items, rows, row_bytes, OCC[occ]) == want


def test_num_splits_never_more_than_fit_one_wave():
    """A made-up card on which clusters of more than 3 blocks fit badly:
    the rule never picks a count whose blocks are not all resident."""
    occ = da.Occupancy({1: 400, 2: 400, 3: 399, 4: 100, 5: 100, 6: 96,
                        7: 98, 8: 96}, 16)
    for items in (1, 10, 30, 100, 133, 200, 400, 401):
        s = da.num_splits(items, 10 ** 6, 512, occ)
        assert 1 <= s <= da.MAX_SPLITS
        assert s == 1 or items * s <= occ.blocks[s]


def test_split_count_reads_no_position():
    """The count is fixed by the shape (the static row bound), so one CUDA
    graph capture serves every position."""
    import inspect
    for fn in (da.num_splits, da.splits_for):
        assert "pos" not in inspect.signature(fn).parameters


@pytest.mark.parametrize("group,want", [
    (1, (1, 1)), (8, (1, 8)), (9, (2, 5)), (12, (2, 6)), (16, (2, 8)),
    (17, (3, 6)), (24, (3, 8)),
])
def test_head_chunks(group, want):
    """On the splitk routes groups past 8 heads go in equal chunks of at
    most 8, which cover the group once."""
    chunks, heads = da.head_chunks(group, "splitk_bf16", 128)
    assert (chunks, heads) == want
    assert heads <= da.max_heads("splitk_bf16", 128) \
        and (chunks - 1) * heads < group <= chunks * heads


@pytest.mark.parametrize("route_name,d,group,want", [
    ("mma_bf16", 128, 12, (1, 12)),    # command-r-plus-104b: one chunk
    ("mma_bf16", 128, 16, (1, 16)),
    ("mma_bf16", 64, 17, (2, 9)),
    ("mma_bf16", 128, 24, (2, 12)),
    ("mma_bf16", 256, 12, (2, 6)),     # D 256: 8 heads a block
    ("mma_bf16", 80, 2, (1, 2)),
    ("splitk_f32", 128, 12, (2, 6)),
])
def test_head_chunks_by_route(route_name, d, group, want):
    chunks, heads = da.head_chunks(group, route_name, d)
    assert (chunks, heads) == want
    assert heads <= da.max_heads(route_name, d) \
        and (chunks - 1) * heads < group <= chunks * heads


@pytest.mark.parametrize("dtype,group,d,want", [
    # the serve paths' decode shapes
    (torch.bfloat16, 1, 128, "splitk_bf16"),     # codeqwen
    (torch.bfloat16, 2, 128, "mma_bf16"),        # gemma2
    (torch.bfloat16, 6, 128, "mma_bf16"),        # nemotron
    (torch.bfloat16, 8, 128, "mma_bf16"),        # chameleon
    (torch.bfloat16, 3, 64, "mma_bf16"),         # granite
    (torch.bfloat16, 1, 64, "splitk_bf16"),      # whisper, self and cross
    (torch.bfloat16, 1, 80, "splitk_bf16"),      # zamba2
    (torch.bfloat16, 12, 128, "mma_bf16"),       # command-r-plus-104b
    (torch.bfloat16, 2, 256, "mma_bf16"),
    (torch.bfloat16, 2, 80, "mma_bf16"),
    # head dims that are not a multiple of 16 keep the CUDA cores
    (torch.bfloat16, 2, 8, "splitk_bf16"),
    (torch.bfloat16, 8, 24, "splitk_bf16"),
    (torch.bfloat16, 3, 40, "splitk_bf16"),
    (torch.bfloat16, 6, 72, "splitk_bf16"),
    (torch.bfloat16, 2, 136, "splitk_bf16"),
    (torch.float32, 8, 128, "splitk_f32"),
    (torch.float32, 1, 64, "splitk_f32"),
])
def test_route_by_dtype_group_and_head_dim(dtype, group, d, want):
    assert da.route(dtype, group, d) == want


# ---------------------------------------------------------------- (b')
# The ``mma_bf16`` route's arithmetic, emulated in torch: the kernel's
# ring of MMA_ROWS-row stages, 16-row m-tiles dealt to MMA_WARPS warps in
# turn, each warp's online softmax over its m-tiles, bf16 q . k products
# summed in f32, P entering P V as hi + lo bf16 halves, the row sums f32,
# the warps and then the splits combined in order.

MMA_ROWS, MMA_STAGES, MMA_WARPS = 64, 2, 4
MMA_OCC = h100_like(3, MMA_ROWS * MMA_STAGES)


def _bf16(t):
    return t.bfloat16().float()


def _weights(p, plan):
    """P as the products see it: hi + lo bf16 halves (the kernel's), one
    bf16 rounding ("hi"), or f32 (None)."""
    if plan == "hi_lo":
        hi = _bf16(p)
        return [hi, _bf16(p - hi)]
    return [_bf16(p)] if plan == "hi" else [p]


def _rescale(a, m):
    return torch.where(a == -math.inf, torch.zeros(()),
                       torch.exp(a - torch.where(m == -math.inf,
                                                 torch.zeros(()), m)))


def _combine(parts):
    """(max, sum, output) partials combined in order, as the kernel does
    its warps' and its splits'."""
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    acc, den = 0.0, 0.0
    for m, l_, a in parts:
        f = _rescale(m, mx)
        acc = acc + a * f[:, None]
        den = den + l_ * f
    return mx, den, acc


def emulate_mma(q, k, v, pos, window=0, cap=0.0, all_rows=False,
                occ=MMA_OCC, plan="hi_lo"):
    """The mma_bf16 kernel's arithmetic on the CPU: bf16 q, k, v (B, nq,
    D), (B, T, nkv, D) -> f32 (B, nq, D)."""
    b, nq, d = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    chunks, heads = da.head_chunks(g, "mma_bf16", d)
    splits = da.num_splits(b * nkv * chunks, da.row_bound(t, window, all_rows),
                           2 * d * k.element_size(), occ)
    ranges = da.split_rows(pos, t, window, all_rows, splits)
    qf = q.float().reshape(b, nkv, g, d)
    kf, vf = k.float(), v.float()
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    out = torch.empty((b, nkv, g, d))
    for bi in range(b):
        for h in range(nkv):
            parts = []
            for r0, r1 in ranges:
                warps = [(torch.full((g,), -math.inf), torch.zeros(g),
                          torch.zeros(g, d)) for _ in range(MMA_WARPS)]
                for row0 in range(r0, r1, MMA_ROWS):
                    for mt in range(MMA_ROWS // 16):
                        row = row0 + 16 * mt
                        if row >= r1:
                            break
                        kk = kf[bi, row:min(row + 16, r1), h]
                        vv = vf[bi, row:min(row + 16, r1), h]
                        sc = (qf[bi, h] @ kk.T) * scale
                        if cap:
                            sc = cap * torch.tanh(sc / cap)
                        m, l_, o = warps[mt % MMA_WARPS]
                        mn = torch.maximum(m, sc.max(-1).values)
                        corr = _rescale(m, mn)
                        p = torch.exp(sc - mn[:, None])
                        o = o * corr[:, None]
                        for w in _weights(p, plan):
                            o = o + w @ vv
                        warps[mt % MMA_WARPS] = (mn, l_ * corr + p.sum(-1),
                                                 o)
                parts.append(_combine(warps))
            _, den, acc = _combine(parts)
            out[bi, h] = acc / den[:, None]
    return out.reshape(b, nq, d)


# name: B, nq, nkv, T, D, pos, window, cap, all_rows; the serve paths'
# decode shapes cut to a few heads and rows (chip_smoke.DECODE_PATH_CASES)
MMA_PATH_CASES = {
    "codeqwen": (2, 4, 4, 300, 128, 299, 0, 0.0, False),
    "gemma2_local": (1, 4, 2, 400, 128, 399, 200, 50.0, False),
    "gemma2_global": (1, 4, 2, 400, 128, 399, 0, 50.0, False),
    "nemotron": (2, 12, 2, 300, 128, 299, 0, 0.0, False),
    "chameleon": (2, 16, 2, 300, 128, 299, 0, 0.0, False),
    "granite": (2, 6, 2, 300, 64, 299, 0, 0.0, False),
    "whisper_self": (2, 4, 4, 300, 64, 299, 0, 0.0, False),
    "whisper_cross": (2, 4, 4, 66, 64, 0, 0, 0.0, True),
    "zamba2": (2, 4, 4, 300, 80, 299, 0, 0.0, False),
}
# chip_smoke.DECODE_OPTION_CASES' names, each held here in bf16
MMA_OPTION_CASES = (
    "gqa1_d128", "gqa2_d64_last_row", "gqa3_d80", "gqa6_d128_cap50",
    "gqa8_d64", "gqa12_d128", "window300_cap5_d80", "pos9_first_split_d128",
    "pos0_d16_gqa8", "all_rows_d64", "d256_gqa2", "strided_kv_d128")


def _option_case(name):
    for n, *rest in _chip_smoke().DECODE_OPTION_CASES:
        if n == name:
            return tuple(rest)
    raise KeyError(name)


def _mma_inputs(b, nq, nkv, t, d, seed=11):
    q = torch.from_numpy(rnd(seed, (b, nq, d))).bfloat16()
    k = torch.from_numpy(rnd(seed + 1, (b, t, nkv, d))).bfloat16()
    v = torch.from_numpy(rnd(seed + 2, (b, t, nkv, d))).bfloat16()
    return q, k, v


def _mma_case(case):
    if case in MMA_PATH_CASES:
        return MMA_PATH_CASES[case]
    return _option_case(case)


def test_mma_option_cases_are_chip_smokes():
    assert set(MMA_OPTION_CASES) == {
        c[0] for c in _chip_smoke().DECODE_OPTION_CASES}


@pytest.mark.parametrize("case", sorted(MMA_PATH_CASES) +
                         list(MMA_OPTION_CASES))
def test_mma_rounding_plan_matches_plain_and_jax(case):
    """Within 2e-5 x max|V| (chip_smoke.py's tolerance on the card) of the
    plain version and of JAX's decode attention on the same bf16 values."""
    b, nq, nkv, t, d, pos, window, cap, all_rows = _mma_case(case)
    q, k, v = _mma_inputs(b, nq, nkv, t, d)
    tol = 2e-5 * float(v.float().abs().max())
    got = emulate_mma(q, k, v, pos, window, cap, all_rows)
    plain = da.decode_attention_plain(q, k, v, torch.tensor(pos),
                                      window=window, logit_cap=cap,
                                      all_rows=all_rows)
    want = jax_attend(q.float().numpy(), k.float().numpy(),
                      v.float().numpy(), pos, window, cap, all_rows)
    assert torch.isfinite(got).all()
    assert float((got - plain).abs().max()) <= tol
    assert float(np.abs(got.numpy() - want).max()) <= tol


def test_mma_emulation_covers_splits_tiles_and_warps():
    """The path analogues cross several splits, several stages a split and
    every warp; command-r-plus's 12 heads are one chunk."""
    def splits(case):
        b, nq, nkv, t, d, pos, window, cap, all_rows = MMA_PATH_CASES[case]
        return da.num_splits(b * nkv, da.row_bound(t, window, all_rows),
                             4 * d, MMA_OCC)
    assert splits("nemotron") == 3 and splits("gemma2_global") == 4
    assert splits("gemma2_local") == 2 and splits("whisper_cross") == 1
    assert da.split_rows(399, 400, 0, False, 4)[0] == (0, 112)   # 2 stages
    assert da.head_chunks(12, "mma_bf16", 128) == (1, 12)


def test_mma_one_rounding_of_p_would_miss_the_tolerance():
    """Why P enters as hi + lo: one bf16 rounding of the f32 weights moves
    the output by up to 2^-9 of |V| (here over 2e-5 x max|V|); the f32
    weights and the hi + lo halves stay within it."""
    b, nq, nkv, t, d, pos, window, cap, all_rows = MMA_PATH_CASES["nemotron"]
    q, k, v = _mma_inputs(b, nq, nkv, t, d)
    tol = 2e-5 * float(v.float().abs().max())
    plain = da.decode_attention_plain(q, k, v, torch.tensor(pos))
    err = {plan: float((emulate_mma(q, k, v, pos, plan=plan) - plain)
                       .abs().max()) for plan in ("hi_lo", "hi", None)}
    assert err["hi_lo"] <= tol and err[None] <= tol
    assert err["hi"] > tol


def test_split_rows_cover_the_visible_rows_once():
    for pos in range(0, 70, 3):
        for window in (0, 1, 17, 64):
            for splits in (1, 3, 8):
                r = da.split_rows(pos, 64, window, False, splits)
                rows = [i for s, e in r for i in range(s, e)]
                lo = max(0, pos - window + 1) if window else 0
                assert rows == list(range(lo, min(pos, 63) + 1))
                assert all((s - r[0][0]) % da.ROW_ALIGN == 0 for s, _ in r)


# ---------------------------------------------------------------- (c)

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    q = torch.from_numpy(rnd(1, (2, 4, 16)))
    k, v = (torch.from_numpy(rnd(s, (2, 12, 2, 16))) for s in (2, 3))
    before = (da.decode_attention.launches,
              dict(da.decode_attention.launches_by_route))
    for kw in (dict(pos=5), dict(pos=torch.tensor(5), window=3,
                                 logit_cap=2.0), dict(all_rows=True)):
        got = da.decode_attention(q, k, v, **kw)
        assert got.dtype == torch.float32 and got.shape == q.shape
        assert torch.equal(got, da.decode_attention_plain(q, k, v, **kw))
    model = kops.decode_attention(q[:, None], k, v, 5)
    assert torch.equal(model[:, 0], da.decode_attention_plain(q, k, v, 5))
    assert (da.decode_attention.launches,
            dict(da.decode_attention.launches_by_route)) == before


def test_meta_tensors_raise_instead_of_falling_back():
    q = torch.empty((2, 4, 16), device="meta")
    k = torch.empty((2, 12, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        da.decode_attention(q, k, k, None, all_rows=True)


def test_inputs_that_require_grad_are_refused():
    q = torch.zeros((2, 4, 16), requires_grad=True)
    k = torch.zeros((2, 12, 2, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        da.decode_attention(q, k, k, 3)
    with torch.no_grad():
        da.decode_attention(q, k, k, 3)


@pytest.mark.parametrize("case,msg", [
    ("q_4d", "3-d"), ("kv_shapes", "do not fit"), ("gqa_3_2", "multiple"),
    ("nkv_0", "multiple"), ("head_dim_12", "head_dim"),
    ("head_dim_264", "head_dim"), ("fp16", "dtype"), ("kv_dtype", "is torch"),
    ("empty", "empty"), ("window", "window"), ("strided_d", "contiguous"),
    ("unaligned_rows", "aligned"), ("pos_int32", "0-d int64"),
    ("pos_missing", "pos must be"), ("pos_int", "0-d int64"),
])
def test_kernel_input_checks_raise(case, msg):
    """What the CUDA kernel does not take raises before any launch."""
    q = torch.zeros((2, 4, 16))
    k = v = torch.zeros((2, 12, 2, 16))
    pos, window = torch.tensor(3), 0
    if case == "q_4d":
        q = q[:, None]
    elif case == "kv_shapes":
        v = torch.zeros((2, 12, 2, 8))
    elif case == "gqa_3_2":
        q = torch.zeros((2, 3, 16))
    elif case == "nkv_0":
        k = v = torch.zeros((2, 12, 0, 16))
    elif case == "head_dim_12":
        q, k, v = torch.zeros((2, 4, 12)), torch.zeros((2, 12, 2, 12)), \
            torch.zeros((2, 12, 2, 12))
    elif case == "head_dim_264":
        q, k, v = torch.zeros((2, 4, 264)), torch.zeros((2, 12, 2, 264)), \
            torch.zeros((2, 12, 2, 264))
    elif case == "fp16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "kv_dtype":
        k = k.bfloat16()
    elif case == "empty":
        k = v = torch.zeros((2, 0, 2, 16))
    elif case == "window":
        window = -1
    elif case == "strided_d":
        k = torch.zeros((2, 12, 16, 2)).transpose(2, 3)
    elif case == "unaligned_rows":
        k = torch.zeros((2, 12, 2, 17))[..., :16]
    elif case == "pos_int32":
        pos = torch.tensor(3, dtype=torch.int32)
    elif case == "pos_missing":
        pos = None
    elif case == "pos_int":
        pos = 3
    with pytest.raises(ValueError, match=msg):
        da._check(q, k, v, pos, window, False)


@pytest.mark.parametrize("nq", [24, 32])
def test_groups_past_eight_heads_are_taken(nq):
    """12 and 16 query heads a kv head (command-r-plus-104b has 12): the
    kernel takes them in chunks, the plain version on the CPU."""
    q = torch.from_numpy(rnd(1, (2, nq, 16)))
    k, v = (torch.from_numpy(rnd(s, (2, 12, 2, 16))) for s in (2, 3))
    da._check(q, k, v, torch.tensor(3), 0, False)
    got = da.decode_attention(q, k, v, 3)
    want = jax_attend(q.numpy(), k.numpy(), v.numpy(), 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cross_cache_reads_no_position():
    q = torch.zeros((2, 4, 16))
    k = torch.zeros((2, 12, 2, 16))
    da._check(q, k, k, None, 0, True)


def test_build_lists_the_source():
    assert "decode_attention" in _build.KERNEL_SOURCES
    assert (_build.CSRC / "decode_attention.cu").exists()
    assert _build.lib_path("decode_attention").parent == _build.BUILD_DIR
    assert set(da.ROUTES) == {da.route(torch.float32, 1, 64),
                              da.route(torch.bfloat16, 1, 64),
                              da.route(torch.bfloat16, 2, 64)}
    with pytest.raises(ValueError):
        da.route(torch.float16, 1, 64)


class _CountingLib:
    """A stand-in for the library's device counters."""
    def __init__(self, counts):
        self.counts = list(counts)

    def decode_attention_launches(self, route):
        return self.counts[route] if 0 <= route < len(self.counts) \
            else 2 ** 64 - 1


def test_kernel_launches_reads_the_device_counters_in_route_order():
    lib = _CountingLib([3, 40, 7])
    assert da.kernel_launches(lib) == {"splitk_f32": 3, "splitk_bf16": 40,
                                       "mma_bf16": 7}
    lib.counts = [3, 40, 2 ** 64 - 1]       # the copy failed
    with pytest.raises(RuntimeError, match="failed"):
        da.kernel_launches(lib)


# ---------------------------------------------------------------- (d)

def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


# per serve run (two microbatches of 16 tokens: 15 decode steps each), the
# decode kernel's launches on the host (each app's eager first step and its
# capture) and on the device (every executed step, replays included)
EXPECTED_DECODE_LAUNCHES = {
    "codeqwen15_7b": (32, 128, 960),
    "mamba2_1_3b": (0, 0, 0),
    "zamba2_2_7b": (9, 36, 270),          # the shared block's 9 calls
    "granite_moe_3b_a800m": (32, 128, 960),
    "whisper_large_v3": (64, 256, 1920),  # self and cross a layer
    "gemma2_27b": (46, 184, 1380),
    "nemotron_4_15b": (32, 128, 960),
    "chameleon_34b": (48, 192, 1440),
}


# each config's decode route (bf16, its group and head dim)
DECODE_ROUTES = {
    "codeqwen15_7b": "splitk_bf16",
    "mamba2_1_3b": "splitk_bf16",         # no attention: nothing launches
    "zamba2_2_7b": "splitk_bf16",
    "granite_moe_3b_a800m": "mma_bf16",
    "whisper_large_v3": "splitk_bf16",
    "gemma2_27b": "mma_bf16",
    "nemotron_4_15b": "mma_bf16",
    "chameleon_34b": "mma_bf16",
    "command_r_plus_104b": "mma_bf16",
    "grok_1_314b": "mma_bf16",
}


@pytest.mark.parametrize("arch", sorted(DECODE_ROUTES))
def test_chip_smoke_decode_route_of_every_config(arch):
    from repro_torch.configs import ARCH_NAMES, get_config
    assert set(DECODE_ROUTES) == set(ARCH_NAMES)
    assert _chip_smoke().decode_route(torch, get_config(arch), da) \
        == DECODE_ROUTES[arch]


@pytest.mark.parametrize("arch", sorted(EXPECTED_DECODE_LAUNCHES))
def test_chip_smoke_expected_decode_launches(arch):
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    cs = _chip_smoke()
    assert set(cs.PATHS) == set(EXPECTED_DECODE_LAUNCHES)
    calls, host, device = EXPECTED_DECODE_LAUNCHES[arch]
    cfg = get_config(arch)
    shape = cs.serve_shape(arch)
    apps = shape["num_requests"] // shape["microbatch"]
    assert cs.decode_attention_calls(cfg) == calls
    assert cs.expected_decode_launches(cfg, apps, shape["decode_steps"]) \
        == {"host": host, "device": device}
    want = cs.expected_launches(torch, cfg, apps, fa, ss, da,
                                shape["decode_steps"])
    on = DECODE_ROUTES[arch]
    assert cs.decode_route(torch, cfg, da) == on
    assert want["decode_attention"] == {r: host if r == on else 0
                                        for r in da.ROUTES}
    # three sessions of the engine modes: three times the apps
    assert cs.expected_decode_launches(cfg, 3 * apps, 16) == {
        "host": 3 * host, "device": 3 * device}


def test_chip_smoke_expected_decode_launches_at_the_edges():
    from repro_torch.configs import get_config
    cs = _chip_smoke()
    cfg = get_config("codeqwen15_7b")
    # one token: no decode step; two: the eager step and a capture only
    assert cs.expected_decode_launches(cfg, 2, 1) == {"host": 0, "device": 0}
    assert cs.expected_decode_launches(cfg, 2, 2) == {"host": 128,
                                                      "device": 64}


def test_chip_smoke_decode_bound_counts_the_visible_rows_once():
    cs = _chip_smoke()
    # gemma2's global layer at its last row: K and V of 8,208 rows, q in
    # bf16, the output in f32
    nbytes = (2 * 2 * 8208 * 16 * 128 + 2 * 32 * 128) * 2 + 2 * 32 * 128 * 4
    ms, by = cs.decode_bound_ms(2, 32, 16, 128, 8208, 2)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / cs.H100_BYTES_PER_S * 1e3)
    # the rows it is given are the kernel's (``visible_rows``: [lo, end))
    assert da.visible_rows(8207, 8208, 4096, False) == (4112, 8208)
    assert da.visible_rows(100, 8208, 4096, False) == (0, 101)
    assert da.visible_rows(0, 66, 0, True) == (0, 66)
    assert da.visible_rows(527, 528, 0, False) == (0, 528)


class _Event:
    def __init__(self, key, device_type, count):
        self.key, self.device_type, self.count = key, device_type, count


def test_chip_smoke_reads_decode_launches_from_kernel_names():
    cs = _chip_smoke()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [
        _Event("void (anonymous namespace)::decode_attention_kernel<"
               "__nv_bfloat16, 16, 1>((anonymous namespace)::Params)",
               cuda, 32),
        _Event("void (anonymous namespace)::decode_attention_kernel<"
               "__nv_bfloat16, 8, 1>((anonymous namespace)::Params)", cuda, 32),
        _Event("void (anonymous namespace)::decode_attention_mma_kernel<"
               "128, 1>(CUtensorMap_st, CUtensorMap_st, "
               "(anonymous namespace)::Params)", cuda, 16),
        _Event("decode_attention_kernel", cpu, 7),       # not a device row
        _Event("void at::native::elementwise_kernel<128, 4>", cuda, 99),
    ]
    assert cs.decode_kernels_seen(torch, events) == 80
