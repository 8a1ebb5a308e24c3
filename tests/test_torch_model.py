"""Port parity: every model family (dense, vlm, moe, ssm, hybrid, encdec)
against the JAX model.

Weights come from the JAX init, bridged as numpy.  The JAX init sets every
norm scale and bias (and Mamba2's ``A_log``, ``D``, ``dt_bias``, ``conv_b``)
to constants, so the shared numpy tree first gets seeded values there;
otherwise those terms would go untested.  f32 smoke configs, atol/rtol
1e-4: both sides run the same f32 math, in another summation order (XLA vs
ATen) over 2-4 layers.  The ssm and hybrid cases run with ``ssm_chunk=8``
on both sides and 16-token prompts, so the SSD scan crosses chunks.  The
encdec case (whisper) feeds seeded f32 frames of ``S // encoder_ratio``
rows to the encoder.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCHS = ["codeqwen15_7b", "nemotron_4_15b", "command_r_plus_104b",
         "gemma2_27b", "chameleon_34b"]
SSM_ARCHS = ["mamba2_1_3b", "zamba2_2_7b"]
MOE_ENCDEC_ARCHS = ["granite_moe_3b_a800m", "grok_1_314b", "whisper_large_v3"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, STEPS = 2, 12, 3
S_SSM = 16                       # two chunks of 8
_FILLED = ("attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm",
           "bq", "bk", "bv", "bo", "norm", "conv_b", "A_log", "D", "dt_bias",
           "cross_norm", "enc_norm")


def ssm_cfgs(arch, **kw):
    """(port config, JAX config) of a smoke config with ``ssm_chunk=8``."""
    return (dataclasses.replace(get_smoke_config(arch), ssm_chunk=8, **kw),
            dataclasses.replace(jax_smoke(arch), ssm_chunk=8, **kw))


def shared_params(arch, seed=0, jcfg=None):
    """JAX init as a numpy tree, norms and biases filled from ``seed``."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(
        jcfg or jax_smoke(arch), jax.random.PRNGKey(0)))

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif k in _FILLED:
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    fill(tree)
    return tree


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def tokens(cfg, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(B, S + STEPS)).astype(np.int32)


def batch_of(cfg, toks, seed=7):
    """Numpy batch of ``toks``, plus seeded f32 frames for encdec."""
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["frames"] = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], max(toks.shape[1] // cfg.encoder_ratio, 1),
             cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def grow(jcache, jcfg, max_seq):
    """JAX's serve grows a prefill cache to ``max_seq`` by zero padding."""
    return jax.tree.map(
        lambda dst, src: jnp.pad(
            src, [(0, d - s) for d, s in zip(dst.shape, src.shape)]
        ).astype(dst.dtype),
        JM.init_cache(jcfg, B, max_seq), jcache)


def close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("arch", ARCHS + SSM_ARCHS + MOE_ENCDEC_ARCHS)
def test_param_tree_matches_jax(arch):
    cfg = get_smoke_config(arch)
    jt = jax.tree.map(np.asarray, JM.init_params(jax_smoke(arch),
                                                 jax.random.PRNGKey(0)))
    tt = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def shapes(node, conv):
        return {k: shapes(v, conv) if isinstance(v, dict) else conv(v)
                for k, v in node.items()}
    assert shapes(tt, lambda t: tuple(t.shape)) == shapes(jt, np.shape)
    assert shapes(tt, lambda t: str(t.dtype).split(".")[-1]) == \
        shapes(jt, lambda a: a.dtype.name)
    bridged = params_from_numpy(jt, "cpu")
    assert shapes(bridged, lambda t: tuple(t.shape)) == shapes(jt, np.shape)


@pytest.mark.parametrize("arch", ARCHS + MOE_ENCDEC_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    tree = shared_params(arch)
    jp, tp = to_jax(tree), params_from_numpy(tree, "cpu")
    toks = tokens(cfg)
    batch = batch_of(cfg, toks[:, :S])

    jl, jcache = jax.jit(lambda p, b: JM.prefill(p, jcfg, b))(jp, batch)
    with torch.inference_mode():
        tl, tcache = TM.prefill(tp, cfg, torch_batch(batch),
                                max_seq=S + STEPS)
    close(tl, jl)
    for name in ("k", "v"):
        close(tcache["kv"][name][:, :, :S], jcache["kv"][name])
        assert not tcache["kv"][name][:, :, S:].any()
    for name in ("cross_k", "cross_v"):
        if name in jcache:
            t = jcache[name].shape[2]
            close(tcache[name][:, :, :t], jcache[name])
            assert not tcache[name][:, :, t:].any()

    # JAX grows its cache by padding; the port preallocated max_seq
    grown = grow(jcache, jcfg, S + STEPS)
    assert {k: tuple(v.shape) for k, v in tcache.items() if k != "kv"} == \
        {k: v.shape for k, v in grown.items() if k != "kv"}
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(p, jcfg, c, t, pos))
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        jl, grown = jstep(jp, grown, tok, jnp.int32(S + i))
        with torch.inference_mode():
            tl, tcache = TM.decode_step(tp, cfg, tcache,
                                        torch.from_numpy(tok), S + i)
        close(tl, jl)
    for name in ("k", "v"):
        close(tcache["kv"][name], grown["kv"][name])


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "gemma2_27b"]
                         + MOE_ENCDEC_ARCHS)
def test_forward_train_matches_jax(arch):
    """Total loss, token loss and the moe aux loss (0 for the others)."""
    cfg = get_smoke_config(arch)
    tree = shared_params(arch, seed=2)
    toks = tokens(cfg, seed=3)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {**batch_of(cfg, toks), "labels": labels}
    jloss, jparts = JM.forward_train(to_jax(tree), jax_smoke(arch),
                                     jax.tree.map(jnp.asarray, batch))
    with torch.inference_mode():
        tloss, tparts = TM.forward_train(params_from_numpy(tree, "cpu"), cfg,
                                         torch_batch(batch))
    close(tloss, jloss)
    close(tparts["loss"], jparts["loss"])
    close(tparts["aux_loss"], jparts["aux_loss"])
    assert (float(tparts["aux_loss"]) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "gemma2_27b"]
                         + MOE_ENCDEC_ARCHS)
def test_kernel_route_on_cpu_matches_plain(arch):
    """use_kernel=True on CPU tensors takes the kernel's plain version."""
    cfg = get_smoke_config(arch)
    tp = params_from_numpy(shared_params(arch), "cpu")
    batch = torch_batch(batch_of(cfg, tokens(cfg)[:, :S]))
    with torch.inference_mode():
        lk, ck = TM.prefill(tp, cfg, batch, use_kernel=True)
        lp, cp = TM.prefill(tp, cfg, batch, use_kernel=False)
    torch.testing.assert_close(lk, lp, **TOL)
    torch.testing.assert_close(ck["kv"]["k"], cp["kv"]["k"])
    if cfg.family == "encdec":
        torch.testing.assert_close(ck["cross_k"], cp["cross_k"], **TOL)


def test_decode_continues_prefill():
    """Port self-consistency: decoding the prompt token by token from an
    empty cache gives the prefill's last logits."""
    cfg = get_smoke_config("gemma2_27b")
    tp = params_from_numpy(shared_params("gemma2_27b"), "cpu")
    prompt = torch.from_numpy(tokens(cfg)[:, :S])
    with torch.inference_mode():
        want, _ = TM.prefill(tp, cfg, {"tokens": prompt})
        cache = TM.init_cache(cfg, B, S, device="cpu")
        for i in range(S):
            got, cache = TM.decode_step(tp, cfg, cache, prompt[:, i:i + 1], i)
    torch.testing.assert_close(got, want, **TOL)


def test_bridge_keeps_bf16_bits():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32)
                               .reshape(4, 6)).astype(jnp.bfloat16))
    t = params_from_numpy({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))
    assert params_from_numpy({"w": a}, "cpu", torch.float32)["w"].dtype == \
        torch.float32


def test_unknown_family_raises():
    cfg = dataclasses.replace(get_smoke_config("codeqwen15_7b"),
                              family="rnn")
    for fn in (lambda: TM.init_params(cfg, device="cpu"),
               lambda: TM.init_cache(cfg, B, S, device="cpu")):
        with pytest.raises(ValueError, match="unknown family"):
            fn()


def test_layer_windows_match_jax():
    for arch in ARCHS:
        want = JM.layer_windows(jax_smoke(arch), S)
        got = TM.layer_windows(get_smoke_config(arch))
        if want is None:
            assert got == [0] * len(got)
        else:
            assert got == [int(w) for w in want]


# ---------------------------------------------------------------------------
# ssm (mamba2) and hybrid (zamba2)
# ---------------------------------------------------------------------------


def _grow_kv(jcache, steps):
    """JAX grows the hybrid's KV cache by padding; the port preallocated."""
    if "kv" not in jcache:
        return jcache
    pad = [(0, 0), (0, 0), (0, steps), (0, 0), (0, 0)]
    return {**jcache, "kv": jax.tree.map(lambda a: jnp.pad(a, pad),
                                         jcache["kv"])}


def _allclose(got, want):
    np.testing.assert_allclose(got, want, **TOL)


def _within_range(share):
    """|got - want| <= share x max |want| + 2e-2 |want| (five bf16 ulps):
    for bf16, where both sides round to bf16 at the same points but XLA
    fuses some elementwise chains in f32, so single values differ by an ulp
    that later layers carry (about 2 ulps after two layers)."""
    def check(got, want):
        np.testing.assert_allclose(got, want, rtol=2e-2,
                                   atol=share * np.abs(want).max())
    return check


def _close_caches(tcache, jcache, seq, check=_allclose):
    for name in ("conv", "state"):
        check(tcache["ssm"][name].float().numpy(),
              np.asarray(jcache["ssm"][name], np.float32))
    if "kv" in jcache:
        for name in ("k", "v"):
            check(tcache["kv"][name][:, :, :seq].float().numpy(),
                  np.asarray(jcache["kv"][name], np.float32))


def _ssm_prefill_and_decode(arch, dtype=None, check=_allclose):
    kw = {} if dtype is None else {"dtype": dtype}
    cfg, jcfg = ssm_cfgs(arch, **kw)
    tree = shared_params(arch, jcfg=jcfg)
    jp, tp = to_jax(tree), params_from_numpy(tree, "cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, S_SSM + STEPS)).astype(np.int32)
    prompt = toks[:, :S_SSM]
    jl, jcache = jax.jit(lambda p, t: JM.prefill(p, jcfg, {"tokens": t}))(
        jp, prompt)
    with torch.inference_mode():
        tl, tcache = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                                max_seq=S_SSM + STEPS)
    check(tl.numpy(), np.asarray(jl))
    _close_caches(tcache, jcache, S_SSM, check)
    dtypes = [(str(tcache["ssm"]["state"].dtype).split(".")[-1],
               jcache["ssm"]["state"].dtype.name)]

    grown = _grow_kv(jcache, STEPS)
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(p, jcfg, c, t, pos))
    for i in range(STEPS):
        tok = toks[:, S_SSM + i:S_SSM + i + 1]
        jl, grown = jstep(jp, grown, tok, jnp.int32(S_SSM + i))
        with torch.inference_mode():
            tl, tcache = TM.decode_step(tp, cfg, tcache,
                                        torch.from_numpy(tok), S_SSM + i)
        check(tl.numpy(), np.asarray(jl))
        dtypes.append((str(tcache["ssm"]["state"].dtype).split(".")[-1],
                       grown["ssm"]["state"].dtype.name))
    _close_caches(tcache, grown, S_SSM + STEPS, check)
    assert tcache["ssm"]["conv"].dtype == cfg.torch_dtype
    return dtypes


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_prefill_and_decode_match_jax(arch):
    """Prefill, then 3 decode steps: logits, the conv windows, the SSM
    states and (hybrid) the shared block's K/V against JAX."""
    dtypes = _ssm_prefill_and_decode(arch)
    assert all(t == j == "float32" for t, j in dtypes)


def test_ssm_bf16_decode_promotes_the_state_to_f32():
    """In bf16 the reference's decode promotes the SSM state to f32 from
    the first step on (a bf16 cache times the f32 decay), and rounds only
    that first update to bf16.  A port that rounded the state back into a
    bf16 buffer each step would carry another dtype and drift from it.
    Values within 5% of their range plus five bf16 ulps of their own size
    (see ``_within_range``)."""
    dtypes = _ssm_prefill_and_decode("mamba2_1_3b", dtype="bfloat16",
                                     check=_within_range(0.05))
    assert dtypes == [("bfloat16", "bfloat16")] + \
        [("float32", "float32")] * STEPS


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_forward_train_matches_jax(arch):
    cfg, jcfg = ssm_cfgs(arch)
    tree = shared_params(arch, seed=2)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(B, S_SSM)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jloss, jparts = JM.forward_train(
        to_jax(tree), jcfg,
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    with torch.inference_mode():
        tloss, tparts = TM.forward_train(
            params_from_numpy(tree, "cpu"), cfg,
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})
    close(tloss, jloss)
    close(tparts["loss"], jparts["loss"])


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_kernel_route_on_cpu_matches_jax_kernel_route(arch):
    """use_kernel=True: the port's SSD wrapper takes its plain version on
    CPU tensors; JAX runs its Pallas kernel in interpret mode."""
    cfg, jcfg = ssm_cfgs(arch)
    tree = shared_params(arch, seed=4)
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(B, S_SSM)).astype(np.int32)
    jl, jcache = JM.prefill(to_jax(tree), jcfg, {"tokens": prompt},
                            use_kernel=True)
    with torch.inference_mode():
        tl, tcache = TM.prefill(params_from_numpy(tree, "cpu"), cfg,
                                {"tokens": torch.from_numpy(prompt)},
                                use_kernel=True)
    close(tl, jl)
    _close_caches(tcache, jcache, S_SSM)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_continues_prefill(arch):
    """Decoding the prompt token by token from an empty cache gives the
    prefill's last logits: the recurrence against the chunked scan."""
    cfg, _ = ssm_cfgs(arch)
    tp = params_from_numpy(shared_params(arch), "cpu")
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(B, S_SSM)).astype(np.int32))
    with torch.inference_mode():
        want, pcache = TM.prefill(tp, cfg, {"tokens": prompt})
        cache = TM.init_cache(cfg, B, S_SSM, device="cpu")
        for i in range(S_SSM):
            got, cache = TM.decode_step(tp, cfg, cache, prompt[:, i:i + 1], i)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(cache["ssm"]["state"], pcache["ssm"]["state"],
                               **TOL)
    torch.testing.assert_close(cache["ssm"]["conv"], pcache["ssm"]["conv"],
                               **TOL)


def test_hybrid_cache_has_one_kv_per_shared_call():
    cfg, jcfg = ssm_cfgs("zamba2_2_7b")
    tc = TM.init_cache(cfg, B, 20, device="cpu")
    jc = JM.init_cache(jcfg, B, 20)
    assert tc["kv"]["k"].shape == jc["kv"]["k"].shape == \
        (cfg.num_layers // cfg.shared_attn_period, B, 20,
         cfg.num_kv_heads, cfg.resolved_head_dim)
    assert {k: tuple(v.shape) for k, v in tc["ssm"].items()} == \
        {k: tuple(v.shape) for k, v in jc["ssm"].items()}
    with pytest.raises(ValueError, match="shared_attn_period"):
        TM.init_params(dataclasses.replace(cfg, shared_attn_period=3),
                       device="cpu")


# ---------------------------------------------------------------------------
# encdec (whisper): the encoder, mixed dtypes, the cross cache
# ---------------------------------------------------------------------------


def test_whisper_encode_kernel_route_matches_jax_kernel():
    """encode(use_kernel=True): JAX runs its Pallas flash kernel in
    interpret mode (the encoder passes no traced window, so it can); the
    port's wrapper takes its plain version on CPU tensors."""
    arch = "whisper_large_v3"
    cfg = get_smoke_config(arch)
    tree = shared_params(arch, seed=8)
    frames = np.random.default_rng(9).standard_normal(
        (B, 10, cfg.d_model)).astype(np.float32)
    want = JM.encode(to_jax(tree), jax_smoke(arch), jnp.asarray(frames),
                     use_kernel=True)
    with torch.inference_mode():
        got = TM.encode(params_from_numpy(tree, "cpu"), cfg,
                        torch.from_numpy(frames), use_kernel=True)
    close(got, want)


def test_whisper_bf16_keeps_the_f32_frames_in_the_encoder():
    """bf16 weights, f32 frames (as the serve makes them): JAX promotes, so
    the encoder output is f32 on both sides, and the bf16 decoder's
    logits (prefill and 3 decode steps) agree with JAX's within 2e-2 of
    their range."""
    arch = "whisper_large_v3"
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke(arch), dtype="bfloat16")
    tree = shared_params(arch, jcfg=jcfg)
    jp, tp = to_jax(tree), params_from_numpy(tree, "cpu")
    assert tp["embed"].dtype == torch.bfloat16
    toks = tokens(cfg)
    batch = batch_of(cfg, toks[:, :S])
    jenc = JM.encode(jp, jcfg, jnp.asarray(batch["frames"]))
    with torch.inference_mode():
        tenc = TM.encode(tp, cfg, torch.from_numpy(batch["frames"]))
    assert jenc.dtype == jnp.float32 and tenc.dtype == torch.float32

    def within(got, want):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())
    within(tenc, jenc)
    jl, jcache = JM.prefill(jp, jcfg, jax.tree.map(jnp.asarray, batch))
    with torch.inference_mode():
        tl, tcache = TM.prefill(tp, cfg, torch_batch(batch),
                                max_seq=S + STEPS)
    within(tl, jl)
    assert tcache["cross_k"].dtype == torch.bfloat16
    grown = grow(jcache, jcfg, S + STEPS)
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        jl, grown = JM.decode_step(jp, jcfg, grown, tok, jnp.int32(S + i))
        with torch.inference_mode():
            tl, tcache = TM.decode_step(tp, cfg, tcache,
                                        torch.from_numpy(tok), S + i)
        within(tl, jl)


def test_whisper_cross_cache_rows_follow_max_seq():
    """The cross cache has max(max_seq // encoder_ratio, 1) rows, as JAX's
    init_cache; a prefill leaves the rows past the frames zero."""
    cfg = get_smoke_config("whisper_large_v3")
    for max_seq in (1, 3, 15, 22):
        tc = TM.init_cache(cfg, B, max_seq, device="cpu")
        jc = JM.init_cache(jax_smoke("whisper_large_v3"), B, max_seq)
        for name in ("cross_k", "cross_v"):
            assert tuple(tc[name].shape) == jc[name].shape
    tp = params_from_numpy(shared_params("whisper_large_v3"), "cpu")
    batch = torch_batch(batch_of(cfg, tokens(cfg)[:, :S]))
    with torch.inference_mode():
        _, cache = TM.prefill(tp, cfg, batch, max_seq=30)
        assert cache["cross_k"].shape[2] == 7
        assert cache["cross_k"][:, :, :3].abs().sum() > 0
        assert not cache["cross_k"][:, :, 3:].any()
        with pytest.raises(ValueError, match="cross cache"):
            TM.prefill(tp, cfg, {**batch, "frames": torch.zeros(
                B, 8, cfg.d_model)}, max_seq=S)
