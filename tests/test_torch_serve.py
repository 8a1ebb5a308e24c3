"""Port parity: the serve driver through the port's own engine copy.

``repro_torch.launch.serve.run_serving(device="cpu", params=bridged)`` on
the codeqwen smoke config must give exactly the greedy tokens of the JAX
prefill/decode steps, run the way ``repro/launch/serve.py`` runs them
(same ``default_rng(0)`` prompts, cache padded out for decode), on both
execution substrates, streaming and through the session manager.  The
mamba2 and zamba2 smoke configs (``ssm_chunk=8``, so 16-token prompts span
two chunks) must do the same on both substrates, and so must the
granite-moe (moe) and whisper (encdec, f32 zero frames; the decode attends
over the cross cache's zero rows past the frames, as the reference's
padded cache makes it) smoke configs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve as torch_serve  # noqa: E402

ARCH = "codeqwen15_7b"
SSM_ARCHS = ["mamba2_1_3b", "zamba2_2_7b"]
MOE_ENCDEC_ARCHS = ["granite_moe_3b_a800m", "whisper_large_v3"]
SHAPE = dict(num_requests=4, microbatch=2, prompt_len=16, decode_steps=6)
_FILLED = ("bq", "bk", "bv", "bo", "conv_b", "A_log", "D", "dt_bias")


def _seeded_tree(cfg, seed):
    """The JAX init as numpy, with norms, biases and Mamba2's constant
    leaves seeded (the JAX init sets them to constants)."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(cfg,
                                                   jax.random.PRNGKey(0)))

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif "norm" in k or k in _FILLED:
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    fill(tree)
    return tree


@pytest.fixture(scope="module")
def shared():
    """Numpy params (norms and biases seeded, the JAX init zeroes them)
    and the JAX greedy tokens for them."""
    cfg = jax_smoke(ARCH)
    tree = _seeded_tree(cfg, 5)
    return tree, _jax_tokens(cfg, jax.tree.map(jnp.asarray, tree), **SHAPE)


@pytest.fixture(scope="module", params=SSM_ARCHS)
def ssm_shared(request):
    """(port config, numpy params, JAX greedy tokens) of an ssm or hybrid
    smoke config with ``ssm_chunk=8`` on both sides."""
    cfg = dataclasses.replace(get_smoke_config(request.param), ssm_chunk=8)
    jcfg = dataclasses.replace(jax_smoke(request.param), ssm_chunk=8)
    tree = _seeded_tree(jcfg, 7)
    return cfg, tree, _jax_tokens(jcfg, jax.tree.map(jnp.asarray, tree),
                                  **SHAPE)


@pytest.fixture(scope="module", params=MOE_ENCDEC_ARCHS)
def moe_encdec_shared(request):
    """(port config, numpy params, JAX greedy tokens) of the granite-moe or
    whisper smoke config."""
    jcfg = jax_smoke(request.param)
    tree = _seeded_tree(jcfg, 9)
    return (get_smoke_config(request.param), tree,
            _jax_tokens(jcfg, jax.tree.map(jnp.asarray, tree), **SHAPE))


def _jax_tokens(cfg, params, *, num_requests, microbatch, prompt_len,
                decode_steps):
    """``repro/launch/serve.py``'s prefill and decode apps, inline."""
    prefill_step = jax.jit(make_prefill_step(cfg))
    decode_one = jax.jit(make_decode_step(cfg))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(num_requests, prompt_len)).astype(np.int32)
    max_seq = prompt_len + decode_steps
    rows = []
    for mb in range(num_requests // microbatch):
        chunk = jnp.asarray(prompts[mb * microbatch:(mb + 1) * microbatch])
        batch = {"tokens": chunk}
        if cfg.family == "encdec":
            batch["frames"] = jnp.zeros(
                (microbatch, max(prompt_len // cfg.encoder_ratio, 1),
                 cfg.d_model), jnp.float32)
        next_tok, cache = prefill_step(params, batch)
        grown = JM.init_cache(cfg, microbatch, max_seq)
        cache = jax.tree.map(
            lambda dst, src: jnp.pad(
                src, [(0, d - s) for d, s in zip(dst.shape, src.shape)]
            ).astype(dst.dtype), grown, cache)
        tok = next_tok[:, None]
        toks = [tok]
        for i in range(decode_steps - 1):
            tok, cache = decode_one(params, cache, tok,
                                    jnp.int32(prompt_len + i))
            toks.append(tok)
        rows.append(np.asarray(jnp.concatenate(toks, axis=1)))
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("execution,streaming,sessions", [
    ("objects", False, 1),
    ("compiled", False, 1),
    ("objects", True, 1),
    ("compiled", True, 1),
    ("compiled", False, 2),
])
def test_serve_tokens_match_jax(shared, execution, streaming, sessions):
    tree, want = shared
    res = torch_serve.run_serving(
        get_smoke_config(ARCH), device="cpu",
        params=params_from_numpy(tree, "cpu"), execution=execution,
        streaming=streaming, sessions=sessions, **SHAPE)
    assert res["responses_shape"] == want.shape
    np.testing.assert_array_equal(res["responses"], want)
    assert res["gen_tokens_per_s"] > 0
    if sessions > 1:
        assert res["template_hits"] == sessions - 1


def test_serve_kernel_route_on_cpu_tokens_match(shared, monkeypatch):
    """The prefill step's kernel route (its plain version on the CPU)
    serves the same tokens."""
    from repro_torch.launch import serve as mod
    from repro_torch.train import steps
    tree, want = shared
    real = steps.make_prefill_step
    monkeypatch.setattr(mod, "make_prefill_step",
                        lambda cfg, **kw: real(cfg, use_kernel=True, **kw))
    res = mod.run_serving(get_smoke_config(ARCH), device="cpu",
                          params=params_from_numpy(tree, "cpu"), **SHAPE)
    np.testing.assert_array_equal(res["responses"], want)


def test_jax_serve_gives_the_same_shape():
    res = jax_serve.run_serving(jax_smoke(ARCH), **SHAPE)
    port = torch_serve.run_serving(get_smoke_config(ARCH), device="cpu",
                                   **SHAPE)
    assert port["responses_shape"] == res["responses_shape"] == \
        (SHAPE["num_requests"], SHAPE["decode_steps"])
    tok = port["responses"]
    assert tok.min() >= 0 and tok.max() < get_smoke_config(ARCH).vocab_size


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_serve.run_serving(get_smoke_config(ARCH), **SHAPE)


def test_uneven_microbatch_raises():
    with pytest.raises(ValueError, match="multiple"):
        torch_serve.run_serving(get_smoke_config(ARCH), device="cpu",
                                num_requests=5, microbatch=2)


def test_decode_fn_matches_jax(shared):
    """The host-side greedy loop of the serve steps, against JAX's."""
    from repro.train import decode_fn as jax_decode_fn
    from repro_torch.models import model as TM
    from repro_torch.train import decode_fn
    tree, _ = shared
    cfg = get_smoke_config(ARCH)
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    _, jcache = JM.prefill(jp, jax_smoke(ARCH), {"tokens": prompt})
    jcache = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, 5), (0, 0), (0, 0)]),
        jcache)
    first = prompt[:, -1:]
    want, _ = jax_decode_fn(jax_smoke(ARCH), jp, jcache, jnp.asarray(first),
                            10, 5)
    tp = params_from_numpy(tree, "cpu")
    with torch.inference_mode():
        _, cache = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                              max_seq=15)
    got, _ = decode_fn(cfg, tp, cache, torch.from_numpy(first), 10, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("execution", ["objects", "compiled"])
def test_ssm_serve_tokens_match_jax(ssm_shared, execution):
    cfg, tree, want = ssm_shared
    res = torch_serve.run_serving(cfg, device="cpu",
                                  params=params_from_numpy(tree, "cpu"),
                                  execution=execution, **SHAPE)
    assert res["responses_shape"] == want.shape
    np.testing.assert_array_equal(res["responses"], want)


def test_ssm_serve_kernel_route_on_cpu_tokens_match(ssm_shared, monkeypatch):
    """The prefill step's kernel route (the SSD and flash wrappers' plain
    versions on the CPU) serves the same tokens."""
    from repro_torch.launch import serve as mod
    from repro_torch.train import steps
    cfg, tree, want = ssm_shared
    real = steps.make_prefill_step
    monkeypatch.setattr(mod, "make_prefill_step",
                        lambda c, **kw: real(c, use_kernel=True, **kw))
    res = mod.run_serving(cfg, device="cpu",
                          params=params_from_numpy(tree, "cpu"), **SHAPE)
    np.testing.assert_array_equal(res["responses"], want)


@pytest.mark.parametrize("execution", ["objects", "compiled"])
def test_moe_encdec_serve_tokens_match_jax(moe_encdec_shared, execution):
    cfg, tree, want = moe_encdec_shared
    res = torch_serve.run_serving(cfg, device="cpu",
                                  params=params_from_numpy(tree, "cpu"),
                                  execution=execution, **SHAPE)
    assert res["responses_shape"] == want.shape
    np.testing.assert_array_equal(res["responses"], want)


def test_moe_encdec_serve_kernel_route_on_cpu_tokens_match(
        moe_encdec_shared, monkeypatch):
    """The prefill step's kernel route (the flash wrapper's plain version
    on the CPU, the whisper encoder's included) serves the same tokens."""
    from repro_torch.launch import serve as mod
    from repro_torch.train import steps
    cfg, tree, want = moe_encdec_shared
    real = steps.make_prefill_step
    monkeypatch.setattr(mod, "make_prefill_step",
                        lambda c, **kw: real(c, use_kernel=True, **kw))
    res = mod.run_serving(cfg, device="cpu",
                          params=params_from_numpy(tree, "cpu"), **SHAPE)
    np.testing.assert_array_equal(res["responses"], want)


def test_served_model_is_not_kept_alive():
    """The serve apps stay in the engine's registry after ``run_serving``
    returns; they must not keep its weights alive (a card serving one model
    after another would hold both)."""
    import gc
    import weakref

    from repro_torch.models import model as TM
    cfg = get_smoke_config(ARCH)
    params = TM.init_params(cfg, device="cpu")
    alive = weakref.ref(params["embed"])
    torch_serve.run_serving(cfg, device="cpu", params=params,
                            num_requests=2, microbatch=1, prompt_len=4,
                            decode_steps=2)
    del params
    gc.collect()
    assert alive() is None
