"""Port parity: the dense and vlm model families against the JAX model.

Weights come from the JAX init, bridged as numpy.  The JAX init sets every
norm scale and bias to zero, so the shared numpy tree first gets seeded
values there; otherwise those terms would go untested.  f32 smoke configs,
atol/rtol 1e-4: both sides run the same f32 math, in another summation
order (XLA vs ATen) over 2 layers.
"""
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
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, STEPS = 2, 12, 3
_FILLED = ("attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm",
           "bq", "bk", "bv", "bo")


def shared_params(arch, seed=0):
    """JAX init as a numpy tree, norms and biases filled from ``seed``."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(jax_smoke(arch),
                                                   jax.random.PRNGKey(0)))

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


def close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    cfg = get_smoke_config(arch)
    tree = shared_params(arch)
    jp, tp = to_jax(tree), params_from_numpy(tree, "cpu")
    toks = tokens(cfg)
    prompt = toks[:, :S]

    jl, jcache = jax.jit(lambda p, t: JM.prefill(p, jax_smoke(arch),
                                                 {"tokens": t}))(jp, prompt)
    with torch.inference_mode():
        tl, tcache = TM.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                                max_seq=S + STEPS)
    close(tl, jl)
    for name in ("k", "v"):
        close(tcache["kv"][name][:, :, :S], jcache["kv"][name])
        assert not tcache["kv"][name][:, :, S:].any()

    # JAX grows its cache by padding; the port preallocated max_seq
    grown = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, STEPS), (0, 0), (0, 0)]),
        jcache)
    jstep = jax.jit(lambda p, c, t, pos: JM.decode_step(p, jax_smoke(arch),
                                                        c, t, pos))
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        jl, grown = jstep(jp, grown, tok, jnp.int32(S + i))
        with torch.inference_mode():
            tl, tcache = TM.decode_step(tp, cfg, tcache,
                                        torch.from_numpy(tok), S + i)
        close(tl, jl)
    for name in ("k", "v"):
        close(tcache["kv"][name], grown["kv"][name])


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "gemma2_27b"])
def test_forward_train_matches_jax(arch):
    cfg = get_smoke_config(arch)
    tree = shared_params(arch, seed=2)
    toks = tokens(cfg, seed=3)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    jloss, jparts = JM.forward_train(
        to_jax(tree), jax_smoke(arch),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    with torch.inference_mode():
        tloss, tparts = TM.forward_train(
            params_from_numpy(tree, "cpu"), cfg,
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})
    close(tloss, jloss)
    close(tparts["loss"], jparts["loss"])


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "gemma2_27b"])
def test_kernel_route_on_cpu_matches_plain(arch):
    """use_kernel=True on CPU tensors takes the kernel's plain version."""
    cfg = get_smoke_config(arch)
    tp = params_from_numpy(shared_params(arch), "cpu")
    prompt = torch.from_numpy(tokens(cfg)[:, :S])
    with torch.inference_mode():
        lk, ck = TM.prefill(tp, cfg, {"tokens": prompt}, use_kernel=True)
        lp, cp = TM.prefill(tp, cfg, {"tokens": prompt}, use_kernel=False)
    torch.testing.assert_close(lk, lp, **TOL)
    torch.testing.assert_close(ck["kv"]["k"], cp["kv"]["k"])


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


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_2_7b",
                                  "granite_moe_3b_a800m", "whisper_large_v3"])
def test_later_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.init_params(get_smoke_config(arch), device="cpu")


def test_layer_windows_match_jax():
    for arch in ARCHS:
        want = JM.layer_windows(jax_smoke(arch), S)
        got = TM.layer_windows(get_smoke_config(arch))
        if want is None:
            assert got == [0] * len(got)
        else:
            assert got == [int(w) for w in want]
