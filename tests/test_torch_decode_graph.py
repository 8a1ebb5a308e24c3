"""The decode step with its position on the device (the port's counterpart
of the reference's jitted decode step, whose ``pos`` is a traced array).

On CUDA the port captures the decode step once per cache as a CUDA graph
and replays it (``repro_torch.train.steps.DecodeGraph``); a capture needs
the card, so here on the CPU:

* the step with ``pos`` a 0-d int64 tensor gives the int path's logits
  and cache to the bit, and the greedy tokens of JAX's
  ``jax.jit(make_decode_step(cfg))``, for the smoke config of every family
  (gemma2 decoding past its local window) and in bf16 for the SSM state's
  promotion;
* trace-once / replay, the CPU stand-in for capture: the step traced by
  ``make_fx`` at one position, run at three later positions, equals the
  eager step at each to the bit, so no position is baked into the trace;
* ``make_decode_step(graph=True)`` raises for CPU tensors, and the
  default (``graph=None``) runs eagerly on the CPU: ``decode_fn`` gives
  JAX's ``decode_fn`` tokens for every family.

Weights are the JAX init bridged as numpy, with norms, biases and
Mamba2's constant leaves seeded.  Tokens are compared exactly, as in
``tests/test_torch_serve.py``; KV caches against JAX's at 1e-4 (f32, as in
``tests/test_torch_model.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.fx.experimental.proxy_tensor import make_fx  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import make_decode_step as jax_decode_step  # noqa: E402
from repro.train import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import decode_fn, make_decode_step  # noqa: E402

B, STEPS = 2, 4
TOL = dict(atol=1e-4, rtol=1e-4)
_FILLED = ("bq", "bk", "bv", "bo", "conv_b", "A_log", "D", "dt_bias")
# (family, arch, prompt length, config overrides): ssm_chunk=8 makes the
# 16-token prompts span two SSD chunks; gemma2's smoke window is 32, so a
# 40-token prompt decodes past it
CASES = {
    "dense": ("codeqwen15_7b", 16, {}),
    "vlm": ("chameleon_34b", 16, {}),
    "moe": ("granite_moe_3b_a800m", 16, {}),
    "ssm": ("mamba2_1_3b", 16, {"ssm_chunk": 8}),
    "hybrid": ("zamba2_2_7b", 16, {"ssm_chunk": 8}),
    "encdec": ("whisper_large_v3", 16, {}),
    "window": ("gemma2_27b", 40, {}),
}


def _configs(arch, **kw):
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


def _seeded_tree(jcfg, seed=11):
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))

    def fill(node):
        for k, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif "norm" in k or k in _FILLED:
                node[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
    fill(tree)
    return tree


def _batch(cfg, s, seed=3):
    """Numpy prompts (B, s) and, for encdec, seeded f32 frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(B, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, max(s // cfg.encoder_ratio, 1), cfg.d_model)
        ).astype(np.float32)
    return batch


def _clone(cache):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in cache.items()}


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _bitwise(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One family's run: port config, bridged params, the port's prefill
    (next token, cache at prompt + STEPS), and JAX's greedy tokens (its
    jitted prefill, the cache grown by padding as the reference's serve
    grows it, then STEPS jitted decode steps) with JAX's last cache."""
    arch, s, kw = CASES[request.param]
    cfg, jcfg = _configs(arch, **kw)
    tree = _seeded_tree(jcfg)
    batch = _batch(cfg, s)
    jp = jax.tree.map(jnp.asarray, tree)
    first, jcache = jax.jit(jax_prefill_step(jcfg))(jp, batch)
    jcache = jax.tree.map(
        lambda dst, src: jnp.pad(
            src, [(0, d - n) for d, n in zip(dst.shape, src.shape)]
        ).astype(dst.dtype), JM.init_cache(jcfg, B, s + STEPS), jcache)
    step = jax.jit(jax_decode_step(jcfg))
    tok = first[:, None]
    toks = [np.asarray(tok)]
    for i in range(STEPS):
        tok, jcache = step(jp, jcache, tok, jnp.int32(s + i))
        toks.append(np.asarray(tok))

    tp = params_from_numpy(tree, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        logits, cache = TM.prefill(tp, cfg, tb, max_seq=s + STEPS)
    tfirst = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)
    return dict(cfg=cfg, params=tp, s=s, first=tfirst.to(torch.int32)[:, None],
                cache=cache, jax_tokens=np.concatenate(toks, axis=1),
                jax_cache=jcache)


def test_tensor_position_is_the_int_path_and_jax(case):
    """Eager steps with ``pos`` a 0-d int64 tensor against the same steps
    with an int: logits, tokens and caches to the bit at every step; the
    tokens equal JAX's jitted decode step's, the KV caches JAX's within
    1e-4."""
    cfg, params, s = case["cfg"], case["params"], case["s"]
    by_int, by_tensor = (make_decode_step(cfg, graph=False),
                         make_decode_step(cfg, graph=False))
    c_int, c_tensor = _clone(case["cache"]), _clone(case["cache"])
    t_int = t_tensor = case["first"]
    toks = [t_tensor]
    for i in range(STEPS):
        t_int, c_int = by_int(params, c_int, t_int, s + i)
        t_tensor, c_tensor = by_tensor(params, c_tensor, t_tensor,
                                       torch.tensor(s + i))
        assert torch.equal(by_int.logits, by_tensor.logits)
        assert torch.equal(t_int, t_tensor)
        toks.append(t_tensor)
    _bitwise(c_int, c_tensor)
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(),
                                  case["jax_tokens"])
    for name in ("k", "v"):
        if "kv" in c_tensor:
            np.testing.assert_allclose(
                c_tensor["kv"][name].numpy(),
                np.asarray(case["jax_cache"]["kv"][name]), **TOL)


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_2_7b"])
def test_tensor_position_is_the_int_path_in_bf16(arch):
    """bf16, where the first decode step promotes the SSM state to f32 (a
    new tensor: the eager step before a capture makes it): the tensor
    position's logits and caches equal the int path's to the bit."""
    cfg, jcfg = _configs(arch, ssm_chunk=8, dtype="bfloat16")
    params = params_from_numpy(_seeded_tree(jcfg), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(cfg, 16).items()}
    with torch.inference_mode():
        _, cache = TM.prefill(params, cfg, tb, max_seq=16 + STEPS)
    assert cache["ssm"]["state"].dtype == torch.bfloat16
    c_int, c_tensor = _clone(cache), _clone(cache)
    tok = tb["tokens"][:, -1:]
    with torch.inference_mode():
        for i in range(STEPS):
            l_int, c_int = TM.decode_step(params, cfg, c_int, tok, 16 + i)
            l_tensor, c_tensor = TM.decode_step(params, cfg, c_tensor, tok,
                                                torch.tensor(16 + i))
            assert torch.equal(l_int, l_tensor)
            tok = torch.argmax(l_int[:, -1, :cfg.vocab_size], -1)[:, None]
    assert c_tensor["ssm"]["state"].dtype == torch.float32
    _bitwise(c_int, c_tensor)


def test_traced_step_replays_at_later_positions(case):
    """The CPU stand-in for a capture: ``make_fx`` traces the eager step
    once, at position s (on a scratch copy of the cache); the traced graph
    then runs at s+1, s+2 and s+3 on one copy of the cache and the eager
    step on another.  Tokens, logits and caches agree to the bit at each:
    the position is read from its tensor, not baked into the trace."""
    cfg, params, s = case["cfg"], case["params"], case["s"]
    step = make_decode_step(cfg, graph=False)

    def one(p, cache, tokens, pos):
        tok, _ = step(p, cache, tokens, pos)
        return tok, step.logits

    traced = make_fx(one)(params, _clone(case["cache"]), case["first"],
                          torch.tensor(s))
    c_eager, c_traced = _clone(case["cache"]), _clone(case["cache"])
    tok, _ = step(params, c_eager, case["first"], s)
    step(params, c_traced, case["first"], s)
    for i in range(1, STEPS):
        want, want_logits = one(params, c_eager, tok, torch.tensor(s + i))
        got, got_logits = traced(params, c_traced, tok, torch.tensor(s + i))
        assert torch.equal(got, want) and torch.equal(got_logits, want_logits)
        _bitwise(c_traced, c_eager)
        tok = want


def test_decode_fn_matches_jax(case):
    """``decode_fn`` on the CPU (``make_decode_step``'s default: eager
    there) gives JAX's ``decode_fn`` tokens, for every family."""
    cfg, s = case["cfg"], case["s"]
    got, _ = decode_fn(cfg, case["params"], _clone(case["cache"]),
                       case["first"], s, STEPS)
    np.testing.assert_array_equal(got.numpy(), case["jax_tokens"])


def test_graph_on_cpu_raises_and_default_is_eager():
    """``graph=True`` refuses CPU tensors (it never runs eagerly instead);
    the default runs eagerly on the CPU and captures nothing."""
    cfg = get_smoke_config("codeqwen15_7b")
    params = TM.init_params(cfg, device="cpu")
    cache = TM.init_cache(cfg, B, 8, device="cpu")
    tok = torch.zeros((B, 1), dtype=torch.int32)
    for pos in (0, torch.tensor(0)):
        with pytest.raises(ValueError, match="graph=True"):
            make_decode_step(cfg, graph=True)(params, cache, tok, pos)
    step = make_decode_step(cfg)
    got, _ = step(params, cache, tok, 1)
    assert step.graph is None and got.shape == (B, 1)
    assert step.logits.shape == (B, 1, cfg.padded_vocab)
