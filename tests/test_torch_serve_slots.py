"""The serve driver's cache slots (``repro_torch.launch.serve.SlotPool``).

``run_serving`` takes a slot (a cache at ``max_seq`` with the prefill and
decode steps whose graphs belong to it) for each microbatch and gives it
back when the microbatch's decode ends, so later microbatches and sessions
reuse the caches and, on the card, replay the graphs captured on them.  On
the CPU the steps run eagerly through the same pool.  Held here:

* the pool: acquire, release, growth to the most slots taken at once, reuse
  by key, from two threads at once, and ``close``;
* ``run_serving`` with 3 microbatches a session and 2 sessions, one after
  the other and 2 at a time, gives the greedy tokens of the reference's
  jitted prefill and decode steps (run as ``repro/launch/serve.py`` runs
  them) for the dense, ssm (``ssm_chunk=8``), hybrid, moe and encdec smoke
  configs; so does the same run with every step through the graph route on
  stand-ins for a CUDA graph (the capture records the call, a replay runs
  it again into the static outputs), which captures each slot's graphs
  once, as ``chip_smoke.serve_runs`` counts them;
* a reused cache gives a fresh zeroed cache's bits: a prefill into a cache
  full of other values (rows past the prompt, the conv window before a
  prompt shorter than it, whisper's cross rows past the frames) leaves
  every tensor as a prefill into a new cache does; in bf16 the SSM state
  keeps the model's dtype in the slot, so the first decode step after a
  prefill into a slot whose last microbatch left an f32 state rounds its
  update as the reference does;
* a decode step takes the cache the last one returned: given a bf16 SSM
  prefill's cache again, it runs the first step again;
* ``make_prefill_step(graph=True)`` raises on the CPU and without a cache;
  without one the default prefill is eager.
"""
import dataclasses
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train import make_decode_step as jax_decode_step  # noqa: E402
from repro.train import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import (CacheSlot, SlotPool,  # noqa: E402
                                      prompt_batch, run_serving)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from repro_torch.train import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"codeqwen15_7b": {}, "mamba2_1_3b": {"ssm_chunk": 8},
         "zamba2_2_7b": {"ssm_chunk": 8}, "granite_moe_3b_a800m": {},
         "whisper_large_v3": {}}
SHAPE = dict(num_requests=6, microbatch=2, prompt_len=16, decode_steps=5)
_FILLED = ("bq", "bk", "bv", "bo", "conv_b", "A_log", "D", "dt_bias")


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


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


def _configs(arch, **kw):
    return (dataclasses.replace(get_smoke_config(arch), **kw),
            dataclasses.replace(jax_smoke(arch), **kw))


def _jax_tokens(cfg, params, *, num_requests, microbatch, prompt_len,
                decode_steps):
    """``repro/launch/serve.py``'s prefill and decode apps, inline: the
    jitted steps, the prefill's cache padded out to ``max_seq``."""
    prefill_step = jax.jit(jax_prefill_step(cfg))
    decode_one = jax.jit(jax_decode_step(cfg))
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


@pytest.fixture(scope="module", params=sorted(ARCHS))
def family(request):
    """(port config, numpy params, JAX greedy tokens at ``SHAPE``)."""
    cfg, jcfg = _configs(request.param, **ARCHS[request.param])
    tree = _seeded_tree(jcfg, 11)
    return cfg, tree, _jax_tokens(jcfg, jax.tree.map(jnp.asarray, tree),
                                  **SHAPE)


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------


class _Step:
    def __init__(self):
        self.closed = 0

    def close(self):
        self.closed += 1


def _slot(key):
    return CacheSlot(key, {"kv": torch.zeros(1)}, _Step(), _Step())


def test_pool_grows_to_the_slots_taken_at_once_and_reuses_by_key():
    pool = SlotPool()
    start = threading.Barrier(2)
    taken, made = [], []

    def make(key):
        slot = _slot(key)
        made.append(slot)
        return slot

    def take():
        start.wait()
        taken.append(pool.acquire("a", lambda: make("a")))

    threads = [threading.Thread(target=take) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # two at once: two slots, never the same one
    assert pool.made == 2 and len({id(s) for s in taken}) == 2
    for slot in taken:
        pool.release(slot)
    again = pool.acquire("a", lambda: make("a"))
    assert pool.made == 2 and any(again is s for s in taken)
    other = pool.acquire("b", lambda: make("b"))
    assert pool.made == 3 and other.key == "b"
    pool.release(other)
    assert pool.acquire("b", lambda: make("b")) is other
    # close frees every slot, the ones still taken too
    pool.close()
    assert pool.made == 0
    assert all(s.cache is None and s.prefill.closed == 1
               and s.decode.closed == 1 for s in made)


def test_pool_release_and_acquire_from_two_threads():
    """Two threads taking and giving back slots of one key many times:
    no slot is ever held by both, and the pool never holds more slots than
    were taken at once."""
    pool = SlotPool()
    held, errors = set(), []
    lock = threading.Lock()

    def work():
        for _ in range(200):
            slot = pool.acquire("k", lambda: _slot("k"))
            with lock:
                if id(slot) in held:
                    errors.append(slot)
                held.add(id(slot))
            with lock:
                held.discard(id(slot))
            pool.release(slot)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and 1 <= pool.made <= 2
    pool.close()


# ---------------------------------------------------------------------------
# run_serving through the slots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_concurrent", [1, 2],
                         ids=["one_after_another", "concurrent"])
def test_sessions_through_slots_match_jax(family, max_concurrent):
    cfg, tree, want = family
    res = run_serving(cfg, device="cpu", params=params_from_numpy(tree, "cpu"),
                      sessions=2, max_concurrent=max_concurrent, **SHAPE)
    np.testing.assert_array_equal(res["responses"], want)
    n_micro = SHAPE["num_requests"] // SHAPE["microbatch"]
    # one after another, the second session takes the first one's slots
    assert 1 <= res["slots"] <= (n_micro if max_concurrent == 1
                                 else 2 * n_micro)
    assert len(res["app_ms"]["prefill"]) == len(res["app_ms"]["decode"]) \
        == 2 * n_micro


class _ReplayedGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: ``replay`` runs
    the captured call again and writes its tensors into those the capture
    returned, as a replay writes its static outputs."""

    def __init__(self):
        self.call = self.out = None

    def replay(self):
        for dst, src in zip(_tensors(self.out), _tensors(self.call())):
            if dst is not src:
                dst.copy_(src)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return leaves(tree)
    return [t for x in tree for t in _tensors(x)]


def _stand_in_capture(graph, dev, fn, *args, pool=None):
    """``train.steps._capture`` on the CPU: the call runs once for its
    outputs, and every tensor it was given is put back as it was (a
    capture records the step without running it)."""
    given = [t for a in args if isinstance(a, (torch.Tensor, dict))
             for t in _tensors(a)]
    kept = [t.clone() for t in given]
    out = fn(*args)
    for t, k in zip(given, kept):
        t.copy_(k)
    graph.call, graph.out = (lambda: fn(*args)), out
    return out, 0.0


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """Every serve step but ``graph=False``'s goes through ``PrefillGraph``
    and ``DecodeGraph``, on ``_ReplayedGraph`` and ``_stand_in_capture``;
    the graphs' counts start at 0."""
    monkeypatch.setattr(TS, "_capture", _stand_in_capture)
    monkeypatch.setattr(TS.torch.cuda, "CUDAGraph", _ReplayedGraph)
    monkeypatch.setattr(TS.GraphPool, "pool", lambda self: None)
    monkeypatch.setattr(TS.GraphPool, "before", lambda self, dev: None)
    monkeypatch.setattr(TS.GraphPool, "after", lambda self, dev: None)
    for cls in (TS.PrefillStep, TS.DecodeStep):
        monkeypatch.setattr(cls, "on_graph",
                            lambda self, tokens: self.use_graph is not False)
    monkeypatch.setattr(TS.PrefillGraph, "counts",
                        {"captures": 0, "replays": 0})
    monkeypatch.setattr(TS.DecodeGraph, "counts",
                        {"captures": 0, "replays": 0})


def _graph_counts():
    return {"prefill": dict(TS.PrefillGraph.counts),
            "decode": dict(TS.DecodeGraph.counts)}


def test_graph_route_through_slots_matches_jax(family, stand_in_graphs):
    """Every prefill and decode step on the graph route (stand-ins): the
    tokens are JAX's, and each slot captured its graphs once, every other
    step replayed one (``chip_smoke.serve_runs``)."""
    cfg, tree, want = family
    res = run_serving(cfg, device="cpu", params=params_from_numpy(tree, "cpu"),
                      sessions=2, max_concurrent=1, **SHAPE)
    np.testing.assert_array_equal(res["responses"], want)
    apps = 2 * SHAPE["num_requests"] // SHAPE["microbatch"]
    runs = _chip_smoke().serve_runs(cfg, apps, SHAPE["decode_steps"],
                                    res["slots"])
    assert _graph_counts() == runs["graphs"]
    assert runs["graphs"]["prefill"]["replays"] >= apps // 2


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_2_7b"])
def test_bf16_ssm_slots_give_the_fresh_route(arch, stand_in_graphs):
    """bf16: the slots' graph route (each slot's first-step graph reads the
    prefill's bf16 state and writes the f32 state of the later steps) gives
    the tokens of the parent's route, every microbatch eager into a fresh
    cache with a decode step of its own; a slot captures three graphs."""
    cfg, jcfg = _configs(arch, ssm_chunk=8, dtype="bfloat16")
    params = params_from_numpy(_seeded_tree(jcfg, 13), "cpu")
    res = run_serving(cfg, device="cpu", params=params, sessions=2,
                      max_concurrent=1, **SHAPE)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(SHAPE["num_requests"],
                                 SHAPE["prompt_len"])).astype(np.int32)
    s, mb = SHAPE["prompt_len"], SHAPE["microbatch"]
    rows = []
    for i in range(0, SHAPE["num_requests"], mb):
        batch = prompt_batch(cfg, torch.from_numpy(prompts[i:i + mb]))
        tok, cache = make_prefill_step(cfg, graph=False)(
            params, batch, s + SHAPE["decode_steps"])
        tok, step, toks = tok[:, None], make_decode_step(cfg, graph=False), []
        toks.append(tok)
        for j in range(SHAPE["decode_steps"] - 1):
            tok, cache = step(params, cache, tok, s + j)
            toks.append(tok)
        rows.append(torch.cat(toks, 1).numpy())
    np.testing.assert_array_equal(res["responses"], np.concatenate(rows))
    assert TS.DecodeGraph.counts["captures"] == 2 * res["slots"]
    assert TS.PrefillGraph.counts["captures"] == res["slots"]


# ---------------------------------------------------------------------------
# A reused cache holds a fresh one's bits
# ---------------------------------------------------------------------------


def _batch(cfg, s, seed):
    return prompt_batch(cfg, torch.from_numpy(
        np.random.default_rng(seed).integers(
            0, cfg.vocab_size, size=(2, s)).astype(np.int32)))


def _bitwise(a, b):
    for x, y in zip(leaves(a), leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


REUSE_CASES = [(a, 16) for a in sorted(ARCHS)] + [
    ("mamba2_1_3b", 2), ("zamba2_2_7b", 2), ("whisper_large_v3", 4)]


@pytest.mark.parametrize("arch,prompt", REUSE_CASES,
                         ids=[f"{a}-s{p}" for a, p in REUSE_CASES])
def test_prefill_into_a_used_cache_gives_a_fresh_caches_bits(arch, prompt):
    """A cache full of other values (every row, the conv window before a
    2-token prompt, whisper's cross rows past the frames) filled by a
    prefill equals a new cache filled by the same prefill, to the bit, and
    serves the same tokens."""
    cfg, jcfg = _configs(arch, **ARCHS[arch])
    params = params_from_numpy(_seeded_tree(jcfg, 17), "cpu")
    batch, max_seq = _batch(cfg, prompt, 3), prompt + 4
    want_tok, want = make_prefill_step(cfg)(params, batch, max_seq)
    cache = TM.init_cache(cfg, 2, max_seq, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for t in leaves(cache):
        t.copy_(torch.randn(t.shape, generator=gen))
    tok, got = make_prefill_step(cfg)(params, batch, cache=cache)
    assert got is cache and torch.equal(tok, want_tok)
    _bitwise(cache, want)
    tokens = {}
    for name, c in (("fresh", want), ("used", cache)):
        step, t, toks = make_decode_step(cfg), tok[:, None], []
        for i in range(3):
            t, c = step(params, c, t, prompt + i)
            toks.append(t)
        tokens[name] = torch.cat(toks, 1)
    assert torch.equal(tokens["fresh"], tokens["used"])


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_2_7b"])
def test_bf16_slot_keeps_the_prefills_state_rounding(arch):
    """bf16: after a microbatch's decode steps (the state in f32 from the
    first on) the slot's cache still holds its bf16 state, so the next
    prefill rounds its state to bf16 and the next first decode step rounds
    its update to it, as in a new cache: logits, tokens and every cache
    tensor equal the fresh route's to the bit."""
    cfg, jcfg = _configs(arch, ssm_chunk=8, dtype="bfloat16")
    params = params_from_numpy(_seeded_tree(jcfg, 19), "cpu")
    s, max_seq = 16, 22
    cache = TM.init_cache(cfg, 2, max_seq, device="cpu")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tok, _ = prefill(params, _batch(cfg, s, 4), cache=cache)
    t, c = tok[:, None], cache
    for i in range(4):
        t, c = decode(params, c, t, s + i)
    assert c is not cache and c["ssm"]["state"].dtype == torch.float32
    assert cache["ssm"]["state"].dtype == torch.bfloat16
    batch = _batch(cfg, s, 5)
    tok, _ = prefill(params, batch, cache=cache)
    want_tok, want = make_prefill_step(cfg)(params, batch, max_seq)
    assert torch.equal(tok, want_tok)
    _bitwise(cache, want)
    first, view = decode(params, cache, tok[:, None], s)
    assert view is c
    fresh = make_decode_step(cfg)
    want_first, want_view = fresh(params, want, want_tok[:, None], s)
    assert torch.equal(first, want_first)
    assert torch.equal(decode.logits, fresh.logits)
    _bitwise(view, want_view)
    # a prefill into the f32 state the decode steps left (the cache the
    # slot would hold had the first step swapped its state in) skips that
    # rounding: its first step's f32 state differs
    wrong = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                 else v.clone()) for k, v in want.items()}
    wrong["ssm"]["state"] = wrong["ssm"]["state"].float()
    with torch.inference_mode():
        TM.prefill(params, cfg, batch, cache=wrong)
        TM.decode_step(params, cfg, wrong, want_tok[:, None], s)
    assert not torch.equal(wrong["ssm"]["state"], want_view["ssm"]["state"])


def test_prefill_graph_on_cpu_raises_and_default_is_eager():
    cfg = get_smoke_config("codeqwen15_7b")
    params = TM.init_params(cfg, device="cpu")
    batch = _batch(cfg, 8, 1)
    cache = TM.init_cache(cfg, 2, 12, device="cpu")
    for kw in ({}, {"cache": cache}):
        with pytest.raises(ValueError, match="graph=True"):
            make_prefill_step(cfg, graph=True)(params, batch, 12, **kw)
    step = make_prefill_step(cfg)
    tok, got = step(params, batch, 12, cache=cache)
    assert step.graph is None and got is cache and tok.shape == (2,)
    assert tok.dtype == torch.int32


@pytest.mark.parametrize("arch", ["mamba2_1_3b", "zamba2_2_7b"])
def test_decode_step_takes_the_cache_it_returned(arch, stand_in_graphs):
    """bf16 SSM: called twice on the prefill's cache, the decode step runs
    its first step twice (the first-step graph replayed, the caller's bf16
    state never written, the same returned cache); called on the cache it
    returned, the later steps' graph, which the first-step graph never
    replays."""
    cfg, jcfg = _configs(arch, ssm_chunk=8, dtype="bfloat16")
    params = params_from_numpy(_seeded_tree(jcfg, 23), "cpu")
    s = 16
    cache = TM.init_cache(cfg, 2, s + 4, device="cpu")
    tok, _ = make_prefill_step(cfg)(params, _batch(cfg, s, 4), cache=cache)
    state = cache["ssm"]["state"].clone()
    decode, t = make_decode_step(cfg), tok[:, None]
    _, first = decode(params, cache, t, s)
    _, again = decode(params, cache, t, s)
    assert again is first and first is not cache
    assert decode.graph is None and decode.first_graph.replays == 1
    assert cache["ssm"]["state"].dtype == torch.bfloat16
    assert torch.equal(cache["ssm"]["state"], state)
    assert first["ssm"]["state"].dtype == torch.float32
    for i in range(2):
        _, out = decode(params, first, t, s + 1 + i)
        assert out is first
    assert decode.graph.replays == 1 and decode.first_graph.replays == 1
    assert TS.DecodeGraph.counts["captures"] == 2


def test_prefill_graph_needs_a_cache(stand_in_graphs):
    """A prefill graph fills a cache of the caller's: ``graph=True``
    without one raises; the default without one runs eagerly and makes a
    cache each call."""
    cfg = get_smoke_config("codeqwen15_7b")
    params = TM.init_params(cfg, device="cpu")
    batch = _batch(cfg, 8, 1)
    with pytest.raises(ValueError, match="pass cache="):
        make_prefill_step(cfg, graph=True)(params, batch, 12)
    step = make_prefill_step(cfg)
    (tok, a), (_, b) = step(params, batch, 12), step(params, batch, 12)
    assert step.graph is None and a is not b
    assert TS.PrefillGraph.counts["captures"] == 0
    cache = TM.init_cache(cfg, 2, 12, device="cpu")
    got_tok, got = step(params, batch, cache=cache)
    assert got is cache and step.graph is not None
    assert torch.equal(got_tok, tok)
    _bitwise(cache, a)


def test_served_pool_is_closed():
    """``run_serving`` frees its slots on the way out: the graphs and
    caches of every slot it made."""
    made = []
    real = serve.SlotPool

    class Watched(real):
        def __init__(self):
            super().__init__()
            made.append(self)

    cfg = get_smoke_config("codeqwen15_7b")
    serve.SlotPool = Watched
    try:
        res = run_serving(cfg, device="cpu", num_requests=4, microbatch=2,
                          prompt_len=4, decode_steps=3)
    finally:
        serve.SlotPool = real
    assert res["slots"] >= 1 and len(made) == 1 and made[0].made == 0
