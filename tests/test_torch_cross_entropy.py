"""The capped cross-entropy: ``kernels/cross_entropy.py``, its plain
version, and ``forward_train`` through the gate's and the loss's autograd
functions.

The CUDA kernels (``csrc/cross_entropy.cu``) run only on the card, where
``chip_smoke.py`` holds them to the plain version.  Here, on the CPU, with
inputs made from a seed with numpy:

(a) the plain loss (``capped_cross_entropy_plain``) and its written-out
    backward (``capped_cross_entropy_bwd_plain``) against the reference's
    ``cross_entropy(softcap(logits, cap))`` and ``jax.grad``: caps 0 and
    30, f32 and bf16 logits (JAX on their f32 upcasts), labels -1, in
    ``[vocab_size, padded)`` and at or past the padded width.  JAX's gather
    fills a label past the width with NaN, so those rows are held to the
    masked mean (JAX with them set to -1).  The loss within 1e-6 relative;
    f32 grads within 1e-6 x max|ref|, bf16 grads within 2^-8 |ref| + 1e-6 x
    max|ref| (one rounding of an f32 grad: half an ulp);
(b) the port's masked mean for labels at or past the padded width (the
    reference's NaN is its fault, ``ROADMAP.md``): the loss is the mean
    over the kept labels and every grad finite, on the plain loss and
    through ``CappedCrossEntropy``;
(c) a numpy emulation of the kernels' forward (a block a row, each
    thread's groups in order with an online maximum, its group sums in f32
    and the groups' in f64, the xor tree and the warps in order; the rows'
    sum in f64 by threads and the labels kept) within 2e-6 relative of the
    plain loss and 1e-6 of an f64 lse, the same with masked labels;
(d) the dispatch and the wrappers' refusals, the shapes on meta;
(e) ``forward_train`` of the dense, moe and vlm smoke configs with the
    gate's and the loss's launches emulated on the CPU by the plain
    versions: the loss and grads of JAX's ``value_and_grad`` within the
    tolerance ``tests/test_torch_norm_rope.py`` holds them to, and the
    launches a train step makes are ``chip_smoke``'s counts;
(f) ``chip_smoke.py``'s expected launches of the gate and the loss a
    phase, its launch window, its profile parts and its parent path.
"""
import re
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import synthetic_batch  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cross_entropy as CE  # noqa: E402
from repro_torch.kernels import gated_mlp as G  # noqa: E402
from repro_torch.launch.train import PRESETS  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import make_train_step, train_state_init  # noqa: E402
from repro_torch.train.steps import _grads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VOCAB, PADDED = 200, 256            # vocab_size and the padded width
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def loss_inputs(seed, dtype, rows=(3, 7), width=PADDED):
    """Logits (rows..., width) and labels with -1, one in [VOCAB, width),
    one at the width and one past it, the rest in [0, VOCAB)."""
    rng = np.random.default_rng(seed)
    logits = 4 * rng.standard_normal((*rows, width)).astype(np.float32)
    labels = rng.integers(0, VOCAB, size=rows)
    flat = labels.reshape(-1)
    flat[[0, 2, 4, 5]] = [-1, VOCAB + 17, width, width + 1000]
    return torch.from_numpy(logits).to(DTYPES[dtype]), torch.from_numpy(labels)


def jax_reference(logits, labels, cap):
    """The reference's loss and its grad of the logits' f32 upcast, the
    labels at or past the width set to -1 (JAX's gather gives NaN there)."""
    x = jnp.asarray(logits.float().numpy())
    lab = labels.numpy().copy()
    lab[lab >= logits.shape[-1]] = -1
    lab = jnp.asarray(lab)
    return jax.value_and_grad(
        lambda z: JC.cross_entropy(JC.softcap(z, cap), lab, VOCAB))(x)


def close_grad(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, dtype=np.float32)
    got_np = got.float().numpy()
    scale = float(np.abs(ref).max())
    tol = 1e-6 * scale + (2.0 ** -8 * np.abs(ref)
                          if got.dtype == torch.bfloat16 else 0.0)
    err = np.abs(got_np - ref)
    assert (err <= tol).all(), float((err - tol).max())


# ---------------------------------------------------------------------------
# (a), (b) the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_plain_and_its_backward_match_jax(cap, dtype):
    logits, labels = loss_inputs(int(cap) + len(dtype), dtype)
    jloss, jgrad = jax_reference(logits, labels, cap)
    loss = CE.capped_cross_entropy_plain(logits, labels, cap, VOCAB)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    grad = CE.capped_cross_entropy_bwd_plain(logits, labels, cap, VOCAB,
                                             torch.tensor(1.0))
    assert grad.dtype == logits.dtype and grad.shape == logits.shape
    close_grad(grad, jgrad)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_written_out_backward_is_autograds(cap, dtype):
    logits, labels = loss_inputs(5, dtype)
    leaf = logits.clone().requires_grad_()
    g = torch.tensor(0.75)
    (CE.capped_cross_entropy_plain(leaf, labels, cap, VOCAB) * g).backward()
    grad = CE.capped_cross_entropy_bwd_plain(logits, labels, cap, VOCAB, g)
    close_grad(grad, leaf.grad.float().numpy())


@pytest.fixture
def emulated(monkeypatch):
    """CPU tensors take ``CappedCrossEntropy`` and ``GatedAct``, whose
    launches run the plain versions here and count themselves by kernel
    and route."""
    counts = {k: {} for k in ("gated_act_fwd", "gated_act_bwd",
                              "cross_entropy_fwd", "cross_entropy_bwd")}
    lock = threading.Lock()

    def count(name, r):
        with lock:
            counts[name][r] = counts[name].get(r, 0) + 1

    def ce_fwd(logits, labels, cap, vocab_size):
        count("cross_entropy_fwd", CE.route(logits.dtype))
        x = TC.softcap(logits.float(), cap)
        labels = labels.long()
        mask = (labels >= 0) & (labels < vocab_size)
        return (CE.capped_cross_entropy_plain(logits, labels, cap,
                                              vocab_size),
                torch.stack([torch.logsumexp(x, -1).reshape(-1),
                             torch.zeros(x[..., 0].numel())], -1),
                mask.sum().clamp_min(1).float())

    def ce_bwd(logits, labels, lse, g, denominator, cap, vocab_size):
        count("cross_entropy_bwd", CE.route(logits.dtype))
        return CE.capped_cross_entropy_bwd_plain(logits, labels, cap,
                                                 vocab_size, g)

    def g_fwd(a, b, activation):
        count("gated_act_fwd", G.route(activation, a.dtype))
        return G.gated_act_plain(a, b, activation)

    def g_bwd(a, b, dy, activation):
        count("gated_act_bwd", G.route(activation, a.dtype))
        return G.gated_act_bwd_plain(a, b, dy, activation)

    def on_cpu(ts, what=""):
        return all(t.device.type == "cpu" for t in ts)
    monkeypatch.setattr(G, "takes_kernel", on_cpu)
    monkeypatch.setattr(CE, "takes_kernel", on_cpu)
    monkeypatch.setattr(CE, "cross_entropy_fwd", ce_fwd)
    monkeypatch.setattr(CE, "cross_entropy_bwd", ce_bwd)
    monkeypatch.setattr(G, "gated_act_fwd", g_fwd)
    monkeypatch.setattr(G, "gated_act_bwd", g_bwd)
    return counts


@pytest.mark.parametrize("through", ["plain", "function"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_labels_past_the_width_are_masked(dtype, through, request):
    """Labels at or past the padded width, and in [vocab_size, padded), add
    nothing: the loss is the mean over the labels kept, every grad finite,
    the masked rows' grads 0."""
    if through == "function":
        request.getfixturevalue("emulated")
    logits, labels = loss_inputs(8, dtype)
    leaf = logits.clone().requires_grad_()
    loss = TC.capped_cross_entropy(leaf, labels, 30.0, VOCAB)
    loss.backward()
    kept = (labels >= 0) & (labels < VOCAB)
    x = TC.softcap(logits.float(), 30.0)
    rows = torch.logsumexp(x, -1) - x.gather(
        -1, labels.clamp(0, PADDED - 1)[..., None])[..., 0]
    want = rows[kept].sum() / kept.sum()
    loss = float(loss.detach())
    assert np.isfinite(loss) and abs(loss - float(want)) <= \
        1e-6 * abs(float(want))
    assert bool(torch.isfinite(leaf.grad).all())
    assert not leaf.grad[~kept].any() and leaf.grad[kept].any()


# ---------------------------------------------------------------------------
# (c) the kernels' order of sums, emulated
# ---------------------------------------------------------------------------


def _row_threads(groups: int) -> int:
    """cross_entropy.cu's row_threads (kItems 8, kMaxThreads 1024)."""
    t = 32
    while t < 1024 and groups > 8 * t:
        t *= 2
    return t


def _merge(m, s, om, os_):
    """cross_entropy.cu's merge of (max, sum) pairs, elementwise."""
    nm = np.maximum(m, om)
    both = (m != -np.inf) & (om != -np.inf)
    rescaled = (s * np.exp(m.astype(np.float64) - nm)
                + os_ * np.exp(om.astype(np.float64) - nm))
    out_s = np.where(both, rescaled, np.where(om == -np.inf, s, os_))
    out_m = np.where(om == -np.inf, m, np.where(m == -np.inf, om, nm))
    return out_m.astype(np.float32), out_s


def emulate_fwd(c: np.ndarray, labels: np.ndarray, vec: int):
    """The forward kernels' lse (rows,) and loss over capped f32 logits c
    (rows, width) in groups of ``vec`` elements."""
    rows, width = c.shape
    groups = width // vec
    t = _row_threads(groups)
    m = np.full((rows, t), -np.inf, np.float32)
    s = np.zeros((rows, t))
    g = c.reshape(rows, groups, vec)
    for start in range(0, groups, t):          # each thread's next group
        block = g[:, start:start + t]          # (rows, threads here, vec)
        n = block.shape[1]
        vm = block.max(-1)
        grow = vm > m[:, :n]
        m_old = m[:, :n]
        s[:, :n] = np.where(grow & (m_old != -np.inf),
                            s[:, :n] * np.exp(m_old - vm).astype(
                                np.float32).astype(np.float64), s[:, :n])
        m[:, :n] = np.where(grow, vm, m_old)
        terms = np.exp(block - m[:, :n, None]).astype(np.float32)
        gs = np.zeros(terms.shape[:2], np.float32)
        for j in range(vec):                   # the group's sum in order
            gs = gs + terms[..., j]
        s[:, :n] += gs.astype(np.float64)
    m, s = m.reshape(rows, t // 32, 32), s.reshape(rows, t // 32, 32)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):                 # each warp's xor tree
        m, s = _merge(m, s, m[..., lane ^ o], s[..., lane ^ o])
    wm, ws = m[..., 0], s[..., 0]
    bm, bs = wm[:, 0], ws[:, 0]
    for w in range(1, t // 32):                # the warps in order
        bm, bs = _merge(bm, bs, wm[:, w], ws[:, w])
    lse = (bm.astype(np.float64) + np.log(bs)).astype(np.float32)
    kept = (labels >= 0) & (labels < VOCAB)
    gold = c[np.arange(rows), np.clip(labels, 0, width - 1)]
    row_loss = np.where(kept, lse - gold, np.float32(0)).astype(np.float32)
    total, count = 0.0, 0
    for th in range(1024):                     # the sum kernel's threads
        total_t = row_loss[th::1024].astype(np.float64).sum()
        total += total_t
        count += int(kept[th::1024].sum())
    return lse, np.float32(total) / np.float32(max(count, 1))


@pytest.mark.parametrize("width,vec", [(PADDED, 8), (PADDED, 4),
                                       (8 * 9000, 8), (1001, 1)])
def test_emulated_kernels_are_the_plain_loss(width, vec):
    logits, labels = loss_inputs(11, "float32", rows=(6,), width=width)
    c = TC.softcap(logits, 30.0)
    lse, loss = emulate_fwd(c.numpy(), labels.numpy(), vec)
    exact = np.log(np.exp(c.numpy().astype(np.float64)).sum(-1))
    np.testing.assert_allclose(lse, exact, rtol=0, atol=1e-6 * np.abs(
        exact).max())
    want = CE.capped_cross_entropy_plain(logits, labels, 30.0, VOCAB)
    np.testing.assert_allclose(loss, float(want), rtol=2e-6)


def test_inv_cap_is_atens_reciprocal():
    assert CE.inv_cap(0.0) == 0.0
    assert CE.inv_cap(30.0) == float(np.float32(1) / np.float32(30))


# ---------------------------------------------------------------------------
# (d) the dispatch and the wrappers
# ---------------------------------------------------------------------------


def _stand_in(device, placements=None):
    return SimpleNamespace(device=torch.device(device),
                           placements=placements)


def test_takes_kernel_by_device():
    cpu = torch.zeros(2)
    assert CE.takes_kernel([cpu, torch.zeros(2, device="meta")]) is False
    assert CE.takes_kernel([_stand_in("cuda"), _stand_in("cuda")]) is True
    with pytest.raises(ValueError, match="cross_entropy kernel for a DTen"):
        CE.takes_kernel([_stand_in("cuda", placements=("Shard(0)",))])
    with pytest.raises(ValueError, match="mix"):
        CE.takes_kernel([cpu, _stand_in("cuda")])


def test_meta_takes_the_plain_ops():
    logits = torch.zeros((2, 3, PADDED), device="meta", dtype=torch.bfloat16)
    labels = torch.zeros((2, 3), device="meta", dtype=torch.int64)
    loss = TC.capped_cross_entropy(logits, labels, 30.0, VOCAB)
    assert loss.shape == () and loss.device.type == "meta"
    assert loss.dtype == torch.float32


def test_launch_functions_refuse_what_the_kernels_do_not_take():
    logits, labels = loss_inputs(0, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        CE.cross_entropy_fwd(logits, labels, 0.0, VOCAB)
    with pytest.raises(ValueError, match="CUDA"):
        CE.cross_entropy_bwd(logits, labels, torch.zeros((21, 2)),
                             torch.tensor(1.0), torch.tensor(1.0), 0.0,
                             VOCAB)
    meta = logits.to("meta")
    with pytest.raises(ValueError, match="labels"):
        CE.cross_entropy_fwd(meta, labels.to("meta")[:, :3], 0.0, VOCAB)
    with pytest.raises(ValueError, match="integers"):
        CE.cross_entropy_fwd(meta, labels.to("meta").float(), 0.0, VOCAB)
    with pytest.raises(ValueError, match="vocab_size"):
        CE.cross_entropy_fwd(meta, labels.to("meta"), 0.0, PADDED + 1)
    with pytest.raises(ValueError, match="float16"):
        CE.cross_entropy_fwd(meta.half(), labels.to("meta"), 0.0, VOCAB)


def test_build_lists_the_source():
    assert "cross_entropy" in _build.KERNEL_SOURCES
    src = (_build.CSRC / "cross_entropy.cu").read_text()
    for name in ("cross_entropy_fwd", "cross_entropy_bwd",
                 "cross_entropy_launches"):
        assert f" {name}(" in src, name


# ---------------------------------------------------------------------------
# (e) forward_train through the functions
# ---------------------------------------------------------------------------


def _loss_and_grads(arch):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = synthetic_batch(5, 0, 0, 2, 16, tcfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.forward_train(p, jcfg, {k: jnp.asarray(v) for k, v
                                             in batch.items()})[0])(jparams)
    tloss, tgrads = _grads(lambda p, mb: TM.forward_train(p, tcfg, mb)[0],
                           tparams, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    return float(jloss), jgrads, float(tloss), tgrads


@pytest.mark.parametrize("through", ["plain", "functions"])
@pytest.mark.parametrize("arch", ["codeqwen15_7b", "granite_moe_3b_a800m",
                                  "chameleon_34b"])
def test_forward_train_matches_jax(arch, through, request):
    """The dense, moe and vlm smoke configs: loss within 1e-5 relative and
    grads within 1e-5 x max|ref| (f32) of JAX's, on the plain ops and
    through ``GatedAct`` and ``CappedCrossEntropy``; through the functions
    the gate launches once a gated call a forward (twice under remat) and
    once a backward, the loss once each."""
    counts = request.getfixturevalue("emulated") if through == "functions" \
        else None
    jloss, jgrads, tloss, tgrads = _loss_and_grads(arch)
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    jl, tl = jax.tree.leaves(jgrads), jax.tree.leaves(tgrads)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        ref = np.asarray(j, dtype=np.float32)
        err = np.abs(t.float().numpy() - ref)
        assert (err <= 1e-5 * np.abs(ref).max()).all()
    if counts is not None:
        cfg = get_smoke_config(arch)
        calls = _chip_smoke().gate_calls(cfg, "forward")
        gr, lr = G.route(cfg.activation, cfg.torch_dtype), CE.route(
            cfg.torch_dtype)
        assert counts == {"gated_act_fwd": {gr: 2 * calls},
                          "gated_act_bwd": {gr: calls},
                          "cross_entropy_fwd": {lr: 1},
                          "cross_entropy_bwd": {lr: 1}}


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("kw", [dict(), dict(num_microbatches=2),
                                dict(remat=False)])
def test_train_step_launches_are_chip_smokes(kw, emulated):
    """One train step of ``tiny`` through the functions launches what
    ``chip_smoke.expected_gate_loss_launches`` counts a step."""
    cs = _chip_smoke()
    cfg = PRESETS["tiny"]
    state = train_state_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, warmup_steps=1, **kw)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(5, 0, 0, 4, 32, cfg.vocab_size).items()}
    step(state, batch)
    n, forwards = kw.get("num_microbatches", 1), 1 if "remat" in kw else 2
    want = cs.gate_loss_step(G, CE, cfg, n, forwards, True)
    assert emulated == {k: {r: c for r, c in by.items() if c}
                        for k, by in want.items() if k != "cross_entropy_sum"}


def _routes(routes, **by_route):
    return {**dict.fromkeys(routes, 0), **by_route}


# train: tiny (2 gated layers, f32) 4 steps each of 1, 2 and 1 microbatches
# and 8 of 2 (the bits check) with remat: 32 passes; lm100m (12 layers,
# f32) 307 steps without remat; codeqwen1.5-7b (bf16) at 16 layers the
# graph's and the eager columns' 10 timed and profiled steps, the
# FLOP-counted one, step 1's plain-attention grads and the parent column's
# 4 steps (remat), and forward_train's loss (one forward, no backward); at
# 2 layers 10 steps with and 2 without remat; the plain column's 4 steps
# none (plain ops); the other five families (bf16, remat) FULL passes at
# full width (8 timed and 2 profiled steps, the FLOP-counted one, step
# 1's grads), forward_train's loss and BITS steps at 2 layers (4 eager, 4
# through the graph, 1 profiled, step 1's grads), the gate a layer in granite's experts (32) and
# chameleon (4; mamba2 has no MLP, zamba2's and whisper's are gelu), and
# each family's step 1 on the kernels in f32 (a pass on the f32 routes);
# examples: lm20m (6 layers) x 200 steps
FULL, BITS = 12, 10
FAMILY_GATES = (FULL * 32 * 2 + 32 + BITS * 2 * 2) \
    + (FULL * 4 * 2 + 4 + BITS * 2 * 2)
FAMILY_GATES_BWD = (FULL * 32 + BITS * 2) + (FULL * 4 + BITS * 2)
EXPECTED_GATE_LOSS = {
    "train": {
        "gated_act_fwd": _routes(
            G.ROUTES, silu_f32=32 * 2 * 2 + 307 * 12 + (32 + 4) * 2,
            silu_bf16=16 * 16 * 2 + 16 + 10 * 2 * 2 + 2 * 2 + FAMILY_GATES),
        "gated_act_bwd": _routes(
            G.ROUTES, silu_f32=32 * 2 + 307 * 12 + 32 + 4,
            silu_bf16=16 * 16 + 10 * 2 + 2 * 2 + FAMILY_GATES_BWD),
        "cross_entropy_fwd": _routes(CE.ROUTES, f32=32 + 307 + 5,
                                     bf16=16 + 1 + 12 + 5 * (FULL + 1 + BITS)),
        "cross_entropy_sum": _routes(CE.ROUTES, f32=32 + 307 + 5,
                                     bf16=16 + 1 + 12 + 5 * (FULL + 1 + BITS)),
        "cross_entropy_bwd": _routes(CE.ROUTES, f32=32 + 307 + 5,
                                     bf16=16 + 12 + 5 * (FULL + BITS))},
    "examples": {
        "gated_act_fwd": _routes(G.ROUTES, silu_f32=200 * 6),
        "gated_act_bwd": _routes(G.ROUTES, silu_f32=200 * 6),
        "cross_entropy_fwd": _routes(CE.ROUTES, f32=200),
        "cross_entropy_sum": _routes(CE.ROUTES, f32=200),
        "cross_entropy_bwd": _routes(CE.ROUTES, f32=200)},
    "dryrun": {k: _routes(G.ROUTES if k.startswith("gated") else CE.ROUTES)
               for k in ("gated_act_fwd", "gated_act_bwd",
                         "cross_entropy_fwd", "cross_entropy_sum",
                         "cross_entropy_bwd")},
}


@pytest.mark.parametrize("phase", sorted(EXPECTED_GATE_LOSS))
def test_chip_smoke_expected_gate_loss_launches(phase):
    cs = _chip_smoke()
    assert cs.expected_gate_loss_launches(G, CE, phase) == \
        EXPECTED_GATE_LOSS[phase]


def test_chip_smoke_window_checks_host_and_device(monkeypatch):
    """``gate_loss_window``'s check: totals on the host and the device for
    a serve run (replays count on the device only), by route for the
    others (the loss's forward stands for its sum on the host); it fails
    on a miscount."""
    cs = _chip_smoke()
    zero = {**{k: dict.fromkeys(G.ROUTES, 0) for k in G.KERNELS},
            **{k: dict.fromkeys(CE.ROUTES, 0) for k in CE.KERNELS}}
    device = {k: dict(v) for k, v in zero.items()}
    for mod in (G, CE):
        monkeypatch.setattr(mod, "_lib", lambda: None)
    monkeypatch.setattr(G, "kernel_launches", lambda lib: {
        k: dict(device[k]) for k in G.KERNELS})
    monkeypatch.setattr(CE, "kernel_launches", lambda lib: {
        k: dict(device[k]) for k in CE.KERNELS})
    serve = {k: {"host": 0, "device": 0} for k in zero}
    serve["gated_act_fwd"] = {"host": 3, "device": 7}
    check = cs.gate_loss_window(G, CE)
    G.gated_act_fwd.launches_by_route["silu_bf16"] = 3
    device["gated_act_fwd"]["silu_bf16"] = 7
    check("path", serve)
    assert cs.GATE_LOSS_LAUNCHES["path"]["device"]["gated_act_fwd"][
        "silu_bf16"] == 7
    device["cross_entropy_bwd"]["bf16"] = 1
    with pytest.raises(SystemExit):
        check("path", serve)
    device = {k: dict(v) for k, v in zero.items()}
    check = cs.gate_loss_window(G, CE)
    want = {k: dict(v) for k, v in zero.items()}
    for k in ("cross_entropy_fwd", "cross_entropy_sum"):
        want[k]["f32"] = 2
        device[k]["f32"] = 2
    CE.cross_entropy_fwd.launches_by_route["f32"] = 2
    check("phase", want)
    device["cross_entropy_sum"]["f32"] = 1
    with pytest.raises(SystemExit):
        check("phase", want)
    CE.cross_entropy_fwd.launches_by_route["f32"] = 0


def test_chip_smoke_profile_names_every_gate_and_loss_kernel():
    cs = _chip_smoke()
    for source, part in (("gated_mlp", "gate_kernels"),
                         ("cross_entropy", "loss_kernels")):
        src = (_build.CSRC / f"{source}.cu").read_text()
        names = set(re.findall(r"\b(\w+_kernel)\(", src))
        assert names, source
        for name in names:
            parts = [p for k, p in cs.NAMED_KERNEL_PARTS.items()
                     if k in name]
            assert parts == [part], name


def test_parent_path_shows_no_kernel_device():
    """``chip_smoke.plain_gate_loss`` (the train step's plain column and
    ``--serve-parent``) sends the model's gate and loss to the plain ops,
    and puts the choice back after."""
    cs = _chip_smoke()
    stand_in = [_stand_in("cuda")]
    with cs.plain_gate_loss():
        assert not G.takes_kernel(stand_in)
        assert not CE.takes_kernel(stand_in)
    assert G.takes_kernel(stand_in) and CE.takes_kernel(stand_in)
