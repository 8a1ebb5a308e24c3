"""The train steps of the five non-dense families (mamba2, zamba2, granite,
whisper, chameleon), checked on the CPU for what would break them on the
card, where ``chip_smoke.py`` runs them through the train step's CUDA
graph at full width:

(a) one donated, rematerialised train step of each smoke config on meta
    tensors (which, like CUDA ones, skip the data checks CPU kernels make:
    ``F.one_hot``'s range check) under a ``TorchDispatchMode`` that fails
    on every op that reads a tensor on the host (``HOST_SYNC_OPS``): such
    an op fails a graph capture;
(b) the smoke config's eager train step on the CPU (``graph=None``) makes
    every lazily cached tensor of the port (whisper's sinusoid tables) on
    its first step and none on its second: the graph's warm-up is its
    first step, and a tensor first made inside a capture dies with the
    graph's pool;
(c) ``forward_train`` and its backward through the training attention,
    the norm and RoPE, the gate and the loss functions, their launches
    emulated on the CPU by the plain versions: the loss and grads of the
    f32 smoke configs equal JAX's ``value_and_grad`` (1e-4 abs and rel.,
    ``MODEL_TOL``),
    and in f32 and bf16 the launches by kernel and route are those
    ``chip_smoke.py`` counts for a step (``expected_attention_launches``,
    ``norm_rope_pass``, ``gate_loss_step``);
(d) one donated step's update through the optimizer's kernel functions
    (emulated) launches what ``chip_smoke.py`` counts by route: each
    leaf on its own dtype's (the SSM's and the router's f32 leaves);
(e) the plain SSD scan's grads where an exp of its masked entries
    overflows: finite, and those of a direct f64 evaluation (the
    reference's where after the exp gives NaN there);
(f) ``chip_smoke.py``'s split of a profiled step by part gives the plain
    SSD scan's and the plain MoE glue's ops, and the backward nodes made
    from them, parts of their own (``scoped_plain_ops``, ``train_part``),
    and reading the raw events without the op tree gives the same
    (``range_parts``);
(g) ``chip_smoke.py``'s step 1 against the plain route: each kernel part
    sent alone to its plain version (``plain_kernels``), every route on
    one rounded state and the grads' errors (``step1_on_routes``), and
    the step bound's SSD products.
"""
import dataclasses
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import cross_entropy as CE  # noqa: E402
from repro_torch.kernels import gated_mlp as G  # noqa: E402
from repro_torch.kernels import norm_rope as K  # noqa: E402
from repro_torch.kernels import optimizer as OPT  # noqa: E402
from repro_torch.kernels import train_attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402
from repro_torch.train import make_train_step, train_state_init  # noqa: E402
from repro_torch.train.steps import _grads  # noqa: E402
from repro_torch.tree import leaves, leaves_with_path, tree_map  # noqa: E402
from test_torch_cross_entropy import emulated  # noqa: E402,F401
from test_torch_fused_norm import (batch_of, close, configs,  # noqa: E402
                                   fused_emulated, reset,  # noqa: F401
                                   shared_params)

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ["mamba2_1_3b", "zamba2_2_7b", "granite_moe_3b_a800m",
            "whisper_large_v3", "chameleon_34b"]
# the SSM smoke configs' chunk fits the short sequences here
CHUNK = {"mamba2_1_3b": {"ssm_chunk": 8}, "zamba2_2_7b": {"ssm_chunk": 8}}
B, S = 2, 16
# the ATen ops that read a tensor's values on the host (a synchronise,
# which a CUDA graph's capture refuses): the scalar read, and the ops
# whose output shape depends on the data
HOST_SYNC_OPS = ("_local_scalar_dense", "item", "is_nonzero", "equal",
                 "allclose", "nonzero", "nonzero_static", "masked_select",
                 "_unique", "_unique2", "unique_dim", "unique_consecutive",
                 "unique_dim_consecutive")
# ops of HOST_SYNC_OPS a family's step cannot avoid, with the reason: none
ALLOWED_SYNCS: dict = {}


@pytest.fixture(autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def smoke(arch, dtype="float32"):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               **CHUNK.get(arch, {}))


def train_batch(cfg, device, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, max(S // cfg.encoder_ratio, 1), cfg.d_model)).astype(
                np.float32)).to(cfg.torch_dtype)
    return {k: v.to(device) for k, v in batch.items()}


class HostSyncs(TorchDispatchMode):
    """Counts every op dispatched under it, and the ops of
    ``HOST_SYNC_OPS`` and ``repeat_interleave`` with a tensor of repeats
    (its output size is read from the repeats) apart."""

    def __init__(self):
        super().__init__()
        self.ops, self.syncs = Counter(), Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        if name in HOST_SYNC_OPS or (
                name == "repeat_interleave"
                and func._overloadname in ("Tensor", "self_Tensor")):
            self.syncs[f"{name}.{func._overloadname}"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_on_meta_reads_nothing_on_the_host(arch):
    """One donated, rematerialised train step on meta tensors (forward,
    the recomputed forward, the backward, the norm, the clip, AdamW)
    dispatches no op that reads a tensor on the host."""
    cfg = smoke(arch, "bfloat16")
    state = train_state_init(cfg, torch.Generator(), device="meta")
    step = make_train_step(cfg, warmup_steps=1, remat=True, donate=True)
    watch = HostSyncs()
    with watch:
        _, metrics = step(state, train_batch(cfg, "meta"))
    assert metrics["loss"].device.type == "meta"
    # the step ran its backward and its update under the mode
    assert watch.ops["embedding_dense_backward"] == 1
    assert watch.ops["mm"] + watch.ops["bmm"] > 0
    if cfg.family == "moe":         # the plain route's one-hot, dispatch
        assert watch.ops["scatter_add"] and watch.ops["gather"]
    assert dict(watch.syncs) == ALLOWED_SYNCS.get(arch, {})


def _lazy_caches() -> dict:
    """Every lazily filled cache of the port's modules: each
    ``functools.lru_cache`` (its entries) and each module-level dict
    named ``_UPPER`` (its keys)."""
    out = {}
    for name, mod in list(sys.modules.items()):
        if not name.startswith("repro_torch") or \
                name.startswith("repro_torch.core"):
            continue
        for attr, obj in vars(mod).items():
            if hasattr(obj, "cache_info") and callable(obj):
                out[f"{name}.{attr}"] = obj.cache_info().currsize
            elif isinstance(obj, dict) and attr.startswith("_") \
                    and attr[1:2].isupper() and attr.upper() == attr:
                out[f"{name}.{attr}"] = len(obj)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_first_step_makes_every_lazy_tensor(arch):
    """The eager step on the CPU (``graph=None``) fills the port's lazy
    caches on its first step (whisper's sinusoid tables: the encoder's
    frames and the decoder's tokens) and leaves them as they are on its
    second."""
    cfg = smoke(arch)
    TM._sinusoid.cache_clear()
    state = train_state_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, warmup_steps=1, remat=True, donate=True)
    batch = train_batch(cfg, "cpu")
    before = _lazy_caches()
    state, _ = step(state, batch)
    assert step.graph is None
    first = _lazy_caches()
    state, _ = step(state, batch)
    assert _lazy_caches() == first
    made = {k: n - before.get(k, 0) for k, n in first.items()
            if n != before.get(k, 0)}
    assert made == ({"repro_torch.models.model._sinusoid": 2}
                    if cfg.family == "encdec" else {})


@pytest.fixture
def attention_emulated(monkeypatch):
    """CPU tensors take ``TrainAttention``, whose forward and backward
    launches run the plain version here (autograd for the backward) and
    count themselves by call and route."""
    counts = {"train_attention_forward": Counter(),
              "train_attention_backward": Counter()}
    lock = threading.Lock()

    def count(name, q, k):
        with lock:
            counts[name][TA.route(q.dtype, k.dtype, q.shape[3])] += 1

    def fwd(q, k, v, *, causal, window, logit_cap, lib=None):
        count("train_attention_forward", q, k)
        o = TA.train_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap)
        lse = torch.zeros((q.shape[0], q.shape[2], q.shape[1]))
        return o.to(q.dtype), o, lse

    def bwd(q, k, v, o32, lse, dout, *, causal, window, logit_cap,
            lib=None):
        count("train_attention_backward", q, k)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            o = TA.train_attention_plain(*leaves, causal=causal,
                                         window=window, logit_cap=logit_cap)
            return torch.autograd.grad(o, leaves, dout.float())
    monkeypatch.setattr(TA, "takes_kernel",
                        lambda ts: all(t.device.type == "cpu" for t in ts))
    monkeypatch.setattr(TA, "train_attention_forward", fwd)
    monkeypatch.setattr(TA, "train_attention_backward", bwd)
    return counts


def _nonzero(by_kernel: dict) -> dict:
    return {k: {r: n for r, n in by.items() if n}
            for k, by in by_kernel.items() if any(by.values())}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_step_launches_are_chip_smokes(arch, dtype, attention_emulated,
                                       fused_emulated, emulated):
    """``forward_train`` with remat and its backward through the training
    attention, norm and RoPE, gate and loss functions (launches emulated):
    in f32 its loss and grads equal JAX's; in both dtypes its launches by
    kernel and route are what ``chip_smoke.py`` counts for one step of the
    config (whisper's frames in the config's dtype, as its train input)."""
    cs = _chip_smoke()
    cfg, jcfg = configs(arch, CHUNK.get(arch, {}))
    cfg = dataclasses.replace(cfg, dtype=dtype)
    tree = shared_params(jcfg, seed=2)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {**batch_of(cfg, toks), "labels": labels}
    reset(fused_emulated)
    for by in attention_emulated.values():
        by.clear()
    params = params_from_numpy(tree, "cpu")
    if dtype == "bfloat16":         # the f32 leaves of a bf16 init stay f32
        ref = TM.init_params(cfg, torch.Generator(), device="meta")
        params = tree_map(lambda t, r: t.to(r.dtype), params, ref)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if "frames" in tb:
        tb["frames"] = tb["frames"].to(cfg.torch_dtype)
    tloss, tgrads = _grads(lambda p, mb: TM.forward_train(
        p, cfg, mb, remat=True)[0], params, tb)
    if dtype == "float32":
        jloss, jgrads = jax.value_and_grad(lambda p: JM.forward_train(
            p, jcfg, jax.tree.map(jnp.asarray, batch), remat=True)[0])(
            jax.tree.map(jnp.asarray, tree))
        close(tloss, jloss)
        jl, tl = jax.tree.leaves(jgrads), jax.tree.leaves(tgrads)
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            close(t, j)
    attention = cs.expected_attention_launches(
        TA, "train", steps=[(cfg, 1, 1, 2)])
    assert _nonzero({k: dict(v) for k, v in attention_emulated.items()}) \
        == _nonzero(attention)
    assert fused_emulated == cs.norm_rope_pass(
        K, cfg, "forward", 1, forwards=2, backward=True,
        frames_dtype=cfg.torch_dtype)
    want = cs.gate_loss_step(G, CE, cfg, 1, 2, True)
    assert emulated == {k: {r: c for r, c in by.items() if c}
                        for k, by in want.items() if k != "cross_entropy_sum"}


class OptimizerStandIn:
    """``optim.adamw``'s kernel module on the CPU: every tensor takes the
    kernels, whose launches run the plain update and sum here and count
    themselves by kernel and route, as the wrappers plan them."""

    def __init__(self):
        self.counts = {"adamw_update": Counter(), "sumsq": Counter()}

    @staticmethod
    def takes_kernel(tensors):
        return all(t.device.type == "cpu" for t in tensors)

    def sumsq(self, gs):
        for first, n, _ in OPT.sumsq_plan([(g.numel(), g.dtype)
                                           for g in gs]):
            self.counts["sumsq"][OPT.sumsq_route(
                g.dtype for g in gs[first:first + n])] += 1
        return sum(g.float().square().sum() for g in gs)

    def adamw_update(self, p, g, m, v, *args, inplace):
        self.counts["adamw_update"][OPT.adamw_route(p.dtype, g.dtype)] += 1
        new = A._update_slice(p, g, m, v, *args)
        if not inplace:
            return new
        for t, n in zip((p, m, v), new):
            t.copy_(n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_update_launches_are_chip_smokes(arch, monkeypatch):
    """One donated train step of the bf16 smoke config through the
    optimizer's kernel functions (emulated) launches what
    ``chip_smoke.expected_optimizer_launches`` counts a step: each leaf on
    its own dtype's route (the SSM's and the router's f32 leaves beside
    bf16 ones), ``sumsq`` on ``mixed`` where a launch's leaves differ."""
    cs = _chip_smoke()
    cfg = smoke(arch, "bfloat16")
    stand_in = OptimizerStandIn()
    monkeypatch.setattr(A, "K", stand_in)
    state = train_state_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, warmup_steps=1, remat=True, donate=True)
    step(state, train_batch(cfg, "cpu"))
    monkeypatch.setattr(cs, "optimizer_steps", lambda phase: [(cfg, 1)])
    assert _nonzero({k: dict(v) for k, v in stand_in.counts.items()}) == \
        _nonzero(cs.expected_optimizer_launches(torch, OPT, "train"))
    if cfg.family in ("ssm", "hybrid", "moe"):
        assert stand_in.counts["sumsq"]["mixed"] == 1


@pytest.mark.parametrize("arch,part", [("mamba2_1_3b", "ssd_plain"),
                                       ("zamba2_2_7b", "ssd_plain"),
                                       ("granite_moe_3b_a800m", "moe_plain")])
def test_profile_split_gives_the_plain_ops_their_part(arch, part):
    """Under ``scoped_plain_ops`` a profiled donated step's SSD scan or
    MoE glue ops, in the forward, in remat's recompute and in the backward
    (their autograd nodes, run outside the range: ``scoped_nodes``), take
    their own part (``train_part``); the layers' projections and the head
    do not, nor any backward node by the optimizer's ranges
    (``scoped_optimizer``); ``scoped_plain_ops`` leaves the functions as
    they were."""
    from torch.profiler import ProfilerActivity, profile
    cs = _chip_smoke()
    cfg = smoke(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    real = [getattr(sys.modules[m], n) for _, m, n in cs.PLAIN_OPS_PARTS
            if m in sys.modules]
    state = train_state_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, warmup_steps=1, remat=True, donate=True)
    batch = train_batch(cfg, "cpu")
    state, _ = step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with cs.scoped_optimizer(), cs.scoped_plain_ops():
            step(state, batch)
    assert real == [getattr(sys.modules[m], n)
                    for _, m, n in cs.PLAIN_OPS_PARTS if m in sys.modules]
    nodes = cs.scoped_nodes(prof)
    # the optimizer's ops make no node: the sequence number they record
    # is the next node's, which no backward of the step runs
    assert set(nodes.values()) == {part}
    dtypes = {e.id: "float32" for e in prof.events()
              if e.name in cs.GEMM_OPS}
    parts = Counter()
    backward = Counter()
    for e in prof.events():
        if not e.name.startswith("aten::"):
            continue
        got = cs.train_part(e, dtypes, nodes)
        parts[got] += 1
        scope = e.cpu_parent
        while scope is not None and not scope.name.startswith(
                cs.BACKWARD_NODE):
            scope = scope.cpu_parent
        if scope is not None and not cs._forward_op(e):
            backward[got] += 1
    assert parts[part] > 0 and backward[part] > 0
    other = {"ssd_plain": "moe_plain", "moe_plain": "ssd_plain"}[part]
    assert parts[other] == 0
    # the projections' and the head's GEMMs and their backward stay GEMMs
    assert parts["gemm_f32"] > 0
    assert set(parts) <= {part, "gemm_f32", "elementwise", "optimizer",
                          "global_norm"}


class _Kernel:
    """A device kernel as the profiler's raw events give it: launched by
    the op of correlation id ``corr``, 1 ms long."""

    def __init__(self, corr):
        self.corr = corr

    def device_type(self):
        return torch.autograd.DeviceType.CUDA

    def is_user_annotation(self):
        return False

    def name(self):
        return "kernel"

    def linked_correlation_id(self):
        return self.corr

    def duration_ns(self):
        return 1_000_000


@pytest.mark.parametrize("arch,part", [("mamba2_1_3b", "ssd_plain"),
                                       ("zamba2_2_7b", "ssd_plain"),
                                       ("granite_moe_3b_a800m", "moe_plain")])
def test_range_parts_is_train_parts_rule_on_raw_events(arch, part):
    """``range_parts`` reads the profiler's raw events without the op
    tree, and gives each ATen op's kernels the part ``train_part`` gives
    the op in the tree (``scoped_nodes``' backward link included): with
    one 1-ms kernel an op, each range's ms are its ops' count."""
    from torch.profiler import ProfilerActivity, profile
    cs = _chip_smoke()
    cfg = smoke(arch)
    state = train_state_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, warmup_steps=1, remat=True, donate=True)
    batch = train_batch(cfg, "cpu")
    state, _ = step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with cs.scoped_optimizer(), cs.scoped_plain_ops():
            step(state, batch)
    nodes = cs.scoped_nodes(prof)
    ops = [e for e in prof.events() if e.name.startswith("aten::")]
    dtypes = {e.id: "float32" for e in ops if e.name in cs.GEMM_OPS}
    want = Counter()
    for e in ops:
        got = cs.train_part(e, dtypes, nodes)
        if got in (part, "optimizer", "global_norm"):
            want[got] += 1.0
    events = list(prof.profiler.kineto_results.events())
    events += [_Kernel(e.id) for e in ops]
    got = cs.range_parts(torch, events)
    assert want[part] > 0
    assert got == dict(want)


def test_ssd_scan_grads_past_the_exp_overflow():
    """The plain chunked SSD scan's grads where a chunk's exp(cum_i -
    cum_j), i < j, overflows f32 (dt ~ 3 over a 64-row chunk): the
    reference's where after the exp gives NaN grads there (0 x inf); the
    port, masking before the exp, gives the grads of the same function,
    held to a direct f64 evaluation of it (y_i = sum over j <= i of C_i.B_j
    exp(cum_i - cum_j) dt_j x_j, the final state likewise)."""
    from repro.models import ssm as JS
    from repro_torch.models.ssm import ssd_chunked
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 64, 2, 4, 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (3 + rng.random((b, s, h))).astype(np.float32)
    a = -np.ones(h, np.float32)
    bb = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    wy = rng.standard_normal((b, s, h, p))
    wh = rng.standard_normal((b, h, n, p))

    def jloss(x, dt, bb, cc):
        y, st = JS.ssd_chunked(x, dt, jnp.asarray(a), bb, cc, s)
        return (y * wy).sum() + (st.astype(jnp.float32) * wh).sum()
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(x, dt, bb, cc)
    assert any(np.isnan(np.asarray(g)).any() for g in jgrads)

    leaves = [torch.from_numpy(v).requires_grad_(True)
              for v in (x, dt, bb, cc)]
    y, st = ssd_chunked(leaves[0], leaves[1], torch.from_numpy(a),
                        leaves[2], leaves[3], s)
    ((y * torch.from_numpy(wy).float()).sum()
     + (st * torch.from_numpy(wh).float()).sum()).backward()
    got = [t.grad for t in leaves]
    assert all(torch.isfinite(g).all() for g in got)

    ref = [torch.from_numpy(v).double().requires_grad_(True)
           for v in (x, dt, bb, cc)]
    xd, dtd, bd, cd = ref
    cum = torch.cumsum(dtd * torch.from_numpy(a).double(), 1)  # (b, s, h)
    i = torch.arange(s)
    keep = (i[:, None] >= i[None, :])[None, :, :, None]
    diff = torch.where(keep, cum[:, :, None] - cum[:, None, :], 0.0)
    decay = torch.where(keep, diff.exp(), 0.0)              # (b, s, s, h)
    cb = torch.einsum("bign,bjgn->bij", cd, bd)[..., None]
    yd = torch.einsum("bijh,bjhp->bihp", cb * decay * dtd[:, None],
                      xd)
    to_end = (cum[:, -1:] - cum).exp() * dtd                # (b, s, h)
    std = torch.einsum("bjgn,bjh,bjhp->bhnp", bd, to_end, xd)
    ((yd * torch.from_numpy(wy)).sum()
     + (std * torch.from_numpy(wh)).sum()).backward()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.grad.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(r.grad.abs().max()))


def test_layer_shares_keep_the_step_parts_to_their_kernels():
    """A shallow step's shares for a deeper step (``layer_shares``): the
    optimizer's and the global norm's shares of a kernel name the layers
    share move to the elementwise casts and copies (they run once a
    step); their own kernels and every other part's shares stay."""
    cs = _chip_smoke()
    by_kernel = {
        "void at::native::elementwise_kernel<128, 4>": {
            "optimizer": 0.75, "global_norm": 0.5, "ssd_plain": 10.0,
            "elementwise": 2.0, "casts_copies": 1.0,
            "casts_copies:aten::copy_": 1.0},
        "void (anonymous namespace)::adamw_update_kernel<bf16>": {
            "optimizer": 1.25},
        "(anonymous namespace)::sumsq_kernel(SumsqTable)": {
            "global_norm": 0.25}}
    got = cs.layer_shares(by_kernel)
    assert got["void at::native::elementwise_kernel<128, 4>"] == {
        "ssd_plain": 10.0, "elementwise": 3.25, "casts_copies": 2.25,
        "casts_copies:aten::copy_": 1.0}
    for name in list(by_kernel)[1:]:
        assert got[name] == by_kernel[name]
    split = cs.split_by_name(
        [("void at::native::elementwise_kernel<128, 4>", 132.5),
         ("void (anonymous namespace)::adamw_update_kernel<bf16>", 5.0)],
        137.5, got)
    assert split["optimizer"] == 5.0 and split["global_norm"] == 0.0
    assert split["ssd_plain"] == pytest.approx(100.0)


@pytest.mark.parametrize("part", ["attention", "norms", "fused", "add_norm",
                                  "gated_norm", "gate", "loss",
                                  "optimizer"])
def test_plain_kernels_sends_one_part_to_its_plain_version(part):
    """``plain_kernels((part,))`` shows that part's entry point no kernel
    device (or gives its caller the plain function), leaves every other
    part's as it was, and restores them all on exit."""
    from repro_torch.models import common as C
    from repro_torch.models import ssm as SM
    cs = _chip_smoke()

    def seen():
        return {"attention": TA.takes_kernel, "norms": K.takes_kernel,
                "fused": K.takes_fused, "add_norm": TM.add_rms_norm,
                "gated_norm": SM.gated_rms_norm, "gate": G.takes_kernel,
                "loss": CE.takes_kernel, "optimizer": A.K}
    before = seen()
    with cs.plain_kernels((part,)):
        inside = seen()
    assert seen() == before
    assert {k for k in before if inside[k] is not before[k]} == {part}
    plain = {"add_norm": C.add_rms_norm_plain,
             "gated_norm": C.gated_rms_norm_plain}
    if part in plain:
        assert inside[part] is plain[part]
    elif part == "optimizer":
        assert inside[part].takes_kernel([]) is False
    else:
        assert inside[part]([]) is False
    with cs.plain_route():
        assert all(v is not before[k] for k, v in seen().items())
    assert seen() == before


def _cpu_family_state(torch_, cfg):
    params = tree_map(lambda t, r: t.to(r.dtype), TM.init_params(
        dataclasses.replace(cfg, dtype="float32"),
        torch.Generator().manual_seed(0), device="cpu"),
        TM.init_params(cfg, torch.Generator(), device="meta"))
    return params, train_batch(cfg, "cpu")


@pytest.mark.parametrize("arch", FAMILIES)
def test_step1_on_routes_reads_one_state_on_every_route(arch, monkeypatch):
    """``step1_on_routes`` on a bf16 smoke config (the CPU takes the plain
    versions on every route): the f32 routes read the bf16 params upcast,
    so the kernels' f32 step is the f32 plain route's to the bit, and the
    bf16 routes each other's; the errors against the f32 grads are those
    of the bf16 grads, over every leaf, and every relative field is
    filled in; at the bits check's routes (no f32 one) no f32 error is
    made."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "family_state", _cpu_family_state)
    cfg = smoke(arch, "bfloat16")
    rows, detail = cs.step1_on_routes(torch, cfg)
    assert list(rows) == ["plain_f32", "kernels_f32", "plain", "kernels"]
    for a, b in (("kernels_f32", "plain_f32"), ("kernels", "plain")):
        assert rows[a]["loss"] == rows[b]["loss"]
        assert rows[a]["grad_norm"] == rows[b]["grad_norm"]
    assert rows["kernels_f32"]["err_plain_f32"] == 0.0
    assert rows["kernels"]["err_plain"] == 0.0
    err = rows["plain"]["err_plain_f32"]
    assert 0.0 < err < 0.1 and rows["kernels"]["err_plain_f32"] == err
    params, batch = _cpu_family_state(torch, cfg)
    _, g16 = cs.step1_grads(torch, cfg, params, batch, cs.PLAIN_PARTS)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    _, g32 = cs.step1_grads(
        torch, cfg32, tree_map(lambda t: t.float(), params),
        {k: v.float() if v.is_floating_point() else v
         for k, v in batch.items()}, cs.PLAIN_PARTS)
    d = [(a.float() - b).flatten() for a, b in zip(leaves(g16),
                                                   leaves(g32))]
    want = float(torch.cat(d).norm() / torch.cat(
        [b.flatten() for b in leaves(g32)]).norm())
    assert err == pytest.approx(want, rel=1e-5)
    assert set(detail["plain_vs_plain_f32"]) == {
        p for p, _ in leaves_with_path(g32)}
    for row in rows.values():
        assert {"loss_vs_plain_f32", "grad_norm_vs_plain",
                "grad_norm_vs_plain_f32", "loss_vs_plain"} <= set(row)
    shallow, _ = cs.step1_on_routes(torch, cfg, cs.STEP1_ROUTES[2:])
    assert list(shallow) == ["plain", "kernels"]
    assert "err_plain_f32" not in shallow["kernels"]
    assert shallow["kernels"]["grad_norm_vs_plain"] == 0.0


def test_step_bound_counts_the_ssd_products_once_a_group():
    """``train_step_bound`` counts each chunk's C B^T once a group of B and
    C (the scan repeats it for each head of the group): doubling the
    groups adds their C B^T (bf16) and leaves the heads' f32 products;
    doubling the heads (half the head dim) leaves C B^T's count."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_smoke_config("mamba2_1_3b"),
                              dtype="bfloat16")
    params = TM.init_params(cfg, torch.Generator(), device="meta")

    def bound(**kw):
        return cs.train_step_bound(dataclasses.replace(cfg, **kw), params,
                                   2, 512)["flops_by_dtype"]
    q = min(cfg.ssm_chunk, 512)
    pairs = 512 // q * cs.visible_pairs(q, q, True, 0)
    one = bound()
    two = bound(ssm_groups=2 * cfg.ssm_groups)
    dt = str(cfg.torch_dtype)
    assert two[dt] - one[dt] == (3 * cfg.num_layers * 2 * cfg.ssm_groups
                                 * 2 * cfg.ssm_state * pairs)
    assert two["torch.float32"] == one["torch.float32"]
    heads = bound(ssm_headdim=cfg.ssm_headdim // 2)
    assert heads[dt] == one[dt]
