"""The train step's CUDA graph (``train.steps.TrainGraph``) and the donated
step it captures, on the CPU, against the functional step and JAX.

The graph captures the donating step, so the donating step must keep the
whole state in place: params, m, v, the step counter and the
error-feedback residual, each in its own tensor, to the bits of the
functional step (and within ``test_torch_train``'s tolerances of JAX's
jitted step).  A CUDA graph cannot be captured here: ``TrainGraph``'s own
logic (static batch buffers, the copy in and out of a non-donated state,
when a step captures anew) is run with a stand-in graph whose replay runs
the captured function again; the capture itself is checked on the card by
``chip_smoke.py``.  Cases: one and two microbatches, remat on and off,
compression on and off.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import steps as JS  # noqa: E402
from repro_torch.bridge import train_state_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import optimizer as K  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from test_torch_train import STEP_KW, batches, cfgs, check  # noqa: E402

ARCH = "codeqwen15_7b"
CASES = [dict(), dict(num_microbatches=2), dict(remat=False),
         dict(compress=True),
         dict(num_microbatches=2, remat=False, compress=True)]
IDS = ["default", "microbatches2", "no_remat", "compress",
       "microbatches2_no_remat_compress"]


def bridged(compress=False):
    """(the port's state on the CPU, JAX's state), from JAX's seeded init."""
    _, jcfg = cfgs(ARCH)
    jstate = JS.train_state_init(jcfg, jax.random.PRNGKey(0),
                                 compress=compress)
    return (train_state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu"),
            jstate)


def torch_batches(cfg):
    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in batches(cfg)]


def same(a, b):
    """Equal dtypes, shapes and bits, leaf by leaf (None for None)."""
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_donated_step_keeps_the_state_in_place(kw):
    """Over 3 steps the donated step writes every tensor of the state in
    place (the step counter and the residual too), equals the functional
    step to the bit, and both are JAX's step within ``check``'s
    tolerances; ``metrics["step"]`` is a copy, which a later step leaves
    as it was."""
    tcfg, jcfg = cfgs(ARCH)
    compress = kw.get("compress", False)
    fstate, jstate = bridged(compress)
    dstate = tree_map(torch.clone, fstate)
    owned, counter = leaves(dstate), dstate.opt.step
    residual = leaves(dstate.residual)
    fstep = TS.make_train_step(tcfg, **STEP_KW, **kw)
    dstep = TS.make_train_step(tcfg, **STEP_KW, **kw, donate=True)
    jstep = jax.jit(JS.make_train_step(jcfg, **STEP_KW, **kw))
    metrics, steps_seen = [], []
    for i, b in enumerate(torch_batches(tcfg)):
        before = leaves(fstate)
        kept = [t.clone() for t in before]
        fstate, fm = fstep(fstate, b)
        dstate, dm = dstep(dstate, b)
        jstate, jm = jstep(jstate, {k: v.numpy() for k, v in b.items()})
        metrics.append((fm, jm))
        # the functional step leaves its input as it was
        for t, k in zip(before, kept):
            assert torch.equal(t, k)
        # the donated step writes into the tensors it was given
        now = leaves(dstate)
        assert len(now) == len(owned) and all(
            a is b_ for a, b_ in zip(now, owned))
        assert dstate.opt.step is counter
        assert all(a is b_ for a, b_ in zip(leaves(dstate.residual),
                                            residual))
        for m in (fm, dm):
            assert m["step"].data_ptr() != dstate.opt.step.data_ptr()
            assert m["step"].data_ptr() != fstate.opt.step.data_ptr()
        steps_seen.append(dm["step"])
        for k in fm:
            assert torch.equal(fm[k], dm[k]), k
        same(fstate, dstate)
        assert int(dstate.opt.step) == i + 1
    assert [int(s) for s in steps_seen] == [1, 2, 3]
    assert len(residual) == (len(leaves(dstate.params)) if compress else 0)
    check(fstate, jstate, metrics, compress=compress)


class ReplayedGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: ``replay`` runs
    the captured call again and writes its metrics into the tensors the
    capture returned, as a replay writes its static outputs."""

    def __init__(self):
        self.call = self.out = None

    def replay(self):
        _, metrics = self.call()
        for k, v in metrics.items():
            self.out[k].copy_(v)


def stand_in_capture(graph, dev, fn, *args):
    """``train.steps._capture`` on the CPU: the call runs once for its
    outputs, and every tensor it was given is put back as it was (a
    capture records the step without running it)."""
    given = [t for t in leaves(args) if isinstance(t, torch.Tensor)]
    kept = [t.clone() for t in given]
    out = fn(*args)
    for t, k in zip(given, kept):
        t.copy_(k)
    graph.call, graph.out = (lambda: fn(*args)), out[1]
    return out, 0.0


@pytest.fixture
def stand_in_graph(monkeypatch):
    """Every step of ``make_train_step`` but ``graph=False``'s goes through
    ``TrainGraph``, on ``ReplayedGraph`` and ``stand_in_capture``;
    ``TrainGraph.counts`` start at 0."""
    monkeypatch.setattr(TS, "_capture", stand_in_capture)
    monkeypatch.setattr(TS.torch.cuda, "CUDAGraph", ReplayedGraph)
    monkeypatch.setattr(TS.TrainStep, "on_graph",
                        lambda self, state: self.use_graph is not False)
    monkeypatch.setattr(TS.TrainGraph, "counts",
                        {"captures": 0, "replays": 0})


@pytest.mark.parametrize("donate", [True, False], ids=["donated",
                                                       "not_donated"])
@pytest.mark.parametrize("kw", [dict(), dict(num_microbatches=2,
                                             compress=True)],
                         ids=["default", "microbatches2_compress"])
def test_train_graph_logic_equals_the_eager_step(kw, donate,
                                                 stand_in_graph):
    """Through ``TrainGraph`` (a stand-in graph), 3 steps equal the eager
    step to the bit: one capture, then replays from the static batch
    buffers; a donated graph updates the caller's tensors, a non-donated
    one leaves the caller's state alone and returns fresh tensors."""
    tcfg, _ = cfgs(ARCH)
    compress = kw.get("compress", False)
    start, _ = bridged(compress)
    estate, gstate = (tree_map(torch.clone, start) for _ in range(2))
    estep = TS.make_train_step(tcfg, **STEP_KW, **kw, donate=donate,
                               graph=False)
    gstep = TS.make_train_step(tcfg, **STEP_KW, **kw, donate=donate)
    owned = leaves(gstate)
    for b in torch_batches(tcfg):
        given = leaves(gstate)
        kept = [t.clone() for t in given]
        estate, em = estep(estate, b)
        gstate, gm = gstep(gstate, b)
        for k in em:
            assert torch.equal(em[k], gm[k]), k
        same(estate, gstate)
        if donate:
            assert all(a is b_ for a, b_ in zip(leaves(gstate), owned))
        else:
            assert all(torch.equal(t, k) for t, k in zip(given, kept))
            assert not any(a is b_ for a in leaves(gstate)
                           for b_ in leaves(gstep.graph.state))
        assert gm["step"].data_ptr() != gstep.graph.metrics[
            "step"].data_ptr()
    assert TS.TrainGraph.counts == {"captures": 1, "replays": 2}
    assert gstep.graph.replays == 2
    gstep.close()
    assert gstep.graph is None


def test_train_graph_captures_anew_for_another_state_or_batch(
        stand_in_graph):
    """A donated step's graph belongs to its state: another state captures
    anew, as do other batch shapes; a non-donated graph replays for any
    state of the same shapes."""
    tcfg, _ = cfgs(ARCH)
    start, _ = bridged()
    a, b = (tree_map(torch.clone, start) for _ in range(2))
    bs = torch_batches(tcfg)
    step = TS.make_train_step(tcfg, **STEP_KW, donate=True)
    a, _ = step(a, bs[0])
    first = step.graph
    a, _ = step(a, bs[1])
    assert step.graph is first and first.replays == 1
    b, _ = step(b, bs[0])                      # another state
    assert step.graph is not first
    short = {k: v[:2] for k, v in bs[1].items()}
    second = step.graph
    b, _ = step(b, short)                      # other batch shapes
    assert step.graph is not second
    assert TS.TrainGraph.counts == {"captures": 3, "replays": 1}
    step.close()

    free = TS.make_train_step(tcfg, **STEP_KW)
    c, _ = free(tree_map(torch.clone, start), bs[0])
    d, _ = free(tree_map(torch.clone, start), bs[1])
    c, _ = free(c, bs[2])
    assert TS.TrainGraph.counts == {"captures": 4, "replays": 3}
    free.close()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_graph_none_runs_eagerly_off_cuda(device):
    """``graph=None`` runs the step eagerly on CPU and meta tensors (the
    dry-run's path): no graph is made; ``graph=True`` raises there and
    ``graph=False`` is eager."""
    cfg = get_smoke_config(ARCH)
    state = TS.train_state_init(cfg, torch.Generator().manual_seed(0),
                                device=device)
    b = {k: v.to(device) for k, v in torch_batches(cfg)[0].items()}
    counts = dict(TS.TrainGraph.counts)
    for graph in (None, False):
        step = TS.make_train_step(cfg, **STEP_KW, graph=graph)
        assert not step.on_graph(state)
        new, m = step(state, b)
        assert step.graph is None
        assert m["loss"].device.type == device
        assert new.opt.step.device.type == device
    assert TS.TrainGraph.counts == counts
    with pytest.raises(ValueError, match="graph=True"):
        TS.make_train_step(cfg, **STEP_KW, graph=True)(state, b)


def test_sumsq_ticket_is_cached_outside_a_capture_and_new_inside(
        monkeypatch):
    """``sumsq``'s ticket: one zeroed tensor a (device, stream) outside a
    capture, the same on every call; inside a capture a new zeroed one each
    time (from the graph's pool, zeroed by a captured fill), never the
    cached one and never cached."""
    monkeypatch.setattr(K, "_TICKETS", {})
    dev = torch.device("cpu")
    t = K._ticket(dev, 7, False)
    assert t.dtype == torch.int32 and t.shape == () and int(t) == 0
    assert K._ticket(dev, 7, False) is t
    other = K._ticket(dev, 8, False)
    assert other is not t
    inside = [K._ticket(dev, 7, True) for _ in range(2)]
    assert inside[0] is not inside[1]
    for x in inside:
        assert x is not t and x is not other and int(x) == 0
    assert len(K._TICKETS) == 2
