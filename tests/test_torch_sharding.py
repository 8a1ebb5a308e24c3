"""The port's sharding rules against the JAX package's, spec for spec and
decision for decision, for the ten configs at full width on the single-pod
(16, 16) mesh, the multi-pod (2, 16, 16) mesh and the ``ep`` view
(16, 8, 2) of the single-pod ranks.  Both sides read only axis names and
sizes: JAX's ``AbstractMesh`` and the port's ``AbstractMesh``, in this
process, with no devices."""
import os

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import AbstractMesh as JMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro.sharding import rules as JR  # noqa: E402
from repro.train import steps as JS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.models.common import SHAPES  # noqa: E402
from repro_torch.sharding import rules as TR  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multi": ((2, 16, 16), ("pod", "data", "model")),
    "ep": ((16, 8, 2), ("data", "expert", "tp")),
}
RULE_KW = {"ep": dict(tp=("expert", "tp"), expert_axis="expert")}


def _jax_dryrun():
    """The reference dry-run module, imported without letting its
    512-device ``XLA_FLAGS`` outlive the import (it sets the variable when
    imported; a later JAX backend or subprocess would read it)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def meshes(name):
    shape, names = MESHES[name]
    return JMesh(shape, names), TR.AbstractMesh(shape, names)


def jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in flat]


def port_flat(tree):
    return [(p, tuple(s)) for p, s in leaves_with_path(tree)]


_ABSTRACT = {}


def abstract(arch):
    """(port config, JAX config, port params, JAX params, port train
    state, JAX train state), all abstract, made once per config."""
    if arch not in _ABSTRACT:
        tcfg, jcfg = TC.get_config(arch), JC.get_config(arch)
        _ABSTRACT[arch] = (
            tcfg, jcfg, TC.abstract_params(tcfg), JC.abstract_params(jcfg),
            TC.eval_shape(lambda: TS.train_state_init(tcfg, device="cpu")),
            jax.eval_shape(lambda: JS.train_state_init(
                jcfg, jax.random.PRNGKey(0))))
    return _ABSTRACT[arch]


CASES = [(a, m) for a in TC.ARCH_NAMES for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_param_and_opt_specs_match_jax(arch, mesh):
    tcfg, jcfg, tp, jp, tstate, jstate = abstract(arch)
    jm, tm = meshes(mesh)
    kw = RULE_KW.get(mesh, {})
    jspecs, jdec = JR.param_pspecs(jcfg, jp, jm, **kw)
    tspecs, tdec = TR.param_pspecs(tcfg, tp, tm, **kw)
    assert port_flat(tspecs) == jax_flat(jspecs)
    assert tdec == jdec
    assert port_flat(TR.opt_pspecs(tspecs, tstate.opt)) == \
        jax_flat(JR.opt_pspecs(jspecs, jstate.opt))
    assert port_flat(TR.zero_opt_pspecs(tstate.opt, tm)) == \
        jax_flat(JR.zero_opt_pspecs(jstate.opt, jm))
    assert port_flat(TR.replicated_pspecs(tp)) == \
        jax_flat(JR.replicated_pspecs(jp))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_batch_cache_and_logits_specs_match_jax(arch, mesh):
    tcfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    jm, tm = meshes(mesh)
    for shape in SHAPES.values():
        tin, jin = TC.input_specs(tcfg, shape), JC.input_specs(jcfg, shape)
        for axes in (None, ("data", "model")):
            if axes and mesh == "ep":
                continue
            assert port_flat(TR.batch_pspecs(tcfg, tin, tm, batch_axes=axes)) \
                == jax_flat(JR.batch_pspecs(jcfg, jin, jm, batch_axes=axes))
        if shape.kind == "decode":
            assert port_flat(TR.cache_pspecs(tcfg, tin["cache"], tm)) == \
                jax_flat(JR.cache_pspecs(jcfg, jin["cache"], jm))
        b = shape.global_batch
        assert tuple(TR.logits_pspec(tcfg, b, tm)) == \
            tuple(JR.logits_pspec(jcfg, b, jm))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_arg_bytes_per_device_match_the_reference(arch, mesh):
    """``_arg_bytes_per_device`` of the reference dry-run and the port's on
    the same cells' argument trees: (state, batch) for train, (params,
    batch) for prefill, (params, cache) for decode."""
    jd = _jax_dryrun()
    tcfg, jcfg, tp, jp, tstate, jstate = abstract(arch)
    jm, tm = meshes(mesh)
    kw = RULE_KW.get(mesh, {})
    jspecs, _ = JR.param_pspecs(jcfg, jp, jm, **kw)
    tspecs, _ = TR.param_pspecs(tcfg, tp, tm, **kw)
    for shape in SHAPES.values():
        tin, jin = TC.input_specs(tcfg, shape), JC.input_specs(jcfg, shape)
        if shape.kind == "train":
            jtrees = (jstate, jin)
            jst = JS.TrainState(params=jspecs, opt=JR.opt_pspecs(
                jspecs, jstate.opt), residual=None)
            jspec_trees = (jst, JR.batch_pspecs(jcfg, jin, jm))
            ttrees = (tstate, tin)
            tst = TS.TrainState(params=tspecs, opt=TR.opt_pspecs(
                tspecs, tstate.opt), residual=None)
            tspec_trees = (tst, TR.batch_pspecs(tcfg, tin, tm))
        elif shape.kind == "prefill":
            jtrees, ttrees = (jp, jin), (tp, tin)
            jspec_trees = (jspecs, JR.batch_pspecs(jcfg, jin, jm))
            tspec_trees = (tspecs, TR.batch_pspecs(tcfg, tin, tm))
        else:
            jtrees, ttrees = (jp, jin["cache"]), (tp, tin["cache"])
            jspec_trees = (jspecs, JR.cache_pspecs(jcfg, jin["cache"], jm))
            tspec_trees = (tspecs, TR.cache_pspecs(tcfg, tin["cache"], tm))
        want = jd._arg_bytes_per_device(jm, jtrees, jspec_trees)
        assert TD._arg_bytes_per_device(tm, ttrees, tspec_trees) == want
        assert want > 0


@pytest.mark.parametrize("arch,mesh", CASES)
def test_placements_agree_with_the_specs(arch, mesh):
    """Every param spec's DTensor placements shard each named tensor dim
    over exactly its mesh axes, in the spec's order, and replicate over the
    rest."""
    from torch.distributed.tensor import Replicate
    tcfg, _, tp, _, _, _ = abstract(arch)
    _, tm = meshes(mesh)
    specs, _ = TR.param_pspecs(tcfg, tp, tm, **RULE_KW.get(mesh, {}))
    for _, spec in leaves_with_path(specs):
        pl = TR.to_placements(spec, tm)
        assert len(pl) == len(tm.axis_names)
        for d, entry in enumerate(spec):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            on = [tm.axis_names[i] for i, p in enumerate(pl)
                  if p.is_shard(d)]
            assert on == list(names)
        named = {a for e in spec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)}
        for i, p in enumerate(pl):
            assert isinstance(p, Replicate) == (tm.axis_names[i] not in named)


def test_to_placements_refuses_what_dtensor_cannot_place():
    from torch.distributed.tensor import Replicate, Shard
    m = TR.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert TR.to_placements(TR.P(("pod", "data"), None, "model"), m) == \
        (Shard(0), Shard(0), Shard(2))
    assert TR.to_placements(TR.P(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        TR.to_placements(TR.P(("model", "data")), m)
    with pytest.raises(ValueError, match="named twice"):
        TR.to_placements(TR.P("data", "data"), m)
    with pytest.raises(ValueError, match="no axis"):
        TR.to_placements(TR.P("expert"), m)


def test_specs_normalise_as_partition_specs_do():
    assert tuple(TR.P(("data",), None, ("expert", "tp"))) == \
        tuple(JP(("data",), None, ("expert", "tp")))
    assert TR.P(("data",)) == TR.P("data") == ("data",)
    assert len(TR.P(None, "model")) == 2
