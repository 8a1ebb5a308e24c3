"""Multi-pod dry-run of the PyTorch port.

PyTorch counterpart of ``repro/launch/dryrun.py``.  For every (architecture
x input-shape x mesh) cell it builds the cell's state, batch and cache as
meta DTensors laid out by the sharding rules on a mesh over a fake process
group of 256 (or 512) ranks, runs the step on them, and records what it
counted -> JSON under ``results/dryrun_torch/``.  Nothing is allocated and
no device is needed: meta tensors carry shapes only, and the fake group's
collectives move no data.

Where the reference lowers and compiles the step with XLA, the port traces
it: the step runs op by op on the DTensors.  The FLOPs come from
``FlopCounterMode`` (global), bytes accessed, collective bytes and the peak
of live temporaries from ``roofline.StepCounter`` (per device, rank 0's
shards).  Not ported: XLA's compile, which proves a sharded program
coherent, and what only it reports (code size, compile time); and the HLO
parse of collective bytes (the counter reads the c10d collectives instead).

Two passes per cell, as the reference's:
  * production pass: the step at full depth (train: ``NUM_MICROBATCHES``
    microbatches) -> the arguments and the peak of live temporaries per
    device;
  * cost pass: one microbatch (train totals scaled by the microbatch count)
    at L1 and L2 layers -> FLOPs, bytes accessed, collective bytes,
    extrapolated to the full depth as the reference extrapolates,
    cost(L) = cost(L1) + (L-L1)*(cost(L2)-cost(L1))/(L2-L1).
    The layers are identical, so FLOPs and collective bytes are linear in
    depth and extrapolate exactly.  Bytes accessed extrapolate to within a
    few tenths of a percent: DTensor lays out the stacked (L, ...) grads
    and moments by whether the ranks divide L.

Usage:
  python -m repro_torch.launch.dryrun --arch grok_1_314b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import (ARCH_NAMES, abstract_params, cell_supported,
                       eval_shape, get_config, input_specs)
from ..models import model as M
from ..models.common import SHAPES, ArchConfig, ShapeConfig
from ..roofline import StepCounter, model_flops, roofline_terms
from ..sharding import (AbstractMesh, P, abstract_mesh, batch_pspecs,
                        cache_pspecs, opt_pspecs, param_pspecs, to_placements,
                        zero_opt_pspecs)
from ..sharding.rules import replicated_pspecs
from ..train.steps import TrainState, make_train_step, train_state_init
from ..tree import leaves, tree_map
from .mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16, PRODUCTION_SHAPES,
                   fake_process_group, make_mesh)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

NUM_MICROBATCHES = 8   # train_4k: 256-batch -> 8 x 32 (bounds logits memory)


def _arg_bytes_per_device(mesh, abstract_trees, spec_trees) -> int:
    """Analytic per-device bytes of the inputs under their specs: a
    replicated leaf counts once per device."""
    shape = abstract_mesh(mesh).shape
    total = 0
    for abs_t, spec_t in zip(abstract_trees, spec_trees):
        for leaf, spec in zip(leaves(abs_t), leaves(spec_t)):
            shards = 1
            for entry in (spec or ()):
                if entry is None:
                    continue
                names = entry if isinstance(entry, tuple) else (entry,)
                for a in names:
                    shards *= shape.get(a, 1)
            nbytes = leaf.element_size()
            for d in leaf.shape:
                nbytes *= d
            total += nbytes // max(shards, 1)
    return total


@dataclasses.dataclass
class Variant:
    """A hillclimbing variant: sharding profile + config tweaks."""

    name: str = "baseline"
    profile_name: str = "baseline"
    replicate_params: bool = False     # dp_all: replicate params, ZeRO opt
    batch_axes: Any = None             # e.g. ("data", "model") for dp_all
    derived_mesh: bool = False         # ep: reshape to (data, expert, tp)
    cfg_overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    remat: bool = True
    num_microbatches: Optional[int] = None


def make_variant(spec: str) -> Variant:
    v = Variant(name=spec)
    for part in spec.split("+"):
        if part in ("", "baseline"):
            continue
        if part == "dp_all":
            v.profile_name = "dp_all"
            v.replicate_params = True
            v.batch_axes = ("data", "model")
        elif part == "sp":
            v.profile_name = "sp"
        elif part == "ep":
            v.profile_name = "ep"
            v.derived_mesh = True
        elif part.startswith("chunk"):
            v.cfg_overrides["ssm_chunk"] = int(part[5:])
        elif part == "noremat":
            v.remat = False
        elif part.startswith("nm"):
            v.num_microbatches = int(part[2:])
        elif part == "pin":
            pass   # moe-buffer pinning (behaviour lives in sharding/ctx)
        elif part.startswith("cf"):
            v.cfg_overrides["capacity_factor"] = float(part[2:])
        else:
            raise ValueError(f"unknown variant part {part!r}")
    return v


def variant_mesh(mesh, variant: Variant):
    """The mesh the variant runs on: ``ep`` views the (data, model) ranks
    as (data, expert, tp) = (d0, 8, d1 // 8).  Takes and returns a
    ``DeviceMesh``, or an ``AbstractMesh``."""
    if not variant.derived_mesh:
        return mesh
    axes = abstract_mesh(mesh)
    if len(axes.axis_sizes) == 2:    # (data, model) -> (data, expert, tp)
        d0, d1 = axes.axis_sizes
        assert d1 % 8 == 0
        shape, names = (d0, 8, d1 // 8), ("data", "expert", "tp")
        if isinstance(mesh, AbstractMesh):
            return AbstractMesh(shape, names)
        return make_mesh(shape, names)
    raise ValueError("ep variant is single-pod only (the roofline mesh)")


def _profile_for(variant: Variant, mesh):
    from ..sharding.ctx import ShardProfile
    if variant.profile_name == "baseline":
        return None
    names = abstract_mesh(mesh).axis_names
    if variant.profile_name == "ep":
        return ShardProfile(name="ep", mesh=mesh, data_axes=("data",),
                            tp_axes=("expert", "tp"), expert_axis="expert")
    return ShardProfile(name=variant.profile_name, mesh=mesh,
                        data_axes=tuple(a for a in ("pod", "data")
                                        if a in names),
                        tp_axes=("model",))


# ---------------------------------------------------------------------------
# Meta DTensors from fake shapes
# ---------------------------------------------------------------------------


def _meta_dtensor(leaf: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """A meta DTensor with ``leaf``'s global shape and dtype, laid out on
    ``mesh`` by ``spec`` (rank 0's shard; the rules shard only dims that
    divide)."""
    from torch.distributed.tensor import DTensor
    placements = to_placements(spec, mesh)
    local = list(leaf.shape)
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(i)
            if local[pl.dim] % n:
                raise ValueError(f"{spec}: dim {pl.dim} of {tuple(leaf.shape)}"
                                 f" does not split {n} ways")
            local[pl.dim] //= n
    t = torch.empty(local, dtype=leaf.dtype, device="meta")
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=leaf.shape,
                              stride=torch.empty(leaf.shape,
                                                 device="meta").stride())


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree``'s fake leaves as meta DTensors laid out by ``specs``."""
    return tree_map(lambda leaf, spec: _meta_dtensor(leaf, spec, mesh),
                    tree, specs)


class ShardViews(TorchDispatchMode):
    """Takes a view of a local shard that the shard's layout does not
    allow from a contiguous copy of the shard.

    DTensor plans a view on the global strides, but a redistribution
    leaves each rank a contiguous shard whatever those strides say; a
    later view that the global layout allows can then fail on the shard
    (the MoE experts' einsums, whose gradients come back through a
    reduce-scatter).  The tensors are meta, so the copy moves nothing; the
    counters above this mode count the op as the view the program asked
    for."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if func is torch.ops.aten.view.default:
            try:
                return func(*args, **kwargs)
            except RuntimeError as err:
                if "view size is not compatible" not in str(err):
                    raise
                return func(args[0].contiguous(), *args[1:], **kwargs)
        return func(*args, **kwargs)


_REFUSED = re.compile(r"unevenly sharded tensor|is invalid for input of "
                      r"size|view size is not compatible|flatten multiple "
                      r"dimensions|without redistribution|must be "
                      r"normalized")
_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
_ARG_REDUCTIONS = (torch.ops.aten.argmax.default,
                   torch.ops.aten.argmin.default)
_MESH_DIM = re.compile(r"mesh dimension (\d+)")
_TENSOR_DIM = re.compile(r"dimension (\d+) being sharded")


class Reshard(TorchDispatchMode):
    """Reshards the arguments of a DTensor op that DTensor refuses, and
    runs the op again.

    DTensor's sharding propagation may shard an intermediate unevenly (20
    whisper heads over 16 ranks) or split a sharded dim into one that the
    ranks do not divide (grok's 48 query heads into 8 groups of 6), and
    then refuses a view of it, or takes a local view of the wrong size.
    Some releases also make a placement they then refuse (torch 2.11's
    ``Shard(-1)`` in the embedding's backward).  GSPMD reshards such a
    tensor; so does this mode: the shards on the mesh dim or the tensor
    dim that the error names, else for an argmax the shards of the dim it
    reduces (a vocab-parallel row of logits), else every uneven shard,
    else for a view
    the innermost mesh dim that shards its input, one per retry (a split
    of a dim sharded over more ranks than divide its outer part: GSPMD
    keeps the outer mesh dims), else (rule ``"all"``) every shard of the
    op's DTensor arguments become ``Replicate``.  Which refusals match
    depends on the wording of torch's errors, so every reshard is noted
    with its rule (``record``); ``run_cell`` lists them in the record
    with its torch release, and ends a cell ``error`` where the ``"all"``
    rule ran, whose counts would then follow this mode rather than the
    sharding rules.  The mode runs above the counters, which count the
    collectives of the reshard and the op that then runs (a refused
    attempt may have counted a redistribution of its inputs first)."""

    def __init__(self):
        super().__init__()
        self.reshards: Dict[tuple, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for _ in range(4):
            try:
                return func(*args, **kwargs)
            except RuntimeError as err:
                if not _REFUSED.search(str(err)):
                    raise
                new = self._replicated(func, args, str(err))
                if new is None:
                    raise
                args = new
        return func(*args, **kwargs)

    def _replicated(self, func, args, error: str) -> Optional[tuple]:
        """``args`` with the refused shards of their DTensors replicated,
        or None where no shard is left to replicate.  The shards refused
        are those on the mesh dim or the tensor dim that ``error`` names,
        else for an argmax those of the reduced dim, else the uneven ones,
        else for a view the innermost, else all."""
        from torch.distributed.tensor import DTensor, Replicate
        mesh_dim = _MESH_DIM.search(error)
        tensor_dim = _TENSOR_DIM.search(error)

        def named(t, i, p):
            return p.is_shard() and (
                (mesh_dim is not None and i == int(mesh_dim.group(1)))
                or (tensor_dim is not None
                    and p.dim == int(tensor_dim.group(1))))

        def uneven(t, i, p):
            return p.is_shard() and t.shape[p.dim] % t.device_mesh.size(i)

        def innermost(t, i, p):
            return p.is_shard() and not any(
                q.is_shard() for q in t.placements[i + 1:])

        def every(t, i, p):
            return p.is_shard()

        def reduced(t, i, p):
            return p.is_shard() and p.dim == args[1] % t.ndim

        rules = [("named", named)]
        if func in _ARG_REDUCTIONS and len(args) > 1 and args[1] is not None:
            rules.append(("reduced", reduced))
        rules.append(("uneven", uneven))
        if func in _VIEWS:
            rules.append(("split", innermost))
        for rule, pick in (*rules, ("all", every)):
            changed = []

            def fix(a):
                if isinstance(a, (list, tuple)):
                    return type(a)(fix(x) for x in a)
                if isinstance(a, DTensor) and any(
                        pick(a, i, p) for i, p in enumerate(a.placements)):
                    r = a.redistribute(a.device_mesh, [
                        Replicate() if pick(a, i, p) else p
                        for i, p in enumerate(a.placements)])
                    changed.append((a, r))
                    return r
                return a
            out = fix(tuple(args))
            for a, r in changed:
                local = r.to_local()
                key = (str(func), rule, tuple(a.shape), str(a.dtype),
                       tuple(map(str, a.placements)),
                       tuple(map(str, r.placements)),
                       local.numel() * local.element_size())
                self.reshards[key] = self.reshards.get(key, 0) + 1
            if changed:
                return out
        return None

    def record(self) -> list:
        """The reshards made, one entry per distinct (op, rule, tensor,
        placements) with how often it ran and the bytes a rank holds
        after it."""
        return [{"op": op, "rule": rule, "shape": list(shape),
                 "dtype": dtype, "before": list(before),
                 "after": list(after), "bytes_per_device": nbytes,
                 "count": count}
                for (op, rule, shape, dtype, before, after, nbytes), count
                in sorted(self.reshards.items())]


# ---------------------------------------------------------------------------
# Tracing a cell
# ---------------------------------------------------------------------------


def plan_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
              cost_pass: bool = False,
              variant: Optional[Variant] = None) -> Dict[str, Any]:
    """The cell's inputs as fake trees and their specs on ``mesh`` (a
    ``DeviceMesh`` or an ``AbstractMesh``), with the decisions, the
    microbatching and the analytic argument bytes per device; no DTensor
    is made.

    Train: ``state`` and ``batch`` (the cost pass: one microbatch, whose
    totals ``cost_scale`` scales).  Prefill: ``params``, ``batch`` and the
    ``cache`` the step fills (an output, not an argument).  Decode:
    ``params``, ``cache`` and ``tokens``."""
    variant = variant or Variant()
    cfg = dataclasses.replace(cfg, **variant.cfg_overrides) \
        if variant.cfg_overrides else cfg
    mesh = variant_mesh(mesh, variant)
    decisions: list = []
    params_abs = abstract_params(cfg)
    if variant.replicate_params:
        pspecs = replicated_pspecs(params_abs)
        decisions = ["dp_all: params replicated; opt ZeRO-sharded"]
    elif variant.profile_name == "ep":
        pspecs, decisions = param_pspecs(cfg, params_abs, mesh,
                                         tp=("expert", "tp"),
                                         expert_axis="expert")
    else:
        pspecs, decisions = param_pspecs(cfg, params_abs, mesh)

    plan: Dict[str, Any] = {"cfg": cfg, "mesh": mesh, "variant": variant,
                            "decisions": decisions, "cost_scale": 1}
    trees: Dict[str, Any] = {}
    if shape.kind == "train":
        nm = variant.num_microbatches or NUM_MICROBATCHES
        if shape.global_batch % nm:
            nm = 1
        state_abs = eval_shape(lambda: train_state_init(cfg, device="cpu"))
        if variant.replicate_params:
            ospecs = zero_opt_pspecs(state_abs.opt, mesh)
        else:
            ospecs = opt_pspecs(pspecs, state_abs.opt)
        batch_abs = input_specs(cfg, shape)
        plan["num_microbatches"] = nm
        if cost_pass:
            # one microbatch, costs scaled by nm afterwards
            batch_abs = eval_shape(lambda: {
                k: torch.empty((v.shape[0] // nm, *v.shape[1:]),
                               dtype=v.dtype) for k, v in batch_abs.items()})
            plan["cost_scale"] = nm
        plan["step_microbatches"] = 1 if cost_pass else nm
        trees["state"] = (state_abs, TrainState(params=pspecs, opt=ospecs,
                                                residual=None))
        trees["batch"] = (batch_abs, batch_pspecs(
            cfg, batch_abs, mesh, batch_axes=variant.batch_axes))
        args = ("state", "batch")
    elif shape.kind == "prefill":
        batch_abs = input_specs(cfg, shape)
        cache_abs = input_specs(cfg, dataclasses.replace(
            shape, kind="decode"))["cache"]
        trees["params"] = (params_abs, pspecs)
        trees["batch"] = (batch_abs, batch_pspecs(
            cfg, batch_abs, mesh, batch_axes=variant.batch_axes))
        trees["cache"] = (cache_abs, cache_pspecs(cfg, cache_abs, mesh))
        args = ("params", "batch")
    else:
        specs = input_specs(cfg, shape)
        cache_abs = specs["cache"]
        trees["params"] = (params_abs, pspecs)
        trees["cache"] = (cache_abs, cache_pspecs(cfg, cache_abs, mesh))
        trees["tokens"] = (specs["tokens"], batch_pspecs(
            cfg, {"tokens": specs["tokens"]}, mesh,
            batch_axes=variant.batch_axes)["tokens"])
        args = ("params", "cache")
    plan["trees"] = trees
    plan["arg_bytes_per_device"] = _arg_bytes_per_device(
        mesh, tuple(trees[a][0] for a in args),
        tuple(trees[a][1] for a in args))
    return plan


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, *,
               cost_pass: bool = False,
               variant: Optional[Variant] = None) -> Dict[str, Any]:
    """Run the cell's step on meta DTensors laid out by ``plan_cell`` on
    ``mesh`` (a ``DeviceMesh`` over a fake group) under the counters, and
    return the plan's decisions, microbatching and argument bytes with
    what the counters counted: ``flops`` (global), ``bytes_accessed``,
    ``collectives`` and ``peak_live_bytes`` (per device), and the
    ``reshards`` that ``Reshard`` made.

    Two flavours, as the reference's two lowerings: the production pass
    (default; train runs its microbatches) and the cost pass (a single
    microbatch; ``cost_scale`` scales train totals).  The train step
    donates its state (``donate=True``), as the reference donates; prefill
    and decode run ``M.prefill`` / ``M.decode_step`` under
    ``torch.no_grad()`` (the serve steps' ``inference_mode`` does not take
    DTensors) with the serve steps' argmax; prefill fills a cache laid out
    by ``cache_pspecs`` and allocated inside the trace (the reference's
    step returns it); decode writes one token at the cache's last slot
    (its attention reads the whole cache at any position)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from ..sharding.ctx import use_profile

    plan = plan_cell(cfg, shape, mesh, cost_pass=cost_pass, variant=variant)
    cfg, mesh, variant = plan["cfg"], plan["mesh"], plan["variant"]
    trees = plan["trees"]

    def make(name):
        return distribute(*trees[name], mesh)

    def next_token(logits):
        return torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)

    run: Callable[[], Any]
    if shape.kind == "train":
        step = make_train_step(cfg, num_microbatches=plan["step_microbatches"],
                               remat=variant.remat, donate=True)
        state, batch = make("state"), make("batch")
        run = lambda: step(state, batch)  # noqa: E731
    elif shape.kind == "prefill":
        params, batch = make("params"), make("batch")

        def run():
            with torch.no_grad():
                logits, cache = M.prefill(params, cfg, batch,
                                          cache=make("cache"))
                return next_token(logits), cache
    else:
        params, cache = make("params"), make("cache")
        tokens = _meta_dtensor(*trees["tokens"], mesh)
        pos = shape.seq_len - 1

        def run():
            with torch.no_grad():
                logits, new = M.decode_step(params, cfg, cache, tokens, pos)
                return next_token(logits), new

    counter, reshard = StepCounter(), Reshard()
    # the FLOP counter is entered last, on top of the mode stack: it sees
    # the DTensor ops (global), the step counter their local ops
    with implicit_replication(), use_profile(_profile_for(variant, mesh)), \
            ShardViews(), counter, FlopCounterMode(display=False) as flops, \
            reshard:
        run()
    out = {k: plan[k] for k in ("decisions", "cost_scale",
                                "arg_bytes_per_device", "num_microbatches")
           if k in plan}
    out.update(flops=float(flops.get_total_flops()),
               bytes_accessed=float(counter.bytes_accessed),
               collectives=counter.collective_bytes(),
               peak_live_bytes=counter.peak_live_bytes,
               reshards=reshard.record())
    return out


def depths(cfg: ArchConfig):
    """The two depths each pass is traced at."""
    per = max(cfg.shared_attn_period, 1)
    return (per, 2 * per) if cfg.family == "hybrid" else (2, 4)


def at_depth(cfg: ArchConfig, L: int) -> ArchConfig:
    kw: Dict[str, Any] = {"num_layers": L}
    if cfg.family == "encdec":
        kw["num_encoder_layers"] = L
    return dataclasses.replace(cfg, **kw)


def extrapolate(cfg: ArchConfig, measure: Callable[[ArchConfig], Dict],
                ) -> Dict[str, float]:
    """``measure`` at the two depths, each count extrapolated linearly to
    ``cfg``'s depth."""
    L1, L2 = depths(cfg)
    m1, m2 = measure(at_depth(cfg, L1)), measure(at_depth(cfg, L2))
    L = cfg.num_layers
    return {k: m1[k] + (L - L1) * (m2[k] - m1[k]) / (L2 - L1) for k in m1}


def costs(cfg: ArchConfig, shape: ShapeConfig, mesh, variant: Variant
          ) -> Dict[str, float]:
    """The cost pass at the two depths, extrapolated: flops,
    bytes_accessed (per device) and ``coll_<kind>`` bytes (per device),
    train totals scaled by the microbatch count."""
    def measure(c: ArchConfig) -> Dict[str, float]:
        m = trace_cell(c, shape, mesh, cost_pass=True, variant=variant)
        scale = m["cost_scale"]
        out = {"flops": m["flops"] * scale,
               "bytes_accessed": m["bytes_accessed"] * scale}
        for k, v in m["collectives"].items():
            out[f"coll_{k}"] = float(v) * scale
        return out
    return extrapolate(cfg, measure)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = RESULTS_DIR, verbose: bool = True,
             variant: str = "baseline", *, cfg: Optional[ArchConfig] = None,
             mesh_axes: Optional[AbstractMesh] = None) -> Dict[str, Any]:
    """Trace one cell on the production mesh (or ``mesh_axes``) and write
    its record.  ``cfg`` replaces ``get_config(arch)`` (a smoke config in
    the tests).  A failure is recorded with its traceback, not raised."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name]
    var = make_variant(variant)
    mesh_name = "multi" if multi_pod else "single"
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "variant": variant,
        "family": cfg.family, "kind": shape.kind,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "torch": torch.__version__,
    }
    skip = cell_supported(cfg, shape)
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
    if skip:
        rec["status"] = "skipped"
        rec["skip_reason"] = skip
        out_path.write_text(json.dumps(rec, indent=1))
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name} x {mesh_name}: "
                  f"{skip}", flush=True)
        return rec

    axes = mesh_axes or AbstractMesh(*PRODUCTION_SHAPES[multi_pod])
    chips = axes.size
    rec["chips"] = chips
    try:
        with fake_process_group(chips):
            mesh = make_mesh(axes.axis_sizes, axes.axis_names)
            # ---- pass 1: production program (microbatches) -> memory -----
            t0 = time.monotonic()
            prod = trace_cell(cfg, shape, mesh, variant=var)
            rec["trace_s"] = round(time.monotonic() - t0, 2)
            for k in ("num_microbatches", "decisions",
                      "arg_bytes_per_device", "reshards"):
                if k in prod:
                    rec[k] = prod[k]
            args, peak = prod["arg_bytes_per_device"], prod["peak_live_bytes"]
            # the cost pass runs the same ops at less depth, so these
            # reshards are also its
            last = [r["op"] for r in prod["reshards"] if r["rule"] == "all"]
            if last:
                raise RuntimeError(
                    f"DTensor refused {', '.join(sorted(set(last)))}: only "
                    f"replicating every shard of the arguments ran it (see "
                    f"the record's reshards)")
            rec["memory"] = {"arg_bytes_per_device": int(args),
                             "peak_temp_bytes_per_device": int(peak),
                             "per_device_bytes": int(args + peak)}

            # ---- pass 2: cost program (single microbatch) ----------------
            t2 = time.monotonic()
            ex = costs(cfg, shape, mesh, var)
        rec["cost_pass_s"] = round(time.monotonic() - t2, 2)
        flops = ex["flops"]
        bytes_accessed = ex["bytes_accessed"]
        L1, L2 = depths(cfg)
        rec["cost"] = {"flops": flops, "bytes_accessed": bytes_accessed,
                       "extrapolated_from": [L1, L2]}
        coll = {k[5:]: v for k, v in ex.items() if k.startswith("coll_")}
        rec["collectives"] = coll

        # the FLOP count is global; bytes and collective bytes are per
        # device: make them global
        global_bytes = bytes_accessed * chips
        coll_global = coll["total"] * chips
        terms = roofline_terms(flops, global_bytes, coll_global, chips,
                               PEAK_FLOPS_BF16, HBM_BW, LINK_BW)
        mf = model_flops(cfg, shape)
        terms["model_flops"] = mf
        terms["useful_fraction"] = (mf / flops) if flops else 0.0
        rec["roofline"] = terms
        if var.profile_name == "ep":
            # the "cpu" mesh has no all-to-all: DTensor all-gathers and
            # chunks instead, and the counter counts the all-gathers
            rec["notes"] = ["collective_s is not valid for ep: each "
                            "all-to-all is counted as the all-gather that "
                            "stands in for it on the host's mesh"]
        rec["status"] = "ok"
    except Exception as exc:  # noqa: BLE001 - record the failure, keep going
        rec["status"] = "error"
        rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["traceback"] = traceback.format_exc(limit=10)
    out_path.write_text(json.dumps(rec, indent=1))
    if verbose:
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" dom={r['dominant']} "
                     f"frac={r['roofline_fraction']:.3f} "
                     f"trace={rec['trace_s']}s cost={rec['cost_pass_s']}s")
        print(f"[dryrun] {status.upper():7s} {arch} x {shape_name} x "
              f"{mesh_name}{extra}", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help="hillclimb variant, e.g. dp_all, sp, ep, "
                         "dp_all+chunk128")
    args = ap.parse_args()

    out_dir = Path(args.out)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = []
    archs = ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    for a in archs:
        for s in shapes:
            for m in meshes:
                cells.append((a, s, m))
    print(f"[dryrun] {len(cells)} cells", flush=True)
    t0 = time.monotonic()
    for a, s, m in cells:
        mesh_name = "multi" if m else "single"
        sfx = "" if args.variant == "baseline" else f"__{args.variant}"
        p = out_dir / f"{a}__{s}__{mesh_name}{sfx}.json"
        if args.skip_existing and p.exists():
            try:
                if json.loads(p.read_text()).get("status") in ("ok",
                                                               "skipped"):
                    print(f"[dryrun] cached  {a} x {s} x {mesh_name}",
                          flush=True)
                    continue
            except (OSError, ValueError):
                pass
        run_cell(a, s, m, out_dir, variant=args.variant)
    print(f"[dryrun] done in {time.monotonic() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
