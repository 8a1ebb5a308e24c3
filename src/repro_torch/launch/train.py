"""End-to-end training driver THROUGH the graph engine.

PyTorch counterpart of ``repro/launch/train.py``, on the port's own copy
of the engine (``repro_torch.core``) and its own app registry.  The
training run is a DALiuGE logical graph, exactly as the paper runs
astronomy pipelines:

  state[0] (root Data Drop: init or checkpoint-restored TrainState)
  Loop(supersteps):
      Scatter(shards): load_batch  -> batch-shard Data Drops   (data pipeline)
      train_app(state[t], batches) -> state[t+1] + metrics     (torch step)
      every k-th iteration the metrics drop feeds a checkpoint app

Loop-carried state uses the paper's "new Data Drops per iteration", so a
run holds one TrainState per iteration (no donation inside the engine, as
in the reference).  On CUDA the step runs as one captured CUDA graph
(``train.steps.TrainGraph``, the counterpart of the reference's jitted
step), its attention on the training attention kernels (forward and
backward) and its update on the optimizer kernels, the counterparts of
what XLA fuses in the reference's jitted step (which trains with
``use_kernel=False``, as the port does).

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 8
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpointing import CheckpointManager
from ..configs import get_smoke_config
from ..core import EngineConfig, Pipeline, register_app
from ..data import synthetic_batch
from ..dsl import GraphBuilder
from ..models.common import ArchConfig, resolve_device
from ..train import make_train_step, train_state_init

PRESETS: Dict[str, ArchConfig] = {
    # ~100M-class decoder.  Embeddings tied and vocab sized to the
    # few-hundred-step token budget (untied 32k vocab needs ~100x more
    # tokens before per-id rows align).
    "lm100m": ArchConfig(
        name="lm100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072,
        vocab_size=2048, tie_embeddings=True, activation="swiglu",
        dtype="float32", rope_theta=10000.0),
    # ~20M: a few hundred steps in minutes on a CPU
    "lm20m": ArchConfig(
        name="lm20m", family="dense", num_layers=6, d_model=384,
        num_heads=6, num_kv_heads=6, head_dim=64, d_ff=1536,
        vocab_size=512, tie_embeddings=True, activation="swiglu",
        dtype="float32"),
    # seconds-scale smoke
    "tiny": dataclasses.replace(get_smoke_config("codeqwen15_7b"),
                                name="tiny"),
}


def build_training_graph(steps: int, shards: int, ckpt_every: int):
    g = GraphBuilder("train")
    g.data("state0")
    g.component("seed", app="identity")
    with g.loop("steps", steps):
        g.data("state", loop_entry=True)
        with g.scatter("shard", shards):
            g.component("load", app="train/load_batch", time=0.01)
            g.data("batch")
        with g.gather("collect", shards):
            g.component("step", app="train/step", time=1.0)
        g.data("state_next", loop_exit=True, carries="state")
        g.connect("state", "step")
        g.chain("load", "batch", "step", "state_next")
        if ckpt_every:
            g.component("maybe_ckpt", app="train/checkpoint", time=0.05)
            g.data("ckpt_marker", payload="null")
            g.chain("state_next", "maybe_ckpt", "ckpt_marker")
    g.component("final", app="identity")
    g.data("state_final")
    g.chain("state0", "seed", "state")
    g.chain("state_next", "final", "state_final")
    return g.graph()


def run_training(cfg: ArchConfig, *, steps: int = 40, shards: int = 2,
                 batch_per_shard: int = 4, seq: int = 128,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
                 resume: bool = False, peak_lr: float = 1e-3,
                 num_nodes: int = 2, log_every: int = 10,
                 device: Any = "cuda", graph: Optional[bool] = None
                 ) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` supersteps through the engine on
    ``device`` (CUDA unless asked for the CPU; raises without it), the
    step through a CUDA graph on CUDA (``graph``: ``make_train_step``'s;
    ``False`` runs it eagerly).

    The state starts from a seeded init (generator seed 0 on ``device``)
    or, with ``resume``, from the latest checkpoint in ``ckpt_dir``; batch
    ``it`` of shard ``s`` is ``synthetic_batch(17, s, start + it, ...)``,
    as in the reference.  The result adds ``start_step`` and the
    ``final_state`` to the reference's keys."""
    dev = resolve_device(device)
    # NO donation here: the state payload is a write-once Drop that the
    # checkpoint app may still be snapshotting when the next iteration's
    # step runs (donation would change it under the reader's feet).  The
    # graph keeps its own state: each replay copies the input state in and
    # returns fresh tensors.
    train_step = make_train_step(
        cfg, peak_lr=peak_lr, warmup_steps=max(steps // 10, 1),
        total_steps=steps, remat=False, graph=graph)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    losses: list = []

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state0 = train_state_init(cfg, gen, device=dev)
    start_step = 0
    if mgr and resume:
        got = mgr.restore_latest(state0)
        if got is not None:
            start_step, state0 = got
            print(f"[train] resumed from step {start_step}")

    @register_app("train/load_batch")
    def load_batch(inputs, outputs, app):
        (it, shard) = app.meta["oid"]      # (loop index, shard index)
        b = synthetic_batch(17, shard, start_step + it, batch_per_shard,
                            seq, cfg.vocab_size)
        for o in outputs:
            o.write(b)

    @register_app("train/step")
    def step_app(inputs, outputs, app):
        state = None
        shards_np = []
        for i in inputs:
            v = i.read()
            if isinstance(v, dict) and "tokens" in v:
                shards_np.append(v)
            elif isinstance(v, tuple) and len(v) == 2:
                state = v[0]               # loop-carried (state, step)
            else:
                state = v                  # initial raw TrainState
        assert state is not None and shards_np
        batch = {k: torch.from_numpy(np.concatenate([b[k] for b in
                                                     shards_np])).to(dev)
                 for k in shards_np[0]}
        new_state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        it = app.meta["oid"][0]
        if log_every and (it % log_every == 0 or it == steps - 1):
            print(f"[train] step {start_step + it:5d} "
                  f"loss {loss:.4f} lr {float(metrics['lr']):.2e}",
                  flush=True)
        for o in outputs:
            if o.uid.startswith("state_next"):
                o.write((new_state, int(metrics["step"])))
            else:
                o.write(None)

    @register_app("train/checkpoint")
    def ckpt_app(inputs, outputs, app):
        it = app.meta["oid"][0]
        if mgr and ckpt_every and ((it + 1) % ckpt_every == 0
                                   or it == steps - 1):
            state, opt_step = inputs[0].read()
            mgr.save_async(opt_step, state)
        for o in outputs:
            o.write(None)

    # the loop-carried drop holds (state, step); the step app must accept
    # both the initial raw state and the tuple form:
    @register_app("identity")  # re-register: unwrap tuples gracefully
    def identity(inputs, outputs, app):
        vals = [i.read() for i in inputs]
        v = vals[0] if len(vals) == 1 else vals
        for o in outputs:
            o.write(v)

    lg = build_training_graph(steps, shards, ckpt_every if mgr else 0)
    with Pipeline(EngineConfig(num_nodes=num_nodes, workers_per_node=2,
                               dop=4)) as p:
        pgt = p.translate(lg)
        p.deploy()
        t0 = time.monotonic()
        rep = p.execute(inputs={"state0": state0}, timeout=24 * 3600)
        wall = time.monotonic() - t0
        if not rep.ok:
            raise RuntimeError(f"train graph failed: {rep.errors[:3]}")
        final_state, final_step = p.session.drops["state_final"].read()
    train_step.close()
    if mgr:
        mgr.wait()
    tokens = steps * shards * batch_per_shard * seq
    result = {
        "steps": steps, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "losses": losses, "drops": len(pgt),
        "start_step": start_step, "final_step": final_step,
        "final_state": final_state,
    }
    print(f"[train] {steps} steps in {wall:.1f}s "
          f"({result['tokens_per_s']:.0f} tok/s); "
          f"loss {result['first_loss']:.3f} -> {result['last_loss']:.3f}")
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--batch-per-shard", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda raises if CUDA is "
                         "missing; pass cpu to run on the CPU)")
    args = ap.parse_args()
    cfg = PRESETS[args.preset]
    run_training(cfg, steps=args.steps, shards=args.shards,
                 batch_per_shard=args.batch_per_shard, seq=args.seq,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 resume=args.resume, peak_lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
