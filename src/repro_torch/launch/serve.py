"""Batched serving driver through the graph engine (MUSER analogue, §6).

PyTorch counterpart of ``repro/launch/serve.py``, on the port's own copy
of the engine (``repro_torch.core``).  Requests stream in like MUSER's
correlator frames: the logical graph Scatters a request batch into
micro-batches, each micro-batch flows through prefill -> decode Drops, and
a Gather assembles responses.  InMemory Drops carry the caches (device
tensors: KV, SSM, or both for the hybrid) between prefill and decode.

With ``--sessions N`` the same graph shape is served N times through a
resident :class:`~repro_torch.core.manager.EngineManager`: the first
session pays translate+map, every later one is a template-cache hit.

It serves every family (dense, vlm, moe, ssm, hybrid, encdec).  On CUDA,
prefill self-attention (the whisper encoder's too) runs the hand-written
flash-attention kernel and the Mamba2 layers' prefill scan the
hand-written SSD kernel; decode, cross-attention, the MoE dispatch and
the projections are torch ops.  encdec prompts come with f32 zero frames
of ``max(prompt_len // encoder_ratio, 1)`` rows, as the reference serve
makes them.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --sessions 4
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs import get_smoke_config
from ..core import (EngineConfig, EngineManager, Pipeline, TelemetryConfig,
                    register_app)
from ..dsl import GraphBuilder
from ..models import model as M
from ..models.common import ArchConfig, resolve_device
from ..train import make_decode_step, make_prefill_step


def _dump_stats(path: str, payload: Dict[str, Any]) -> None:
    """Write the observability dump (--stats-json): the MetricsRegistry
    snapshot plus whatever serving stats the caller collected."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as fh:
        json.dump(payload, fh, indent=2, default=repr)
    print(f"[serve] stats written to {p}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_batch(cfg: ArchConfig,
                 tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The prefill batch of a (B, S) prompt chunk: its tokens and, for
    encdec, f32 zero frames of max(S // encoder_ratio, 1) rows on the
    tokens' device (the stub audio frontend of the reference serve)."""
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        b, s = tokens.shape
        batch["frames"] = torch.zeros(
            (b, max(s // cfg.encoder_ratio, 1), cfg.d_model),
            dtype=torch.float32, device=tokens.device)
    return batch


def run_serving(cfg: ArchConfig, *, num_requests: int = 8,
                microbatch: int = 4, prompt_len: int = 32,
                decode_steps: int = 16, num_nodes: int = 2,
                sessions: int = 1, max_concurrent: int = 4,
                stats_json: Optional[str] = None,
                streaming: bool = False, execution: str = "objects",
                hooks: Any = None, device: Any = "cuda",
                params: Any = None) -> Dict[str, Any]:
    """Serve ``num_requests`` prompts through the graph engine.

    ``params`` is a parameter tree on ``device`` (for example from
    :func:`repro_torch.bridge.params_from_numpy`); by default a seeded
    init is made on the device.  The result holds the ``responses``
    array (num_requests, decode_steps) of greedy tokens, and
    ``prefill_s``/``decode_s``: the host seconds of the prefill and decode
    apps, each ended by a device synchronise, summed over microbatches
    (apps of different microbatches may overlap, so the sum can exceed
    ``wall_s``).

    ``streaming=True`` switches token delivery to the chunk lane: each
    decode step writes one ``(microbatch, step, tokens)`` chunk onto the
    ``gen`` drop, whose edge into the assembler is streaming.  ``hooks``
    (ExecHooks) forwards to :meth:`Pipeline.execute`.
    """
    if num_requests % microbatch:
        raise ValueError(f"num_requests {num_requests} is not a multiple of "
                         f"microbatch {microbatch}")
    dev = resolve_device(device)
    n_micro = num_requests // microbatch
    max_seq = prompt_len + decode_steps

    # the apps stay in the engine's registry after this call returns; they
    # reach the weights through ``model``, which is emptied on the way out
    # so that the registry does not keep the model alive
    model = {"params": (params if params is not None
                        else M.init_params(cfg, device=dev))}
    del params
    prefill_step = make_prefill_step(cfg)
    decode_one = make_decode_step(cfg)
    app_seconds = {"prefill": 0.0, "decode": 0.0}
    seconds_lock = threading.Lock()

    def _timed(kind: str, t0: float) -> None:
        _sync(dev)
        with seconds_lock:
            app_seconds[kind] += time.monotonic() - t0

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(num_requests, prompt_len)).astype(np.int32)

    @register_app("serve/prefill")
    def prefill_app(inputs, outputs, app):
        t0 = time.monotonic()
        (mb,) = app.meta["oid"]
        chunk = torch.from_numpy(
            prompts[mb * microbatch:(mb + 1) * microbatch]).to(dev)
        # the cache is allocated at max_seq, so decode grows nothing (its
        # cross rows past the frames stay zero, as the reference's padding)
        next_tok, cache = prefill_step(model["params"],
                                       prompt_batch(cfg, chunk),
                                       max_seq)
        _timed("prefill", t0)
        for o in outputs:
            o.write({"next": next_tok[:, None], "cache": cache})

    @register_app("serve/decode")
    def decode_app(inputs, outputs, app):
        t0 = time.monotonic()
        st = inputs[0].read()
        tok, cache = st["next"], st["cache"]
        toks = [tok]
        for i in range(decode_steps - 1):
            tok, cache = decode_one(model["params"], cache, tok,
                                    prompt_len + i)
            toks.append(tok)
        gen = torch.cat(toks, dim=1).cpu().numpy()
        _timed("decode", t0)
        for o in outputs:
            o.write(gen)

    @register_app("serve/decode-stream")
    def decode_stream_app(inputs, outputs, app):
        # streaming variant: one chunk per generated token position so
        # the assembler overlaps with generation; chunks are tagged with
        # (microbatch id, step) — assembly order is interleave-proof
        t0 = time.monotonic()
        (mb,) = app.meta["oid"]
        st = inputs[0].read()
        tok, cache = st["next"], st["cache"]
        for o in outputs:
            o.write((mb, 0, tok.cpu().numpy()))
        for i in range(decode_steps - 1):
            tok, cache = decode_one(model["params"], cache, tok,
                                    prompt_len + i)
            host = tok.cpu().numpy()
            for o in outputs:
                o.write((mb, i + 1, host))
        _timed("decode", t0)

    @register_app("serve/assemble")
    def assemble(inputs, outputs, app):
        chunks = [i.read() for i in inputs]
        for o in outputs:
            o.write(np.concatenate(chunks, axis=0))

    def _assemble_finish(inputs, outputs, app):
        per_mb = app.scratch
        mbs = sorted(per_mb)
        rows = [np.concatenate([per_mb[m][s] for s in sorted(per_mb[m])],
                               axis=1) for m in mbs]
        for o in outputs:
            o.write(np.concatenate(rows, axis=0))

    @register_app("serve/assemble-stream", streaming=True,
                  finish=_assemble_finish)
    def assemble_stream(value, app):
        mb, step, tok = value
        app.scratch.setdefault(mb, {})[step] = tok

    g = GraphBuilder("serve")
    g.data("reqs")
    decode_kind = "serve/decode-stream" if streaming else "serve/decode"
    asm_kind = "serve/assemble-stream" if streaming else "serve/assemble"
    with g.scatter("mb", n_micro):
        g.component("prefill", app="serve/prefill", time=0.5)
        g.data("kv", volume=1e6)
        g.component("decode", app=decode_kind, time=1.0)
        g.data("gen")
    with g.gather("all", n_micro):
        g.component("assemble", app=asm_kind, time=0.01)
    g.data("responses")
    g.chain("reqs", "prefill", "kv", "decode", "gen")
    # token delivery: streaming mode rides the chunk lane gen -> assemble
    g.connect("gen", "assemble", streaming=streaming)
    g.chain("assemble", "responses")

    try:
        if sessions > 1:
            result = _run_sessions(g.graph(), sessions=sessions,
                                   num_nodes=num_nodes,
                                   max_concurrent=max_concurrent,
                                   num_requests=num_requests,
                                   decode_steps=decode_steps,
                                   stats_json=stats_json)
            result.update(prefill_s=app_seconds["prefill"],
                          decode_s=app_seconds["decode"])
            return result

        telemetry = TelemetryConfig(metrics=True) if stats_json else None
        engine_cfg = EngineConfig(num_nodes=num_nodes, workers_per_node=2,
                                  execution=execution, telemetry=telemetry)
        with Pipeline(engine_cfg) as p:
            p.translate(g.graph())
            p.deploy()
            t0 = time.monotonic()
            rep = p.execute(inputs={"reqs": num_requests}, timeout=3600,
                            hooks=hooks)
            wall = time.monotonic() - t0
            if not rep.ok:
                raise RuntimeError(f"serve graph failed: {rep.errors[:3]}")
            out = (p.session.read("responses") if execution == "compiled"
                   else p.session.drops["responses"].read())
            if stats_json:
                _dump_stats(stats_json, {
                    "metrics": p.metrics.snapshot() if p.metrics else {},
                    "spans": [{"name": s.name, "seconds": s.duration}
                              for s in p.spans],
                    "wall_s": wall,
                })
        gen_tokens = num_requests * decode_steps
        result = {
            "responses": out,
            "responses_shape": tuple(out.shape),
            "wall_s": wall,
            "gen_tokens_per_s": gen_tokens / wall,
            "prefill_s": app_seconds["prefill"],
            "decode_s": app_seconds["decode"],
            "drops": sum(rep.status_counts.values()),
        }
        print(f"[serve] {num_requests} requests x {decode_steps} tokens in "
              f"{wall:.2f}s ({result['gen_tokens_per_s']:.1f} tok/s), "
              f"responses {out.shape}")
        return result
    finally:
        model.clear()


def _run_sessions(lg, *, sessions: int, num_nodes: int,
                  max_concurrent: int, num_requests: int,
                  decode_steps: int,
                  stats_json: Optional[str] = None) -> Dict[str, Any]:
    """Serve one graph shape ``sessions`` times through a resident
    EngineManager: one cold translate+map, then cache-hit sessions that
    share node pools and run up to ``max_concurrent`` at once."""
    telemetry = TelemetryConfig(metrics=True) if stats_json else None
    with EngineManager(num_nodes=num_nodes, workers_per_node=2,
                       max_concurrent=max_concurrent,
                       max_pending=sessions,
                       telemetry=telemetry) as mgr:
        t0 = time.monotonic()
        tickets = [mgr.submit(lg, inputs={"reqs": num_requests},
                              timeout=3600, block=True)
                   for _ in range(sessions)]
        reports = [t.result() for t in tickets]
        wall = time.monotonic() - t0
        for rep in reports:
            if not rep.ok:
                raise RuntimeError(f"serve session failed: {rep.errors[:3]}")
        out = tickets[-1].session.read("responses")
        lats = sorted(t.latency for t in tickets)
        stats = mgr.stats()
        if stats_json:
            _dump_stats(stats_json, stats)
    gen_tokens = sessions * num_requests * decode_steps
    result = {
        "responses": out,
        "responses_shape": tuple(out.shape),
        "sessions": sessions,
        "wall_s": wall,
        "sessions_per_s": sessions / wall,
        "gen_tokens_per_s": gen_tokens / wall,
        "p50_session_s": lats[len(lats) // 2],
        "p99_session_s": lats[min(len(lats) - 1,
                                  int(0.99 * (len(lats) - 1)))],
        "template_hits": stats["templates"]["hits"],
        "drops": sum(reports[0].status_counts.values()),
    }
    print(f"[serve] {sessions} sessions x {num_requests} requests in "
          f"{wall:.2f}s ({result['sessions_per_s']:.2f} sessions/s, "
          f"{result['gen_tokens_per_s']:.1f} tok/s, "
          f"p50 {result['p50_session_s']:.3f}s / "
          f"p99 {result['p99_session_s']:.3f}s, "
          f"{result['template_hits']} cache hits)")
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--sessions", type=int, default=1,
                    help="serve the shape N times via a resident "
                         "EngineManager (template-cache hits after the "
                         "first)")
    ap.add_argument("--concurrent", type=int, default=4,
                    help="max concurrent sessions when --sessions > 1")
    ap.add_argument("--stats-json", type=str, default=None,
                    help="enable the metrics registry and dump its "
                         "snapshot (plus serving stats) to this path")
    ap.add_argument("--streaming", action="store_true",
                    help="stream decode tokens chunk-by-chunk into the "
                         "assembler (docs/streaming.md)")
    ap.add_argument("--execution", choices=("objects", "compiled"),
                    default="objects",
                    help="execution substrate for the single-session "
                         "path (--sessions 1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda raises if "
                         "CUDA is missing; pass cpu to run on the CPU)")
    args = ap.parse_args()
    cfg = get_smoke_config("codeqwen15_7b")
    run_serving(cfg, num_requests=args.requests,
                microbatch=args.microbatch, prompt_len=args.prompt,
                decode_steps=args.decode, sessions=args.sessions,
                max_concurrent=args.concurrent,
                stats_json=args.stats_json, streaming=args.streaming,
                execution=args.execution, device=args.device)


if __name__ == "__main__":
    main()
