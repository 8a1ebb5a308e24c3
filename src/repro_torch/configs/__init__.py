"""Architecture registry: the 10 assigned configs + reduced smoke variants.

``get_config(name)`` returns the exact published config;
``get_smoke_config(name)`` returns a tiny same-family variant for CPU tests;
``abstract_params(cfg)`` and ``input_specs(cfg, shape)`` return the
dry-run's stand-ins: fake tensors (``FakeTensorMode`` on the CPU) with the
shapes and dtypes of the real ones and no storage, the counterpart of the
reference's ``ShapeDtypeStruct`` trees.
The ``configs/*.py`` files are the JAX package's, copied as data.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Optional

from ..models.common import SHAPES, ArchConfig, ShapeConfig  # noqa: F401

ARCH_NAMES = [
    "whisper_large_v3",
    "grok_1_314b",
    "granite_moe_3b_a800m",
    "nemotron_4_15b",
    "gemma2_27b",
    "codeqwen15_7b",
    "command_r_plus_104b",
    "zamba2_2_7b",
    "mamba2_1_3b",
    "chameleon_34b",
]


# public ids use dashes (``--arch whisper-large-v3``)
def _mod_name(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f".{_mod_name(name)}", __package__)
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f".{_mod_name(name)}", __package__)
    return mod.SMOKE


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


def cell_supported(cfg: ArchConfig, shape: ShapeConfig) -> Optional[str]:
    """Returns None if runnable, else the documented skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("needs sub-quadratic attention; "
                f"{cfg.name} is full-attention (see DESIGN.md)")
    return None


# ---------------------------------------------------------------------------
# Abstract params and inputs (fake tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------


def eval_shape(fn: Callable[[], Any]) -> Any:
    """``fn()`` run on fake tensors (``FakeTensorMode``): its result's
    shapes and dtypes, nothing allocated (``jax.eval_shape``'s
    counterpart)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return fn()


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                for_step: Optional[str] = None) -> Dict[str, Any]:
    """Abstract inputs for the given (arch, shape) cell.

    train/prefill: {tokens, labels?, frames?}
    decode:        {tokens(B,1), pos (0-d int32), cache}
    """
    import torch

    from ..models import model as M
    B, S = shape.global_batch, shape.seq_len
    kind = for_step or shape.kind
    i32 = torch.int32

    def make() -> Dict[str, Any]:
        if kind in ("train", "prefill"):
            specs: Dict[str, Any] = {"tokens": torch.empty((B, S), dtype=i32)}
            if kind == "train":
                specs["labels"] = torch.empty((B, S), dtype=i32)
            if cfg.family == "encdec":
                enc_len = max(S // cfg.encoder_ratio, 1)
                specs["frames"] = torch.empty((B, enc_len, cfg.d_model),
                                              dtype=cfg.torch_dtype)
            return specs
        # decode: one new token against a seq_len-deep cache
        return {"tokens": torch.empty((B, 1), dtype=i32),
                "pos": torch.empty((), dtype=i32),
                "cache": M.init_cache(cfg, B, S, device="cpu")}
    return eval_shape(make)


def abstract_params(cfg: ArchConfig) -> Any:
    """Parameter stand-ins (fake tensors) without allocating anything."""
    from ..models import model as M
    return eval_shape(lambda: M.init_params(cfg, device="cpu"))
