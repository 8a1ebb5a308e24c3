"""Architecture registry: the 10 assigned configs + reduced smoke variants.

``get_config(name)`` returns the exact published config;
``get_smoke_config(name)`` returns a tiny same-family variant for CPU tests.
The ``configs/*.py`` files are the JAX package's, copied as data.
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional

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
