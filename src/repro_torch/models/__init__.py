"""Model substrate in PyTorch: all six families of the JAX package."""
from .common import SHAPES, ArchConfig, ShapeConfig
from .model import (decode_step, forward_train, init_cache, init_params,
                    prefill)

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "decode_step",
           "forward_train", "init_cache", "init_params", "prefill"]
