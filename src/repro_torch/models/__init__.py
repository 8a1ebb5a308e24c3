"""Model substrate in PyTorch: the dense and vlm families so far."""
from .common import SHAPES, ArchConfig, ShapeConfig
from .model import (decode_step, forward_train, init_cache, init_params,
                    prefill)

__all__ = ["SHAPES", "ArchConfig", "ShapeConfig", "decode_step",
           "forward_train", "init_cache", "init_params", "prefill"]
