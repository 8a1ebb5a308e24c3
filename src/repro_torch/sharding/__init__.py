"""Sharding rules (specs for every param, batch and cache leaf) and the
activation-sharding profiles, over DTensor placements."""
from .rules import (AbstractMesh, P, abstract_mesh, batch_pspecs,
                    cache_pspecs, data_axes, logits_pspec, opt_pspecs,
                    param_pspecs, shard_if_divisible, to_placements,
                    zero_opt_pspecs)

__all__ = ["AbstractMesh", "P", "abstract_mesh", "batch_pspecs",
           "cache_pspecs", "data_axes", "logits_pspec", "opt_pspecs",
           "param_pspecs", "shard_if_divisible", "to_placements",
           "zero_opt_pspecs"]
