from .pipeline import ShardedTokenPipeline, synthetic_batch

__all__ = ["ShardedTokenPipeline", "synthetic_batch"]
