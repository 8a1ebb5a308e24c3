"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention block.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf].  One shared transformer block (attention + MLP,
same parameters) applied every 6 Mamba2 layers — zamba2's parameter-sharing
trick, which keeps param count low while restoring attention's global mixing.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64,
    shared_attn_period=6,
    activation="gelu", tie_embeddings=True,
    sharding_strategy="dp", subquadratic=True,
    notes="runs long_500k: SSM state is O(1); the 9 shared-attn cache "
          "entries are the only seq-length-scaling decode state",
)

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid",
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    ssm_state=16, ssm_expand=2, ssm_headdim=16,
    shared_attn_period=2,
    activation="gelu", tie_embeddings=True, dtype="float32",
)
