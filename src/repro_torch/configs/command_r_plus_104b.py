"""command-r-plus-104b [dense] — GQA, no-bias.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01; unverified].
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    use_bias=False, activation="swiglu", tie_embeddings=True,
    sharding_strategy="fsdp",
    notes="largest dense assigned arch; kv=8 < tp16 -> replicated baseline",
)

SMOKE = ArchConfig(
    name="command-r-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=256,
    use_bias=False, activation="swiglu", tie_embeddings=True,
    dtype="float32",
)
