"""grok-1-314b [moe] — 8 experts top-2.

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2
[hf:xai-org/grok-1; unverified].
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    num_experts=8, top_k=2,
    activation="geglu",   # gated GeLU: 3 matmuls/expert -> ~314B total
    sharding_strategy="fsdp",
    notes="8-expert top-2 MoE; GQA kv=8 (< tp16 -> replicated baseline)",
)

SMOKE = ArchConfig(
    name="grok-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    num_experts=4, top_k=2,
    activation="geglu", dtype="float32",
)
