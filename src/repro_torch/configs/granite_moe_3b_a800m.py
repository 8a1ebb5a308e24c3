"""granite-moe-3b-a800m [moe] — 40 experts top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    num_experts=40, top_k=8,
    activation="swiglu",
    sharding_strategy="dp",
    notes="fine-grained MoE (40e top-8); heads 24 and kv 8 don't divide "
          "tp16 -> attention replicated across model axis (baseline)",
)

SMOKE = ArchConfig(
    name="granite-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256,
    num_experts=8, top_k=4,
    activation="swiglu", dtype="float32",
)
