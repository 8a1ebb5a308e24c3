"""nemotron-4-15b [dense] — GQA, squared-ReLU.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000
[arXiv:2402.16819; unverified].
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=256000,
    activation="relu2",
    sharding_strategy="fsdp",
    notes="squared-ReLU MLP (2 matmuls, not swiglu's 3)",
)

SMOKE = ArchConfig(
    name="nemotron-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    activation="relu2", dtype="float32",
)
