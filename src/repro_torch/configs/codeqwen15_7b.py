"""codeqwen1.5-7b [dense] — qwen1.5 arch (MHA, qkv bias, swiglu).

32L d_model=4096 32H (GQA kv=32 = MHA) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B; hf].
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416,
    use_bias=True, activation="swiglu",
    rope_theta=1000000.0,
    sharding_strategy="dp",
    notes="qwen1.5 architecture: MHA with qkv bias, rope theta 1e6",
)

SMOKE = ArchConfig(
    name="codeqwen-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    use_bias=True, activation="swiglu", dtype="float32",
)
