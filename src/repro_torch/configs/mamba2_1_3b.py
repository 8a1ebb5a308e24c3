"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

48L d_model=2048 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified].
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64,
    tie_embeddings=True,
    sharding_strategy="dp", subquadratic=True,
    notes="pure SSM; runs long_500k with O(1) state",
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=256,
    ssm_state=16, ssm_expand=2, ssm_headdim=16,
    tie_embeddings=True, dtype="float32",
)
