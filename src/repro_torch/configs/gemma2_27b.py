"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118; hf].  Local window 4096 on even layers; attention logit
softcap 50.0; final logit softcap 30.0.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    local_window=4096, alternate_local_global=True,
    attn_softcap=50.0, final_softcap=30.0,
    activation="swiglu", tie_embeddings=True,
    sharding_strategy="fsdp",
    notes="half the layers are global full attention -> NOT subquadratic; "
          "long_500k skipped per assignment rule",
)

SMOKE = ArchConfig(
    name="gemma2-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    local_window=32, alternate_local_global=True,
    attn_softcap=50.0, final_softcap=30.0,
    activation="swiglu", tie_embeddings=True, dtype="float32",
)
