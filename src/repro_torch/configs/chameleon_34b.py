"""chameleon-34b [vlm] — early-fusion, VQ image tokens.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
[arXiv:2405.09818; unverified].  Early fusion means image patches are VQ
codes in the SAME token stream — the modality frontend (VQ-GAN tokenizer) is
a stub; ``input_specs`` provides token ids that already interleave text and
image codes, per the assignment's [vlm] rule.  qk-norm per chameleon.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536,
    qk_norm=True, activation="swiglu",
    sharding_strategy="fsdp",
    notes="decoder-only over fused text+VQ-image ids; vocab 65536 = "
          "text + image codebook",
)

SMOKE = ArchConfig(
    name="chameleon-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    qk_norm=True, activation="swiglu", dtype="float32",
)
