"""whisper-large-v3 [audio] — enc-dec, conv frontend STUB.

32L d_model=1280 20H (GQA kv=20, i.e. MHA) d_ff=5120 vocab=51866
[arXiv:2212.04356; unverified].  The audio frontend (2x conv1d over
log-mel spectrogram) is a stub: ``input_specs`` provides precomputed frame
embeddings (B, seq/8, d_model), per the assignment's [audio] rule.
"""
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    num_layers=32, num_encoder_layers=32,
    d_model=1280, num_heads=20, num_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    activation="gelu", use_bias=True, tie_embeddings=True,
    encoder_ratio=8, sharding_strategy="dp",
    notes="encoder-decoder; sinusoidal positions; audio frontend stubbed",
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="encdec",
    num_layers=2, num_encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    activation="gelu", use_bias=True, tie_embeddings=True,
    encoder_ratio=4, dtype="float32",
)
