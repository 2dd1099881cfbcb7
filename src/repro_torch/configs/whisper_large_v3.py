"""whisper-large-v3 [audio] — enc-dec, 32L each side, d1280 20H (MHA kv=20)
d_ff 5120 vocab 51866; the conv frontend is a STUB (the caller passes frame
embeddings, ``model.prefill(..., frames=)``). [arXiv:2212.04356]

Shape convention, as the reference's: S encoder frames, a decoder of
S // 8 positions. Enc-dec (quadratic encoder) => long_500k skipped.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,                       # decoder layers
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    enc_dec=True,
    audio_frontend=True,
    norm="layernorm",
    act="gelu",
    layer_pattern=("attn",),
    tie_embeddings=True,
    source="arXiv:2212.04356; unverified",
)
