"""qwen2-72b [dense] — 80L d8192 64H (kv8) d_ff 29568 vocab 152064, GQA with
QKV bias. [arXiv:2407.10671] Full attention => long_500k skipped."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    layer_pattern=("attn",),
    tie_embeddings=False,
    source="arXiv:2407.10671; hf",
)
