"""granite-3-8b [dense] — 40L d4096 32H (kv8) d_ff 12800 vocab 49155, GQA.
[hf:ibm-granite/granite-3.0-2b-base family] Full attention => long_500k
skipped."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    head_dim=128,
    layer_pattern=("attn",),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base; hf",
)
