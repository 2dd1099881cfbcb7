"""gemma2-27b [dense] — 46L d4608 32H (kv16) d_ff 36864 vocab 256000;
local+global alternating attention, logit softcaps. [arXiv:2408.00118]
Full attention on global layers => long_500k skipped."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    local_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    embed_scale=True,
    layer_pattern=("attn_local", "attn"),     # 23 groups
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
)
