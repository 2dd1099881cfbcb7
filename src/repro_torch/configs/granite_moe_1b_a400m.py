"""granite-moe-1b-a400m [moe] — 24L d1024 16H (kv8) d_ff=512/expert,
vocab 49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base]"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    moe=MoEConfig(num_experts=32, top_k=8),
    layer_pattern=("attn",),
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
