"""arctic-480b [moe] — 35L d7168 56H (kv8) d_ff=4864/expert, vocab 32000,
MoE 128 experts top-2 + dense residual. [hf:Snowflake/snowflake-arctic-base]"""

from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    head_dim=128,
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True),
    layer_pattern=("attn",),
    tie_embeddings=False,
    source="hf:Snowflake/snowflake-arctic-base; hf",
)
