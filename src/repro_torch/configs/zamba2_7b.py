"""zamba2-7b [hybrid] — 81L d3584, Mamba-2 blocks + a shared attention block
(32H MHA kv=32, head dim 112, d_ff 14336) applied every 6 layers with shared
weights, ssm_state=64. [arXiv:2411.15242]

Group layout: 81 layers = 11 groups of (mamba2 x6, shared_attn) + 4
remainder mamba2 blocks: 70 mamba2 mixers and 11 applications of the one
shared attention block (each with its own KV cache), then 4 mamba2 blocks.
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,                       # 11 x (6 mamba2 + shared attn) + 4
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    head_dim=112,
    ssm=SSMConfig(state_dim=64, conv_kernel=4, expand=2, head_dim=64,
                  version=2),
    layer_pattern=("mamba2",) * 6 + ("shared_attn",),
    tie_embeddings=True,
    skip_shapes=(),                    # long_500k runs (hybrid)
    source="arXiv:2411.15242; unverified",
)
