"""internvl2-2b [vlm] — InternLM2-1.8B language backbone: 24L d2048 16H
(kv8) d_ff 8192 vocab 92553; InternViT frontend is a STUB (the caller
passes 256 patch embeddings, ``vision_embeds``, that overwrite the leading
positions).
[arXiv:2404.16821] Full attention => long_500k skipped."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    head_dim=128,
    vision_tokens=256,
    layer_pattern=("attn",),
    tie_embeddings=True,
    source="arXiv:2404.16821; hf",
)
