"""gemma3-1b [dense] — 26L d1152 4H (kv1) d_ff 6912 vocab 262144; 5:1
local:global attention, 128k context. [hf:google/gemma-3-1b-pt]
26 layers = 4 groups of (local x5, global) + 2 remainder local layers.
Global layers are full attention => long_500k skipped."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    local_window=512,
    attn_q_chunk=256,    # §Perf it.4: tiles matched to the 512 window cut
    attn_kv_chunk=256,   # the causal/band over-compute ~12% further
    rope_theta=1e6,
    embed_scale=True,
    layer_pattern=("attn_local",) * 5 + ("attn",),
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
