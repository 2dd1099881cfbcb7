"""falcon-mamba-7b [ssm] — 64L d4096 attention-free (mamba1), ssm_state=16,
vocab 65024. [arXiv:2410.05355] Attention-free => long_500k runs."""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,                          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    ssm=SSMConfig(state_dim=16, conv_kernel=4, expand=2, version=1),
    scan_chunk=4096,     # §Perf it.4: N=16 is small enough that long
                         # associative-scan chunks win (2.1x memory term
                         # vs 256); mamba2 (N=64, quadratic intra-chunk)
                         # keeps the short default.
    layer_pattern=("mamba1",),
    tie_embeddings=True,
    skip_shapes=(),                     # long_500k runs (ssm)
    source="arXiv:2410.05355; unverified",
)
