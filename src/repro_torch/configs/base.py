"""Architecture configuration schema and registry of the port.

Every architecture the port serves is a module ``repro_torch.configs.<id>``
exporting ``CONFIG`` (the published config) built from :class:`ArchConfig`;
``ArchConfig.reduced()`` gives the small variant of the same family that
the CPU tests run. The schema is the reference's (``repro.configs.base``),
field for field, so a config compares equal across the two packages.

Layer patterns are expressed as *groups*: a group is a short sequence of
block descriptors, repeated ``n_groups`` times, plus a remainder. The port
runs the groups as a Python loop (the reference scans them); the grouping
only fixes the order of layers and the layout of the parameters.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Literal

BlockKind = Literal["attn", "attn_local", "mamba1", "mamba2", "shared_attn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    dense_residual: bool = False      # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int                    # N
    conv_kernel: int = 4
    expand: int = 2                   # d_inner = expand * d_model
    dt_rank: int | None = None        # mamba1; default ceil(d_model/16)
    head_dim: int = 64                # mamba2 P
    version: int = 1                  # 1 = mamba1 (falcon), 2 = mamba2/SSD (zamba)

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank if self.dt_rank is not None else math.ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None       # default d_model // n_heads
    # attention details
    qkv_bias: bool = False            # qwen2
    rope_theta: float = 10000.0
    local_window: int = 4096          # sliding window for attn_local blocks
    attn_q_chunk: int = 1024          # blockwise-attention tile sizes
    attn_kv_chunk: int = 1024
    scan_chunk: int = 256             # mamba chunked-scan length
    attn_softcap: float | None = None  # gemma2 attention logit softcap
    final_softcap: float | None = None  # gemma2 final logit softcap
    layer_pattern: tuple[BlockKind, ...] = ("attn",)   # one group's blocks
    tie_embeddings: bool = True
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    embed_scale: bool = False          # gemma: scale embeddings by sqrt(d)
    # mixture-of-experts / state-space sub-configs
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # enc-dec (whisper)
    enc_dec: bool = False
    n_encoder_layers: int = 0
    # modality frontend stubs
    vision_tokens: int = 0             # vlm: positions overwritten by patch embeds
    audio_frontend: bool = False       # audio: encoder input = frame embeddings
    # which shapes this arch supports; long_500k only for sub-quadratic archs
    skip_shapes: tuple[str, ...] = ("long_500k",)
    # source provenance
    source: str = ""

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def remainder_pattern(self) -> tuple[BlockKind, ...]:
        rem = self.n_layers - self.n_groups * len(self.layer_pattern)
        return self.layer_pattern[:rem]

    def param_count(self) -> int:
        """Analytic parameter count."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Parameters one token passes through: a MoE layer's top-k
        experts of its ``num_experts``."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)

    def reduced(self) -> "ArchConfig":
        """Same family, laptop scale — used by the CPU tests."""
        pat = self.layer_pattern
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, num_experts=min(4, self.moe.num_experts),
                                      top_k=min(2, self.moe.top_k))
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, state_dim=min(8, self.ssm.state_dim),
                                      head_dim=16)
        return dataclasses.replace(
            self,
            n_layers=2 * len(pat),
            n_encoder_layers=2 if self.enc_dec else 0,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            d_ff=128 if self.moe is None else 64,
            head_dim=16,
            vocab=256,
            local_window=32,
            vision_tokens=min(self.vision_tokens, 8),
            moe=moe,
            ssm=ssm,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell's input shape: ``seq_len`` tokens (the encoder's frames
    for the encoder-decoder) of ``global_batch`` rows, run as ``kind``."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


#: The reference's shape registry, entry for entry: ``long_500k`` is a
#: batch-1 decode at 524,288 positions, run only by the sub-quadratic
#: configs (every other config lists it in ``skip_shapes``).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


#: Every architecture of the reference's registry: decoder-only blocks
#: (``attn``, ``attn_local``, ``mamba1``, ``mamba2``, ``shared_attn``, the
#: MoE feed-forward), the encoder-decoder (whisper) and the VLM front end.
_REGISTRY: dict[str, str] = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "qwen2-72b": "repro_torch.configs.qwen2_72b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "internvl2-2b": "repro_torch.configs.internvl2_2b",
}


def arch_ids() -> list[str]:
    return list(_REGISTRY)


def get_config(arch_id: str) -> ArchConfig:
    """The published config of ``arch_id``; ``KeyError`` names the known
    ids."""
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r} (the port has "
                       f"{', '.join(_REGISTRY)})")
    return importlib.import_module(_REGISTRY[arch_id]).CONFIG


def cells(arch_id: str) -> list[str]:
    """The (arch x shape) cells of ``arch_id``: every shape of
    :data:`SHAPES` its config does not skip."""
    cfg = get_config(arch_id)
    return [s for s in SHAPES if s not in cfg.skip_shapes]
