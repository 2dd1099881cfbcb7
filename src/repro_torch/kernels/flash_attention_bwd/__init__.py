from ..spec import FLASH_ATTENTION_BWD_SPEC as SPEC
from .kernel import flash_attention_bwd_kernel
from .ref import flash_attention_bwd_ref

__all__ = ["SPEC", "flash_attention_bwd_kernel", "flash_attention_bwd_ref"]
