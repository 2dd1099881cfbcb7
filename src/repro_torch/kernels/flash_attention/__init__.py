from ..spec import FLASH_ATTENTION_SPEC as SPEC
from .kernel import flash_attention_kernel, plan_launch
from .ops import BACKENDS, flash_attention
from .ref import attention_mask, flash_attention_ref, flash_attention_split_ref

__all__ = ["SPEC", "BACKENDS", "attention_mask", "flash_attention",
           "flash_attention_kernel", "flash_attention_ref",
           "flash_attention_split_ref", "plan_launch"]
