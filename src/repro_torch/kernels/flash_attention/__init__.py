from .kernel import flash_attention_kernel
from .ops import BACKENDS, flash_attention
from .ref import attention_mask, flash_attention_ref

__all__ = ["BACKENDS", "attention_mask", "flash_attention",
           "flash_attention_kernel", "flash_attention_ref"]
