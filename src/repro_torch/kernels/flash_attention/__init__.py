from ..spec import FLASH_ATTENTION_SPEC as SPEC
from .kernel import flash_attention_kernel, plan_launch
from .ops import (BACKENDS, FlashAttentionFn, flash_attention,
                  flash_attention_train)
from .ref import (attention_mask, flash_attention_lse_ref, flash_attention_ref,
                  flash_attention_split_ref)

__all__ = ["SPEC", "BACKENDS", "FlashAttentionFn", "attention_mask",
           "flash_attention", "flash_attention_kernel", "flash_attention_train", "flash_attention_lse_ref",
           "flash_attention_ref", "flash_attention_split_ref", "plan_launch"]
