from .kernel import value_score_kernel
from .ops import MODES, value_score
from .ref import value_score_ref

__all__ = ["MODES", "value_score", "value_score_kernel", "value_score_ref"]
