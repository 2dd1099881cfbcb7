from ..spec import ST_COST_SPEC as SPEC
from .kernel import st_cost_kernel
from .ops import st_cost
from .ref import st_cost_ref

__all__ = ["SPEC", "st_cost", "st_cost_kernel", "st_cost_ref"]
