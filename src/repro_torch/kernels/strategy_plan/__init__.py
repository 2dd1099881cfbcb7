from ..spec import STRATEGY_PLAN_SPEC as SPEC
from .kernel import strategy_plan_kernel
from .ops import strategy_plan
from .ref import strategy_plan_ref

__all__ = ["SPEC", "strategy_plan", "strategy_plan_kernel", "strategy_plan_ref"]
