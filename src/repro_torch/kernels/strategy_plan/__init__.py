from .kernel import strategy_plan_kernel
from .ops import strategy_plan
from .ref import strategy_plan_ref

__all__ = ["strategy_plan", "strategy_plan_kernel", "strategy_plan_ref"]
