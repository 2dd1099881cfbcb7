from ..spec import NET_RERATE_SPEC as SPEC
from .kernel import net_rerate_kernel
from .ops import net_rerate
from .ref import net_rerate_ref

__all__ = ["SPEC", "net_rerate", "net_rerate_kernel", "net_rerate_ref"]
