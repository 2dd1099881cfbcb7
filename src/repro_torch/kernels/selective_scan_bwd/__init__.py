from ..spec import SELECTIVE_SCAN_BWD_SPEC as SPEC
from .kernel import selective_scan_bwd_kernel
from .ref import selective_scan_bwd_ref

__all__ = ["SPEC", "selective_scan_bwd_kernel", "selective_scan_bwd_ref"]
