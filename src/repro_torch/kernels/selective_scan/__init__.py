from ..spec import SELECTIVE_SCAN_SPEC as SPEC
from .kernel import selective_scan_kernel
from .ops import BACKENDS, selective_scan
from .ref import selective_scan_ref

__all__ = ["SPEC", "BACKENDS", "selective_scan", "selective_scan_kernel",
           "selective_scan_ref"]
