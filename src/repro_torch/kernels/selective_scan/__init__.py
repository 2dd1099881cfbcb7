from ..spec import SELECTIVE_SCAN_SPEC as SPEC
from .kernel import ROUND, round_states, selective_scan_kernel
from .ops import BACKENDS, SelectiveScanFn, selective_scan, selective_scan_train
from .ref import selective_scan_ref

__all__ = ["SPEC", "BACKENDS", "ROUND", "SelectiveScanFn", "round_states",
           "selective_scan", "selective_scan_kernel", "selective_scan_ref",
           "selective_scan_train"]
