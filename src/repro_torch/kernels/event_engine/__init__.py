from ..spec import EVENT_ENGINE_SPEC as SPEC
from .kernel import event_engine_kernel
from .ops import event_engine
from .ref import event_engine_ref

__all__ = ["SPEC", "event_engine", "event_engine_kernel", "event_engine_ref"]
