"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device") -> torch.device:
    """The ``torch.device`` an entry point runs on. ``"cuda"`` demands a
    card and raises without one: the port never carries on silently on
    the CPU. Pass ``"cpu"`` for the plain PyTorch versions."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' needs a CUDA card and torch.cuda.is_available()"
                " is False; pass device='cpu' to run the plain PyTorch "
                "versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (want 'cuda' or "
                         "'cpu')")
    return dev
