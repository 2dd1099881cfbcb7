"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, bound through :mod:`ctypes`. Libraries are built
at first use (every source in parallel, one ``nvcc`` each) into
``build/kernels/`` at the repository root, under a file name that carries a
hash of the sources and flags, so an edited source is never served from a
stale build. Nothing here runs at import time: the CPU tests import every
module of the package on a machine with no ``nvcc`` and no card.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it; a run
resets it with :func:`reset_launches` and reads it afterwards to show which
kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "kernels"
KERNELS = ("event_engine", "net_rerate")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_VP, _I64, _F64, _INT = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                         ctypes.c_int)
#: C signature of each library's entry point (see the .cu sources)
_SIGNATURES = {
    "event_engine": ("event_engine_flush",
                     [_VP, _I64, _VP, _I64, _VP, _VP, _VP, _VP, _I64, _VP,
                      _VP, _F64, _VP, _VP, _INT]),
    "net_rerate": ("net_rerate",
                   [_VP, _I64, _VP, _I64, _VP, _VP, _I64, _VP, _VP, _F64,
                    _VP, _VP, _INT]),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes._CFuncPtr] = {}
#: ptxas report (registers, spills) of each library built by this process
BUILD_LOGS: dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                           "kernels are built on the machine with the card")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> float:
    """Compile every library of ``names`` not built yet, all ``nvcc``
    processes at once; returns the wall seconds spent. Raises with the
    compiler's output when a build fails."""
    t0 = time.perf_counter()
    todo = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return time.perf_counter() - t0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def entry_point(name: str) -> ctypes._CFuncPtr:
    """The C entry point of kernel ``name``, building its library first
    if needed."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _loaded:
            build((name,))
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(_library_path(name))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return _loaded[name]


def check(name: str, err: int) -> None:
    """Raise if a launch reported a CUDA error; else count the launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def check_inputs(name: str, idx, path, slot_arrays, link_arrays) -> None:
    """What the kernels take: one CUDA device, contiguous tensors, int32
    ``idx`` (1-D) and ``path`` (``(slots, depth)``), float64 per-slot and
    per-link arrays of matching lengths."""
    dev = slot_arrays[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{dev}")
    n_slots = slot_arrays[0].numel()
    for label, group, dtype in (("idx/path", (idx, path), torch.int32),
                                ("slot arrays", slot_arrays, torch.float64),
                                ("link arrays", link_arrays, torch.float64)):
        for t in group:
            if t.device != dev or t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"{name}: {label} must be contiguous "
                                 f"{dtype} on {dev}")
    if idx.dim() != 1 or path.dim() != 2 or path.shape[0] != n_slots:
        raise ValueError(f"{name}: want idx (n,) and path ({n_slots}, depth)"
                         f", got {tuple(idx.shape)} and {tuple(path.shape)}")
    if any(t.numel() != n_slots for t in slot_arrays) or \
            link_arrays[0].numel() != link_arrays[1].numel():
        raise ValueError(f"{name}: per-slot / per-link lengths disagree")
