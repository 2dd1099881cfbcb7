"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, bound through :mod:`ctypes`. The five simulation
kernels are held bit-equal to float64 oracles and build with
``-fmad=false`` (no FMA contraction); the four model kernels are held to
a tolerance and build without it (:func:`nvcc_flags`). Libraries are built
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
#: the simulation kernels, bit-exact: built with ``-fmad=false``
EXACT_KERNELS = ("event_engine", "net_rerate", "strategy_plan", "st_cost",
                 "value_score")
#: the model kernels of the serving and training paths, held to a tolerance
MODEL_KERNELS = ("flash_attention", "selective_scan", "flash_attention_bwd",
                 "selective_scan_bwd")
KERNELS = EXACT_KERNELS + MODEL_KERNELS
_BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}

_VP, _I64, _F64, _F32, _INT = (ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_double, ctypes.c_float, ctypes.c_int)
#: the network kernels' one-call entry points: host and device input
#: buffers, link / staged / index counts, the six slot arrays, depth, slots,
#: now, the result word, stream, device
_NET_CALL = [_VP, _VP, _I64, _I64, _I64, _VP, _VP, _VP, _VP, _VP, _VP, _I64,
             _I64, _F64, _VP, _VP, _INT]
#: C signature of each library's entry point (see the .cu sources)
_SIGNATURES = {
    "event_engine": ("event_engine_flush", _NET_CALL),
    "net_rerate": ("net_rerate", _NET_CALL),
    "strategy_plan": ("strategy_plan",
                      [_VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _VP, _VP,
                       _VP, _INT]),
    "st_cost": ("st_cost",
                [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _I64, _VP,
                 _VP, _VP, _INT]),
    "value_score": ("value_score",
                    [_VP, _VP, _VP, _VP, _I64, _I64, _INT, _VP, _VP, _INT]),
    "flash_attention": ("flash_attention",
                        [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I64, _I64,
                         _I64, _I64, _I64, _I64, _INT, _INT, _I64, _F32, _I64,
                         _F32, _INT, _I64, _I64, _I64, _I64, _VP, _VP, _INT]),
    "flash_attention_bwd": ("flash_attention_bwd",
                            [_VP] * 11 + [_I64] * 7 + [_INT, _I64, _F32, _I64,
                                                       _F32, _VP, _VP, _VP,
                                                       _INT]),
    "selective_scan": ("selective_scan",
                       [_VP] * 10 + [_I64] * 4 + [_INT, _VP, _INT]),
    "selective_scan_bwd": ("selective_scan_bwd",
                           [_VP] * 21 + [_I64] * 4 + [_INT, _VP, _INT]),
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


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The ``nvcc`` flags of library ``name``: ``-fmad=false`` for the
    bit-exact simulation kernels only."""
    return _BASE_FLAGS + (("-fmad=false",) if name in EXACT_KERNELS else ())


def _library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(nvcc_flags(name)).encode())
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
        cmd = [nvcc, *nvcc_flags(name), "-I", str(CSRC), "-o", str(tmp),
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


def symbol(name: str, sym: str, argtypes) -> ctypes._CFuncPtr:
    """Another C function ``sym`` of kernel ``name``'s library (a query
    beside its entry point), building the library first if needed; it
    returns an int."""
    entry_point(name)
    fn = getattr(ctypes.CDLL(str(_library_path(name))), sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch reported a CUDA error; else count the launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def check_args(name: str, args, cuda: bool = True) -> torch.device:
    """What the kernels take: ``args`` is a sequence of ``(label, tensor,
    dtype, shape)``; every tensor must be contiguous, of its dtype and
    shape, and on one device (a CUDA device unless ``cuda`` is False),
    which is returned."""
    dev = args[0][1].device
    if cuda and dev.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{dev}")
    for label, t, dtype, shape in args:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} "
                             f"tensor on {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape "
                             f"{tuple(t.shape)}, want {tuple(shape)}")
    return dev


def stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev`` as the C entry points take it."""
    return torch.cuda.current_stream(dev).cuda_stream
