"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface.  It is compiled by
``nvcc`` for ``sm_90a`` at first use into ``build/repro_torch_kernels/`` at
the root of the checkout, under a file name that hashes the source, the
shared headers ``csrc/*.cuh`` and the flags (an edited source is rebuilt,
never reused stale), and loaded with :mod:`ctypes`.  Only the sources in
the checkout are read.  A failed build raises; nothing falls back.

Each wrapper calls :func:`count_launch` with its source's name and its
inputs' card where it launches the kernel, and nowhere else;
:func:`launches` reads the counts, :func:`launches_by_card` splits them by
card, and :func:`reset_launches` sets them to 0.  Beside it, each call reports
its cost (:func:`report_cost`: the FLOPs and the bytes of its kernel's
cost function) to the active counters (:func:`cost_sink`, which
``launch/op_analysis.py`` opens): the kernels are called through
:mod:`ctypes`, so no dispatch mode sees them.  On ``meta`` tensors a
wrapper returns its outputs' shapes, launches nothing, counts no launch
and reports the cost all the same.  ``flash_attention``,
``rwkv6_scan`` and ``rglru_scan`` have backward kernels
(``csrc/<name>_bwd.cu``, counted as ``<name>_bwd``); ``flash_decode`` has
none, so its wrapper calls :func:`refuse_grad` on its CUDA route.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import _disable_current_modes

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_count_lock = threading.Lock()
_launches: Dict[str, int] = {}
_card_launches: Dict[Tuple[str, int], int] = {}
_sinks: List[Callable[[str, float, float], None]] = []


def count_launch(name: str, device: Optional[torch.device] = None) -> None:
    """One launch of the kernel of ``csrc/<name>.cu``, on the card
    ``device`` when given (the wrappers pass their inputs').  A wrapper
    counts a launch of one route of its kernel a second time under
    ``<name>.<route>`` (``dwconv.bn``: ``dwconv`` with its BN epilogue), so
    ``launches("<name>.<route>") / launches("<name>")`` is the route's
    share."""
    with _count_lock:
        _launches[name] = _launches.get(name, 0) + 1
        if device is not None and device.index is not None:
            key = (name, device.index)
            _card_launches[key] = _card_launches.get(key, 0) + 1


def launches(name: str) -> int:
    """Launches of the kernel of ``csrc/<name>.cu`` since the last
    :func:`reset_launches`."""
    with _count_lock:
        return _launches.get(name, 0)


def launches_by_card(name: str) -> Dict[int, int]:
    """:func:`launches` of ``name`` split by the index of the card each
    ran on (cards it did not run on are left out)."""
    with _count_lock:
        return {card: n for (kernel, card), n in sorted(
            _card_launches.items()) if kernel == name}


def reset_launches() -> None:
    with _count_lock:
        _launches.clear()
        _card_launches.clear()


def report_cost(name: str, cost: Callable[..., Tuple[float, float]],
                *args) -> None:
    """One call of the kernel of ``csrc/<name>.cu``: every active counter
    adds ``cost(*args)``, its (FLOPs, bytes).  With no counter active this
    returns at once (no lock, ``cost`` not called); otherwise ``cost`` runs
    outside the counter's dispatch mode, so what it computes (a length
    tensor read on the host) is not counted as the step's work."""
    if not _sinks:
        return
    with _count_lock:
        sinks = list(_sinks)
    if sinks:
        with _disable_current_modes():
            flops, nbytes = cost(*args)
        for sink in sinks:
            sink(name, flops, nbytes)


@contextlib.contextmanager
def cost_sink(sink: Callable[[str, float, float], None]):
    """While active, ``sink(name, flops, bytes)`` receives each kernel
    call's cost, from every thread (the autograd engine runs a CUDA
    backward on its own thread)."""
    with _count_lock:
        _sinks.append(sink)
    try:
        yield
    finally:
        with _count_lock:
            _sinks.remove(sink)


def refuse_grad(name: str, *inputs: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` when autograd records and an input requires
    a gradient: the kernel of ``csrc/<name>.cu`` has no backward (of the
    float kernels only ``flash_decode``), so its output would carry no edge
    to its inputs and every weight upstream would silently get no
    gradient.  The CPU route differentiates through the plain version."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; an input requires "
            f"grad.  Run it under torch.no_grad() or torch.inference_mode(), "
            f"or differentiate on CPU tensors (the plain version)")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to for its current contents."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source not yet built, one ``nvcc`` each, all
    started together; returns name -> library path.  The compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept
    beside each library as ``.log``."""
    names = list(names)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
