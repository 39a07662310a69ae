"""Checkpoint store: atomic, integrity-checked pytree snapshots.

Fault-tolerance contract (runtime/ft.py builds on this):
* **atomic**: write to ``step_N.tmp/`` then rename — a crash mid-save never
  corrupts the latest checkpoint;
* **integrity**: every array file carries a CRC32 in metadata.json; restore
  verifies and falls back to the previous step on mismatch;
* **async**: ``save(..., blocking=False)`` snapshots to host memory
  synchronously (cheap) and writes to disk on a background thread, so the
  train loop is never blocked by I/O;
* **retention**: keeps the newest ``keep`` checkpoints.

A tree is nested dicts, lists and tuples of torch tensors; ``None`` is
an empty subtree.  Leaves are visited in
``jax.tree.flatten``'s order (dict keys sorted, sequences in order), and
each is written as the ``.npy`` file the ``repro`` package writes for the
same array, so leaf ``i`` is the same array in either package and either
package restores the other's checkpoints.  numpy has no bfloat16: a bf16
leaf is written as its 16 bits under the header ``'<V2'`` (the header
``ml_dtypes``' bfloat16 gets) and read back through ``torch.int16``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

Params = Any

# the .npy header descr of a 2-byte ml_dtypes leaf (bfloat16)
_BF16_DESCR = "<V2"


def tree_flatten(tree: Params) -> Tuple[List[Any], Any]:
    """(leaves, treedef): dict keys sorted, lists and tuples in order,
    ``None`` no leaf.  ``treedef`` is the tree with every leaf replaced by
    ``"*"``."""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _flatten(node: Params, leaves: List[Any]) -> Any:
    # module-level recursion: a nested function that calls itself is a
    # reference cycle, which would keep ``leaves`` (tensors a schedule
    # hands on each microbatch) alive until the cyclic collector runs
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _flatten(node[k], leaves) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_flatten(c, leaves) for c in node)
    leaves.append(node)
    return "*"


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Params:
    """Inverse of :func:`tree_flatten`."""
    return _unflatten(treedef, iter(leaves))


def _unflatten(node: Any, it: Iterator[Any]) -> Params:
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _unflatten(v, it) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_unflatten(c, it) for c in node)
    return next(it)


def tree_map(fn: Callable[[Any], Any], tree: Params) -> Params:
    """``tree`` with ``fn`` applied to every leaf."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(leaf) for leaf in leaves])


def _host_copy(leaf: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``leaf`` that later in-place updates cannot touch
    (a device tensor's copy waits for the device); bf16 as int16 bits."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _save_leaf(path: str, arr: np.ndarray, bf16: bool) -> None:
    if not bf16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": _BF16_DESCR, "fortran_order": False,
            "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _cast(a: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """Array ``a`` as a tensor on ``t``'s device and dtype, in its shape
    (a kind-``V`` array holds bf16 bits)."""
    x = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
         if a.dtype.kind == "V" else torch.from_numpy(a))
    return x.to(device=t.device, dtype=t.dtype).reshape(t.shape)


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None

    # -- paths ----------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def has_checkpoint(self) -> bool:
        """True if at least one checkpoint exists — lets restart logic
        (``TrainSupervisor``, warm stage restore) distinguish "restore the
        latest snapshot" from "start clean" without trying a restore."""
        return bool(self.steps())

    # -- save -------------------------------------------------------------------
    def save(self, step: int, tree: Params, blocking: bool = True) -> None:
        # snapshot to host memory NOW (tensors updated in place later stay
        # as they were at this call)
        leaves, treedef = tree_flatten(tree)
        bf16 = [l.dtype == torch.bfloat16 for l in leaves]
        host = [_host_copy(l) for l in leaves]

        def write():
            tmp = self._step_dir(step) + ".tmp"
            final = self._step_dir(step)
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            meta = {"step": step, "n_leaves": len(host), "crc": [],
                    "treedef": repr(treedef)}
            for i, (arr, is_bf16) in enumerate(zip(host, bf16)):
                path = os.path.join(tmp, f"leaf_{i:05d}.npy")
                _save_leaf(path, arr, is_bf16)
                with open(path, "rb") as f:
                    meta["crc"].append(zlib.crc32(f.read()))
            with open(os.path.join(tmp, "metadata.json"), "w") as f:
                json.dump(meta, f)
            with self._lock:
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()

        if blocking:
            write()
        else:
            self.wait()
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ------------------------------------------------------------------
    def _verify(self, step: int) -> bool:
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, "metadata.json")) as f:
                meta = json.load(f)
            for i, crc in enumerate(meta["crc"]):
                path = os.path.join(d, f"leaf_{i:05d}.npy")
                with open(path, "rb") as f:
                    if zlib.crc32(f.read()) != crc:
                        return False
            return True
        except (OSError, json.JSONDecodeError, KeyError):
            return False

    def restore(self, template: Params, step: Optional[int] = None
                ) -> Tuple[Optional[int], Params]:
        """Restore into the structure of `template`; returns (step, tree).
        Tries the latest verified checkpoint, falling back on corruption.
        Each leaf lands on its template leaf's device and dtype."""
        self.wait()
        candidates = ([step] if step is not None else
                      list(reversed(self.steps())))
        leaves_t, treedef = tree_flatten(template)
        for s in candidates:
            if not self._verify(s):
                continue
            d = self._step_dir(s)
            leaves = [np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
                      for i in range(len(leaves_t))]
            out = tree_unflatten(
                treedef, [_cast(a, t) for a, t in zip(leaves, leaves_t)])
            return s, out
        return None, template
