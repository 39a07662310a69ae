"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

The package mirrors ``repro``'s layout (``core/``, ``api/``, ``serving/``,
``models/``, ``configs/``, ``kernels/``, ``launch/``).  It imports
``torch`` and never ``jax``, and nothing of ``repro``: the pure-Python
planner, front door and server are its own copies.  Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises for a CUDA device
    when this process sees no card, so nothing quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            f"pass device='cpu' to run on the CPU")
    return dev
