"""Command-line drivers of the PyTorch port (counterpart of ``gpann_tpu/cli``).

Each driver takes its JAX counterpart's positional arguments plus
``--device`` (default ``cuda``; ``cuda:N`` or ``cpu`` when asked for).
"""

from __future__ import annotations

import torch


def pop_device(argv: list) -> str:
    """Remove ``--device X`` / ``--device=X`` from ``argv``; return X
    (``cuda`` when absent)."""
    for i, arg in enumerate(argv):
        if arg == "--device":
            if i + 1 == len(argv):
                raise SystemExit("--device needs a value")
            device = argv[i + 1]
            del argv[i : i + 2]
            return device
        if arg.startswith("--device="):
            del argv[i]
            return arg.split("=", 1)[1]
    return "cuda"


def resolve_device(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA device without a GPU raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA GPU is available; pass "
                           "--device cpu to run on the CPU")
    return device
