"""Device resolution: the PyTorch counterpart of ``paddle_tpu/core/place.py``.

The port runs on the card unless the caller asks for the CPU. Every entry
point takes ``device`` with the default ``"cuda"`` and resolves it here:
without a CUDA device that default raises instead of running on the CPU,
so a run that was meant for the card can never quietly measure the host.
"""

from __future__ import annotations

import subprocess

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``"cuda"``, ``"cuda:N"``, ``"cpu"`` or a ``torch.device`` -> device.

    Raises ``RuntimeError`` for a CUDA device when none is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "present; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def strict_float32():
    """Keep float32 matmuls and convolutions in full float32 (no TF32), so
    float32 results compare with the JAX reference at float32 tolerance."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def card_name_and_power() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (a
    card set below its maximum power runs slower under load)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi gave no output"
