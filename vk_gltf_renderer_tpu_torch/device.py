"""Device helpers: explicit device resolution and the float32 policy.

Every public entry point of the port takes a ``device`` argument; nothing
auto-detects. All device math is float32, and the TF32 shortcuts PyTorch
allows on NVIDIA cards are switched off: the reference learned on the TPU
that reduced-precision matmuls break shading parity
(vk_gltf_renderer_tpu/ops/__init__.py), and the port keeps small-vector
math as explicit multiply-adds that never reach a matmul anyway.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Turn off TF32 for matmuls and cuDNN (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(name) -> torch.device:
    """'cpu' / 'cuda' / 'cuda:N' / torch.device -> torch.device.

    Raises when CUDA is asked for and is absent: nothing in the port quietly
    falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {name!r}")
    set_precision()
    return dev
