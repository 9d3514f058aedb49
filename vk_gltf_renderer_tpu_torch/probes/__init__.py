"""Probes of the card's costs for the traversal kernels: the H100
counterparts of the reference's TPU probes (tools/exp_nodefetch.py,
tools/exp_visit.py). Each module holds a CUDA kernel's wrapper, its plain
torch version and a command-line entry that runs on the card:

    python -m vk_gltf_renderer_tpu_torch.probes.nodefetch
    python -m vk_gltf_renderer_tpu_torch.probes.visit
"""

from __future__ import annotations

import torch


def device_ms(fn, reps):
    """Mean device time of fn() in ms over reps calls (CUDA events), after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require_cuda(name):
    """The card's device; exits when there is none (the probes measure the
    card and have no CPU reading)."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: CUDA is not available; this probe measures an NVIDIA GPU")
    return torch.device("cuda:0")
