"""Probes of the card's costs for the traversal kernels: the H100
counterparts of the reference's TPU probes (tools/exp_nodefetch.py,
tools/exp_visit.py, tools/exp_stream_dma.py, tools/uarch_probe.py). Each
module holds a CUDA kernel's wrapper, its plain torch version and a
command-line entry that runs on the card:

    python -m vk_gltf_renderer_tpu_torch.probes.nodefetch
    python -m vk_gltf_renderer_tpu_torch.probes.visit
    python -m vk_gltf_renderer_tpu_torch.probes.stream_dma
    python -m vk_gltf_renderer_tpu_torch.probes.uarch
"""

from __future__ import annotations

import torch


QUEUE_CYCLES = 1_000_000  # spin cycles queued per timed call (~0.5 ms at 1.98 GHz)


def device_ms(fn, reps):
    """Mean device time of fn() in ms over reps calls (CUDA events), after
    one warm-up call. The timed calls are queued behind a spin kernel of
    QUEUE_CYCLES per call, so that the card runs them back to back and the
    events do not time the host's issue of a call shorter than its own
    launch overhead."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(QUEUE_CYCLES * reps)
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
