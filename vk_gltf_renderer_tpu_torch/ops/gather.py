"""Small-table gather out[c, i] = tab[c, idx[i]]: the wrapper of
csrc/gather.cu (replacing the reference's Pallas gather_channels,
vk_gltf_renderer_tpu/ops/pallas_gather.py). CPU tensors take the plain
version, ``tab[:, idx]``; CUDA tensors launch the kernel or raise."""

from __future__ import annotations

import torch

from ..cuda_lib import LaunchCounter, check_launch, library

COUNTER = LaunchCounter()


def gather_channels_plain(tab, idx):
    return tab[:, idx.long()]


def gather_channels(tab, idx):
    """tab: [C, T] f32; idx: [N] i32 in [0, T). Returns [C, N] f32."""
    if tab.device.type == "cpu":
        return gather_channels_plain(tab, idx)
    if tab.device.type != "cuda":
        raise ValueError(f"gather_channels: unsupported device {tab.device}")
    if tab.dtype != torch.float32 or tab.ndim != 2 or not tab.is_contiguous():
        raise ValueError(f"tab: expected contiguous [C,T] float32, got {tab.dtype} {tuple(tab.shape)}")
    if idx.dtype != torch.int32 or idx.ndim != 1 or not idx.is_contiguous():
        raise ValueError(f"idx: expected contiguous [N] int32, got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != tab.device:
        raise ValueError(f"idx on {idx.device}, tab on {tab.device}")
    c, t = tab.shape
    n = idx.shape[0]
    out = torch.empty((c, n), dtype=torch.float32, device=tab.device)
    rc = library().lib.vkgr_gather_channels(
        tab.data_ptr(), idx.data_ptr(), out.data_ptr(), c, t, n,
        torch.cuda.current_stream(tab.device).cuda_stream,
    )
    check_launch(rc, "gather_channels")
    COUNTER.launches += 1
    return out
