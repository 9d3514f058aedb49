"""Edge-aware à-trous denoiser with SVGF weights: port of
vk_gltf_renderer_tpu/ops/denoise.py.

Five à-trous iterations (B3-spline taps at steps 1, 2, 4, ...) with
edge-stopping weights on the normal (cos^sigma_n), the depth (scaled by
the depth's standard deviation over the frame) and the luminance. Albedo is
divided out before filtering and multiplied back after. With a luminance
variance estimate the luminance sigma is 10 sqrt(3x3-prefiltered variance)
plus a floor, capped at the fixed sigma, and the variance rides the same
ladder with squared weights (Schied et al. 2017). Pixels without a first
hit pass through untouched. Plain torch, as the reference is plain XLA;
the taps wrap at the image border (torch.roll, as jnp.roll).
"""

from __future__ import annotations

import math

import torch

_KERNEL = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)  # B3-spline taps


def _lum(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _gauss3(x):
    """3x3 Gaussian prefilter (separable 1/4, 1/2, 1/4), wrapping."""
    x = 0.25 * torch.roll(x, 1, 0) + 0.5 * x + 0.25 * torch.roll(x, -1, 0)
    return 0.25 * torch.roll(x, 1, 1) + 0.5 * x + 0.25 * torch.roll(x, -1, 1)


def spatial_variance(lum_img):
    """3x3 moment-based luminance variance (the fallback when too few
    samples give no per-pixel estimate)."""
    m1 = _gauss3(lum_img)
    m2 = _gauss3(lum_img * lum_img)
    return torch.clamp(m2 - m1 * m1, min=0.0)


def denoise(radiance, albedo, normal, depth, valid, iterations: int = 5, sigma_normal: float = 64.0,
            sigma_depth: float = 1.0, sigma_lum: float = 4.0, variance=None, sigma_floor: float = 0.0):
    """Denoised radiance [H,W,3] of radiance [H,W,3] with the guides albedo
    [H,W,3], normal [H,W,3], depth [H,W] (any monotonic proxy) and valid
    [H,W] bool (first hit exists). variance [H,W]: the luminance variance
    of the demodulated signal, or None for the fixed sigma."""
    alb = torch.clamp(albedo, min=1e-3)
    irr = torch.where(valid[..., None], radiance / alb, radiance)
    # population deviation, as jnp.std
    depth_scale = 1.0 / torch.clamp(
        torch.std(torch.where(valid, depth, 0.0), correction=0) + 1e-6, min=1e-6)
    has_var = variance is not None
    valid_f = valid.to(torch.float32)

    out = irr
    var = variance
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(out)
        vacc = torch.zeros_like(valid_f) if has_var else None
        wsum = torch.zeros_like(valid_f)
        l0 = _lum(out)
        if has_var:
            # variance only sharpens the filter (capped at the fixed sigma); the floor keeps
            # it at the fixed sigma while few samples make the estimate unreliable
            lsig = torch.clamp(10.0 * torch.sqrt(_gauss3(var)) + sigma_floor, max=sigma_lum) + 1e-4
        else:
            lsig = sigma_lum
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                w_k = _KERNEL[dy + 2] * _KERNEL[dx + 2]
                sh = (-dy * step, -dx * step)
                o_sh = torch.roll(out, sh, (0, 1))
                n_sh = torch.roll(normal, sh, (0, 1))
                d_sh = torch.roll(depth, sh, (0, 1))
                v_sh = torch.roll(valid, sh, (0, 1))
                w_n = torch.clamp(torch.sum(normal * n_sh, -1), min=0.0) ** sigma_normal
                w_d = torch.exp(-torch.abs(depth - d_sh) * depth_scale / sigma_depth)
                w_l = torch.exp(-torch.abs(l0 - _lum(o_sh)) / lsig)
                w = w_k * w_n * w_d * w_l * v_sh.to(torch.float32)
                w = torch.where(valid, w, torch.where(v_sh, 0.0, w_k))  # the sky filters with the sky
                acc = acc + o_sh * w[..., None]
                if has_var:
                    vacc = vacc + torch.roll(var, sh, (0, 1)) * w * w
                wsum = wsum + w
        out = acc / torch.clamp(wsum, min=1e-8)[..., None]
        if has_var:
            var = vacc / torch.clamp(wsum * wsum, min=1e-12)
    return torch.where(valid[..., None], out * alb, radiance)


def denoise_renderer(renderer, iterations: int = 5):
    """Denoise a GltfRenderer's accumulated image [H,W,3] with the guides of
    its last frame (the accumulation itself without them). Variance: the
    accumulated per-sample luminance moments (renderer._moments, at least 2
    samples) moved to the demodulated domain, else the 3x3 spatial
    fallback; the sigma floor 4 exp(-n/12) fades over the first ~48
    samples."""
    aux = renderer._last_aux
    h, w = renderer.height, renderer.width
    rad = renderer.accum.reshape(h, w, 3)
    if aux is None:
        return rad
    albedo = aux["albedo"].reshape(h, w, 3)
    normal = aux["normal"].reshape(h, w, 3)
    solid = aux["solid"].reshape(h, w)
    pos = aux["first_pos"].reshape(h, w, 3)
    eye = torch.tensor(renderer.camera.eye, dtype=torch.float32, device=rad.device)
    depth = torch.where(solid, torch.linalg.norm(pos - eye, dim=-1), 1e9)

    alb_lum = torch.clamp(_lum(albedo), min=1e-3)
    moments = renderer._moments
    n = renderer.total_samples
    floor = 4.0 * float(math.exp(-n / 12.0))
    if moments is not None and n >= 2:
        m = moments.reshape(h, w, 2)
        mean = m[..., 0] / n
        # the variance of the mean estimate, which the accumulated image carries
        var = torch.clamp(m[..., 1] / n - mean * mean, min=0.0) / (n - 1)
        variance = var / (alb_lum * alb_lum)
    else:
        variance = spatial_variance(torch.where(solid, _lum(rad) / alb_lum, 0.0))
    return denoise(rad, albedo, normal, depth, solid, iterations=iterations, variance=variance,
                   sigma_floor=floor)
