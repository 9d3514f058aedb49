"""Stream-copy probe: the wrapper of csrc/probe_stream_dma.cu, the H100
counterpart of the reference's TPU probe tools/exp_stream_dma.py.

A stream fetches `steps` pages of [F,128] f32 (F = 12, or 16 for the TPU
probe's tile-aligned variants E, F, G) from a table [n_pages*F, 128] in
device memory and sums them element-wise into acc [F,128]. Page i is
(base + |int(sum(acc))| + 7i) % n_pages in the data-dependent order (TPU
variants A, B, F) and (base + 7i) % n_pages in the regular one (C, D, E,
G); D and G request page i+1 before they consume page i. A and B differ
only in the TPU's loop construct (while_loop, fori_loop): on the card they
are one computation, and the wrapper takes every letter.

The card's question is the copy construct (COPIES): `ld` (direct loads
into registers), `cp_async` (16-byte cp.async into a shared slot) or `tma`
(one bulk copy of the page onto an mbarrier). Every construct gives the
same sums. At the TPU probe's size (pages(): its 64-page table, one
stream) the output is the TPU probe's [F,128]; at card scale (card_table:
the terrain's nodes4_fi bytes, in L2, and 268 MB, past it) `blocks`
streams run side by side, one per SM, stream b from page b*(n_pages //
blocks), and the output is [blocks, F, 128].

    python -m vk_gltf_renderer_tpu_torch.probes.stream_dma [--steps S] [--card-steps S]

prints, on the card, ms per launch, µs per page and GB/s for every variant
and copy construct at the TPU probe's size and at card scale.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cuda_lib import LaunchCounter, check_launch, check_tensor, library
from . import device_ms, require_cuda

LANE = 128
N_PAGES = 64  # pages of the TPU probe's table
STEPS = 48  # pages visited per stream
VARIANTS = ("A", "B", "C", "D", "E", "F", "G")
ALIGNED = {"E": "C", "F": "A", "G": "D"}  # E, F, G are C, A, D at F = 16
COPIES = ("ld", "cp_async", "tma")
TERRAIN_BYTES = 86_100 * 128  # the terrain's nodes4_fi (11.0 MB, in the 50 MB L2)
PAST_L2_BYTES = 1 << 28  # 268 MB, 5x the L2
CARD_STEPS = 256  # steps per stream at card scale: 132 streams then read ~277 MB of 16-row pages
REPS = 5  # timed calls per run
COUNTER = LaunchCounter()


def fields_of(variant):
    """Rows of a page of TPU variant `variant` (12, or 16 for E, F, G)."""
    _check_variant(variant)
    return 16 if variant in ALIGNED else 12


def order_of(variant):
    """(data dependent, double buffered) of a TPU variant."""
    base = ALIGNED.get(variant, variant)
    return base in ("A", "B"), base == "D"


def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")


def pages(variant):
    """The TPU probe's table for `variant` (numpy, main_inproc):
    RandomState(0).randint(0, 3, (N_PAGES*F, 128)) as float32, integer
    valued so every sum is exact."""
    rng = np.random.RandomState(0)
    return rng.randint(0, 3, (N_PAGES * fields_of(variant), LANE)).astype(np.float32)


def card_table(nbytes, fields, device):
    """A table [n_pages*fields, 128] of integers 0..2 as float32: whole
    pages of `fields` rows within `nbytes`, made on `device` from seed 0."""
    rows = nbytes // (fields * LANE * 4) * fields
    g = torch.Generator(device=device).manual_seed(0)
    return torch.randint(0, 3, (rows, LANE), generator=g, device=device).to(torch.float32)


def _check(tab, variant, blocks, steps):
    f = fields_of(variant)
    check_tensor("tab", tab, torch.float32, (None, LANE))
    rows = tab.shape[0]
    if rows == 0 or rows % f or rows // f >= 2**31:
        raise ValueError(f"tab: {rows} rows is not a positive multiple of the page height {f}")
    if not 0 < blocks < 2**31 or not 0 < steps < 2**31:
        raise ValueError(f"blocks {blocks} and steps {steps} must be positive int32")
    return f, rows // f


def probe_stream_dma_plain(tab, variant, blocks=1, steps=STEPS, stats=None):
    """Plain version: every stream advanced one page per loop iteration.
    stats, a dict, receives "pages": a mask of the pages read."""
    f, n_pages = _check(tab, variant, blocks, steps)
    dyn, _ = order_of(variant)
    t = tab.view(n_pages, f, LANE)
    base = torch.arange(blocks, device=tab.device) * (n_pages // blocks)
    acc = torch.zeros((blocks, f, LANE), dtype=torch.float32, device=tab.device)
    seen = None
    if stats is not None:
        seen = stats["pages"] = torch.zeros(n_pages, dtype=torch.bool, device=tab.device)
    for i in range(steps):
        h = acc.sum((1, 2)).to(torch.int64).abs() if dyn else 0
        page = (base + h + 7 * i) % n_pages
        if seen is not None:
            seen[page] = True
        acc = acc + t[page]
    return acc if blocks > 1 else acc[0]


def regular_pages(n_pages, blocks, steps, device):
    """[blocks, steps] page ids of the regular order."""
    base = torch.arange(blocks, device=device)[:, None] * (n_pages // blocks)
    return (base + 7 * torch.arange(steps, device=device)[None, :]) % n_pages


def probe_stream_dma(tab, variant, copy, blocks=1, steps=STEPS):
    """Sums [F,128] (blocks = 1) or [blocks,F,128] f32 of `blocks` streams
    of `steps` pages of tab ([n_pages*F,128] f32, 16-byte aligned) in the
    order of TPU variant `variant`, each page fetched by construct `copy`.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if copy not in COPIES:
        raise ValueError(f"unknown copy {copy!r}; known: {COPIES}")
    f, n_pages = _check(tab, variant, blocks, steps)
    if tab.device.type == "cpu":
        return probe_stream_dma_plain(tab, variant, blocks, steps)
    if tab.device.type != "cuda":
        raise ValueError(f"probe_stream_dma: unsupported device {tab.device}")
    dyn, dbl = order_of(variant)
    out = torch.empty((blocks, f, LANE), dtype=torch.float32, device=tab.device)
    rc = library().lib.vkgr_probe_stream_dma(tab.data_ptr(), n_pages, f, COPIES.index(copy), int(dyn),
                                             int(dbl), blocks, steps, out.data_ptr(),
                                             torch.cuda.current_stream(tab.device).cuda_stream)
    check_launch(rc, "probe_stream_dma")
    COUNTER.launches += 1
    return out if blocks > 1 else out[0]


def run(device, steps=STEPS, card_steps=CARD_STEPS):
    """The probe on the card: every variant x copy construct at the TPU
    probe's size (one stream), then at card scale (one stream per SM) on a
    table of TERRAIN_BYTES and one of PAST_L2_BYTES. Each time is the mean
    of REPS calls. Returns one dict per run: label,
    variant, copy, tab, blocks, steps, out, ms, us_page (per page of one
    stream), gbs (pages read x page bytes over ms)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    runs = []

    def one(label, variant, copy, tab, blocks, nsteps):
        out = probe_stream_dma(tab, variant, copy, blocks, nsteps)
        ms = device_ms(lambda: probe_stream_dma(tab, variant, copy, blocks, nsteps), REPS)
        page_bytes = fields_of(variant) * LANE * 4
        runs.append(dict(label=label, variant=variant, copy=copy, tab=tab, blocks=blocks, steps=nsteps,
                         out=out, ms=ms, us_page=ms * 1e3 / nsteps,
                         gbs=blocks * nsteps * page_bytes / (ms * 1e-3) / 1e9))

    for variant in VARIANTS:
        tab = torch.tensor(pages(variant), device=device)
        for copy in COPIES:
            one(f"{variant} {copy} TPU size", variant, copy, tab, 1, steps)
    for nbytes in (TERRAIN_BYTES, PAST_L2_BYTES):
        tables = {f: card_table(nbytes, f, device) for f in (12, 16)}
        for variant in VARIANTS:
            for copy in COPIES:
                one(f"{variant} {copy} {nbytes / 1e6:.1f} MB x {sms} streams", variant, copy,
                    tables[fields_of(variant)], sms, card_steps)
    return runs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--card-steps", type=int, default=CARD_STEPS)
    args = ap.parse_args(argv)
    device = require_cuda("probe_stream_dma")
    print(f"[stream_dma] {torch.cuda.get_device_name(0)}; {args.steps} pages per stream at the TPU "
          f"size, {args.card_steps} at card scale", flush=True)
    for r in run(device, args.steps, args.card_steps):
        equal = torch.equal(r["out"], probe_stream_dma_plain(r["tab"], r["variant"], r["blocks"], r["steps"]))
        print(f"[stream_dma] {r['label']}: {r['ms']:.4f} ms, {r['us_page']:.3f} us per page, "
              f"{r['gbs']:.1f} GB/s, equal to plain: {equal}", flush=True)


if __name__ == "__main__":
    main()
