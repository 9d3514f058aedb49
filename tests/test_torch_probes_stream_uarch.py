"""The port's stream-copy and micro-op probes
(vk_gltf_renderer_tpu_torch/probes/stream_dma.py, uarch.py) against the
reference's TPU probes tools/exp_stream_dma.py and tools/uarch_probe.py,
run as they are in Pallas interpret mode on the CPU.

exp_stream_dma._build switches itself to interpret mode on the CPU.
uarch_probe.py runs its eight kernels when it is executed and has no
interpret switch, so it runs through runpy with pl.pallas_call patched to
pass interpret=True and tpu_bench.timeit_device patched to collect each
kernel's output (nothing in tools/ changes), at its full N_Iter.

Tolerances: every stream sum is an integer below 2**24 and must be equal.
Every micro-op output must be equal except vec1's: acc * 1.000001 + 0.5,
20000 times, which torch rounds twice per step (as the card does under
-fmad=false) while XLA:CPU may contract it into one fused multiply-add.
The two may then differ by half an ulp of acc per step, at most
iters * 2^-24 * max|acc| = 12.2 in all; the measured gap is 0.00195. The
test holds them within VEC1_ATOL = 0.05, a tenth of the 0.5 that one step
adds, so a plain loop that takes a step too many or too few fails."""

import functools
import runpy
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import exp_stream_dma  # noqa: E402
from vk_gltf_renderer_tpu.utils import tpu_bench  # noqa: E402
from vk_gltf_renderer_tpu_torch.probes import stream_dma as tsd  # noqa: E402
from vk_gltf_renderer_tpu_torch.probes import uarch as tua  # noqa: E402

VEC1_ATOL = 0.05  # vec1's gap to XLA:CPU (measured 0.00195), under a tenth of one step's 0.5


def test_stream_inputs_are_the_tpu_probes():
    assert (tsd.LANE, tsd.N_PAGES, tsd.STEPS) == (exp_stream_dma.LANE, exp_stream_dma.N_PAGES,
                                                 exp_stream_dma.STEPS)
    assert tsd.ALIGNED == exp_stream_dma.ALIGNED
    for v in tsd.VARIANTS:
        f = exp_stream_dma.fields_of(v)
        assert tsd.fields_of(v) == f
        rng = np.random.RandomState(0)
        tpu = rng.randint(0, 3, (exp_stream_dma.N_PAGES * f, exp_stream_dma.LANE)).astype(np.float32)
        assert np.array_equal(tsd.pages(v), tpu) and tpu.shape[0] in (768, 1024)


@pytest.mark.parametrize("variant", tsd.VARIANTS)
def test_stream_plain_matches_tpu_probe(variant):
    tab = tsd.pages(variant)
    ref = np.asarray(exp_stream_dma._build(variant)(jnp.asarray(tab)))
    assert np.array_equal(ref, exp_stream_dma._expected(variant, tab))
    for copy in tsd.COPIES:
        port = tsd.probe_stream_dma(torch.tensor(tab), variant, copy)
        assert port.shape == ref.shape == (tsd.fields_of(variant), 128)
        assert np.array_equal(port.numpy(), ref)


@pytest.mark.parametrize("variant", tsd.VARIANTS)
def test_stream_card_scale_starts_with_the_tpu_probe(variant):
    """With more blocks, stream 0 is still the TPU probe (page 0 first, the
    table's page count as modulus); in the regular order the streams equal
    one index_select of their pages and a sum; any table of whole pages
    runs."""
    tab = torch.tensor(tsd.pages(variant))
    f = tsd.fields_of(variant)
    one = tsd.probe_stream_dma(tab, variant, "tma", blocks=1)
    stats = {}
    many = tsd.probe_stream_dma_plain(tab, variant, blocks=4, stats=stats)
    assert many.shape == (4, f, 128)
    assert torch.equal(many[0], one)  # stream 0 starts at page 0, the modulus stays n_pages
    dyn, _ = tsd.order_of(variant)
    if not dyn:  # the regular order: stream b = pages b*16 + 7i, summed in one call
        idx = tsd.regular_pages(tsd.N_PAGES, 4, tsd.STEPS, "cpu")
        lib = tab.view(-1, f, 128).index_select(0, idx.reshape(-1)).view(4, tsd.STEPS, f, 128).sum(1)
        assert torch.equal(lib, many)
        assert int(stats["pages"].sum()) == tsd.N_PAGES  # 4 offsets x 48 steps cover every page
    big = tsd.card_table(200 * f * 512, f, "cpu")
    assert big.shape == (200 * f, 128) and set(big.unique().tolist()) <= {0.0, 1.0, 2.0}
    out = tsd.probe_stream_dma(big, variant, "cp_async", blocks=5, steps=30)
    assert out.shape == (5, f, 128) and float(out.sum()) > 0


def test_stream_wrapper_refuses():
    tab = torch.tensor(tsd.pages("A"))
    with pytest.raises(ValueError, match="unsupported device"):
        tsd.probe_stream_dma(torch.zeros((768, 128), device="meta"), "A", "tma")
    with pytest.raises(ValueError, match="unknown variant"):
        tsd.probe_stream_dma(tab, "H", "tma")
    with pytest.raises(ValueError, match="unknown copy"):
        tsd.probe_stream_dma(tab, "A", "dma")
    with pytest.raises(ValueError, match="16-byte aligned"):
        tsd.probe_stream_dma(torch.zeros(768 * 128 + 1)[1:].view(768, 128), "A", "tma")
    with pytest.raises(ValueError, match="page height"):
        tsd.probe_stream_dma(tab[:100], "A", "ld")
    with pytest.raises(ValueError, match="page height"):
        tsd.probe_stream_dma(tab[:24], "E", "ld")  # 24 rows: two 12-row pages, not whole 16-row ones
    with pytest.raises(ValueError, match="positive"):
        tsd.probe_stream_dma(tab, "C", "ld", blocks=0)
    with pytest.raises(TypeError):
        tsd.probe_stream_dma(tab.double(), "C", "ld")


@pytest.fixture(scope="module")
def tpu_uarch():
    """Outputs of tools/uarch_probe.py's eight kernels, in its order, in
    interpret mode at its full N_Iter, and its module globals."""
    outs = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sys, "path", list(sys.path))  # undoes the script's own sys.path.insert
        m.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        m.setattr(tpu_bench, "timeit_device", lambda g, *a, **k: (outs.append(np.asarray(g(*a))), 1.0)[1])
        glb = runpy.run_path(str(ROOT / "tools" / "uarch_probe.py"))
    assert len(outs) == len(tua.OPS), "a kernel failed in interpret mode"
    return dict(zip(tua.OPS, outs)), glb


def test_uarch_inputs_are_the_tpu_probes(tpu_uarch):
    _, glb = tpu_uarch
    tab, big, big128 = tua.inputs()
    for port, name in ((tab, "tab"), (big, "big"), (big128, "big128")):
        assert port.dtype == np.float32 and np.array_equal(np.asarray(glb[name]), port)
    assert np.array_equal(np.asarray(glb["_mkidx"]()), tua.mkidx())
    assert glb["N_Iter"] == tua.N_ITER


@pytest.mark.parametrize("op", tua.OPS)
def test_uarch_plain_matches_tpu_probe(op, tpu_uarch):
    ref = tpu_uarch[0][op]
    tab, big, big128 = (torch.tensor(x) for x in tua.inputs())
    port, cycles = tua.probe_uarch(op, tab, tua.table_of(op, big, big128))
    assert cycles is None and port.shape == ref.shape == (8, 128)
    if op == "vec1":
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=VEC1_ATOL)
        assert np.abs(ref).max() > 1e4  # 20000 steps of + 0.5
    else:
        assert np.array_equal(port.numpy(), ref)
    if op == "gather12":
        assert np.abs(ref).max() > 2**24  # past exact integers: equal only with one add order


def test_uarch_wrapper_refuses():
    tab, big, big128 = (torch.tensor(x) for x in tua.inputs())
    with pytest.raises(ValueError, match="unsupported device"):
        tua.probe_uarch("vec1", tab.to("meta"), big.to("meta"), 10)
    with pytest.raises(ValueError, match="unknown op"):
        tua.probe_uarch("fma", tab, big, 10)
    with pytest.raises(ValueError, match="shape"):
        tua.probe_uarch("dynslice128", tab, big, 10)  # needs the [R,128] table
    with pytest.raises(ValueError, match="rows"):
        tua.probe_uarch("dynslice", tab, big[:100], 10)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tua.probe_uarch("empty", torch.zeros(1025)[1:].view(8, 128), big, 10)
    # a few steps by hand: reduce's sum is positive, so it counts one per step
    assert torch.equal(tua.probe_uarch_plain("reduce", tab, big, 3), tab * 1.000001 * 1.000001 * 1.000001)
    assert torch.equal(tua.probe_uarch_plain("dynslice128", tab, big128, 2), tab + big128[0] + big128[1])
