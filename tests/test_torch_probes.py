"""The port's probes (vk_gltf_renderer_tpu_torch/probes) against the
reference's TPU probes tools/exp_nodefetch.py and tools/exp_visit.py.

The TPU probes run as they are, through their own pallas_call, in Pallas
interpret mode on the CPU: pallas_call is patched to pass interpret=True
(nothing in tools/ changes), at reduced VISITS and GRID. Every variant of
both probes runs in interpret mode. The same inputs (the probes' own seeded
tables and rays) go through the port's plain versions, which the wrappers
take for CPU tensors.

Tolerances: the visit probe's output is integer (row + stack pointer) and
must be equal. The node-fetch accumulator is a float32 sum of `visits`
products in the same order on both sides, but XLA:CPU may contract
acc + (f1 - rox) * s into one fused multiply-add where torch rounds twice:
each step's rounding may differ by an ulp of the accumulator, so the sums
agree within visits * 2^-24 * max|acc| (measured: 7.4e-6 against a bound
of 9e-4 at 64 visits)."""

import contextlib
import functools
import importlib
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

ROOT = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def _tools_on_path():
    """tools/ on sys.path inside the block only. The restore also takes
    away what the imported modules insert themselves: tools/exp_visit.py
    inserts an absolute path of its own when it runs."""
    saved = list(sys.path)
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        yield
    finally:
        sys.path[:] = saved


with _tools_on_path():
    import exp_nodefetch  # noqa: E402
    import exp_visit  # noqa: E402
from vk_gltf_renderer_tpu.utils import tpu_bench  # noqa: E402
from vk_gltf_renderer_tpu_torch.probes import nodefetch as tnf  # noqa: E402
from vk_gltf_renderer_tpu_torch.probes import visit as tvis  # noqa: E402

VISITS, GRID = 64, 2


def test_tpu_probe_imports_leave_sys_path_as_it_was():
    """The TPU probes are imported as the module imports them, again: inside
    the block tools/ and the path tools/exp_visit.py inserts are on
    sys.path, and after it sys.path is the list it was before."""
    before = list(sys.path)
    with _tools_on_path():
        importlib.reload(exp_visit)  # runs the script's own sys.path.insert again
        inside = list(sys.path)
    assert inside[1] == str(ROOT / "tools") and len(inside) == len(before) + 2
    assert sys.path == before
    assert exp_visit.make_tables is not None and exp_nodefetch.mk is not None


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def test_nodefetch_inputs_are_the_tpu_probes():
    assert np.array_equal(tnf.tpu_table(), exp_nodefetch.tab16)
    for v in tnf.VARIANTS:
        tab = tnf.variant_table(tnf.tpu_table(), v)
        assert np.array_equal(tab, exp_nodefetch.tab16 if v == "a" else exp_nodefetch.tab128)
    assert (tnf.N, tnf.VISITS, tnf.GRID) == (exp_nodefetch.N, exp_nodefetch.VISITS,
                                             exp_nodefetch.GRID)


@pytest.mark.parametrize("variant", tnf.VARIANTS)
def test_nodefetch_plain_matches_tpu_probe(variant, interpret, monkeypatch):
    monkeypatch.setattr(exp_nodefetch, "VISITS", VISITS)
    monkeypatch.setattr(exp_nodefetch, "GRID", GRID)
    ro = np.random.RandomState(1).rand(GRID, 4, 8, 128).astype(np.float32)
    call, tab = exp_nodefetch.mk(variant)
    ref = np.asarray(call(tab, jnp.asarray(ro)))
    start = torch.zeros(GRID * 1024 // 32, dtype=torch.int32)
    port = tnf.probe_nodefetch(torch.tensor(tnf.variant_table(tnf.tpu_table(), variant)), start,
                               torch.tensor(tnf.tpu_rays(GRID * 1024)), VISITS)
    assert ref.shape == (GRID, 8, 128) and np.abs(ref).max() > 1.0
    np.testing.assert_allclose(port.numpy().reshape(GRID, 8, 128), ref, rtol=0,
                               atol=VISITS * 2.0**-24 * np.abs(ref).max())


def test_nodefetch_variants_are_one_computation():
    """The four TPU variants read the same bytes; the port returns one
    array for all of them, and counts the rows its chain reads."""
    tab = torch.tensor(tnf.tpu_table())
    start = torch.zeros(2 * 1024 // 32, dtype=torch.int32)
    rox = torch.tensor(tnf.tpu_rays(2 * 1024))
    outs = [tnf.probe_nodefetch(torch.tensor(tnf.variant_table(tab.numpy(), v)), start, rox, 200)
            for v in tnf.VARIANTS]
    assert all(torch.equal(o, outs[0]) for o in outs)
    assert torch.equal(tnf.probe_nodefetch(tab, start, rox, 200, block=32), outs[0])
    with pytest.raises(ValueError, match="block"):
        tnf.probe_nodefetch(tab, start, rox, 200, block=48)
    assert np.array_equal(tnf.tpu_rays(4224), tnf.tpu_rays(5 * 1024)[:4224])
    stats = {}
    tnf.probe_nodefetch_plain(tab, start, rox, 200, stats=stats)
    # one chain from row 0 through a random successor map: a few dozen rows
    assert 1 < int(stats["rows"].sum()) <= 200 and bool(stats["rows"][0])


def test_nodefetch_chain_tables_are_one_cycle():
    """chain_inputs links every row into one cycle, so chains never fall
    into a short loop that a cache would hold; each warp starts its own."""
    tab, start, rox = tnf.chain_inputs(1000, "cpu", lanes=1024)
    nxt = tab[:, 15].long()
    assert torch.equal(nxt.sort().values, torch.arange(1000))  # a permutation
    e, steps = int(nxt[0]), 1
    while e != 0:
        e, steps = int(nxt[e]), steps + 1
    assert steps == 1000
    assert start.shape == (32,) and start.dtype == torch.int32 and rox.shape == (1024,)
    stats = {}
    out = tnf.probe_nodefetch_plain(tab, start, rox, 50, stats=stats)
    assert out.shape == (1024,) and bool(torch.isfinite(out).all())
    assert int(stats["rows"].sum()) > 500  # 32 chains of 50 rows, few shared
    with pytest.raises(ValueError):
        tnf.chain_inputs(2**24, "meta")


@pytest.fixture(scope="module")
def tpu_visit():
    """Outputs of tools/exp_visit.py's own main() for every variant, in
    interpret mode at VISITS visits and GRID packets."""
    outs = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        m.setattr(tpu_bench, "timeit_device",
                  lambda g, *a, **k: (outs.append(np.asarray(g(*a))), 1.0)[1])
        m.setattr(sys, "argv", ["exp_visit.py", "--visits", str(VISITS), "--grid", str(GRID),
                                "--variants", ",".join(tvis.VARIANTS)])
        exp_visit.main()
    assert len(outs) == len(tvis.VARIANTS), "a variant failed in interpret mode"
    return dict(zip(tvis.VARIANTS, outs))


def test_visit_inputs_are_the_tpu_probes():
    fi, sc = exp_visit.make_tables()
    port_fi, port_sc = tvis.make_tables()
    assert np.array_equal(np.asarray(fi), port_fi) and np.array_equal(np.asarray(sc), port_sc)
    assert port_fi.dtype == np.float32 and port_sc.dtype == np.int32
    assert np.array_equal(tvis.make_rays(GRID),
                          np.random.RandomState(1).rand(GRID, 4, 8, 128).astype(np.float32))


@pytest.mark.parametrize("variant", sorted(tvis.VARIANTS))
def test_visit_plain_matches_tpu_probe(variant, tpu_visit):
    fi, sc = (torch.tensor(a) for a in tvis.make_tables())
    ro = torch.tensor(tvis.make_rays(GRID))
    port = tvis.probe_visit(fi, sc, ro, VISITS, variant)
    ref = tpu_visit[variant]
    assert ref.shape == port.shape == (GRID, 1, 8, 128)
    assert np.array_equal(port.numpy(), ref)


def test_visit_variants_agree_and_saturate():
    """a, b and c compute one result (codes from the row or the sidecar);
    the stack pointer saturates at its cap on a long chain; the
    interleaved variants start their chains at rows 0..ways-1."""
    fi, sc = (torch.tensor(a) for a in tvis.make_tables())
    ro = torch.tensor(tvis.make_rays(GRID))
    abc = [tvis.probe_visit_plain(fi, sc, ro, 400, v) for v in "abc"]
    assert all(torch.equal(o, abc[0]) for o in abc)
    stats = {}
    out = tvis.probe_visit_plain(fi, sc, ro, 400, "a", stats=stats)
    e = out[:, 0, 0, 0] - tvis.SP_CAP
    assert ((e >= 0) & (e < tvis.N)).all()  # sp == 200 after 400 visits
    assert 1 < int(stats["rows"].sum()) <= 400 and bool(stats["rows"][0])
    d = tvis.probe_visit_plain(fi, sc, ro, 2, "d")  # one step of two chains: rows 0 and 1
    c0 = sc[:, 0].long()
    votes = d[:, 0, 0, 0] - float(c0[0] % tvis.N + c0[1] % tvis.N) - tvis.SP_CAP // 2
    assert ((votes >= 0) & (votes <= 8)).all()


@pytest.mark.parametrize("probe", ["nodefetch", "visit"])
def test_probe_wrappers_refuse_other_devices(probe):
    if probe == "nodefetch":
        with pytest.raises(ValueError):
            tnf.probe_nodefetch(torch.zeros((16, 16), device="meta"),
                                torch.zeros(1, dtype=torch.int32, device="meta"),
                                torch.zeros(32, device="meta"), 4)
    else:
        with pytest.raises(ValueError):
            tvis.probe_visit(torch.zeros((8, 32), device="meta"),
                             torch.zeros((8, 8), dtype=torch.int32, device="meta"),
                             torch.zeros((1, 4, 8, 128), device="meta"), 4, "a")
    with pytest.raises(ValueError, match="unknown variant"):
        tnf.variant_table(tnf.tpu_table(64), "e") if probe == "nodefetch" else tvis.probe_visit(
            None, None, torch.zeros((1, 4, 8, 128)), 4, "z")


def test_every_c_entry_point_has_its_ctypes_signature():
    """Each extern "C" entry point of csrc/*.cu is bound with argument types
    matching its C parameters (a pointer passed without them is cut to 32
    bits): pointers as c_void_p, int as c_int, int64_t as c_int64."""
    import ctypes
    import re

    from vk_gltf_renderer_tpu_torch import cuda_lib

    kinds = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "int64_t": ctypes.c_int64}
    found = {}
    for src in sorted(cuda_lib._CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (vkgr_\w+)\(([^)]*)\)', src.read_text()):
            found[name] = [kinds["ptr" if "*" in p else p.split()[-2]] for p in params.split(",")]
    assert found.keys() == cuda_lib._SIGNATURES.keys()
    for name, argtypes in found.items():
        assert cuda_lib._SIGNATURES[name] == argtypes, name
