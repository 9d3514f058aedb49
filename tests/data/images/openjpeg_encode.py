"""OpenJPEG's own encoder (the libopenjp2 that Pillow's wheel bundles),
called through ctypes, for the JPEG 2000 fixtures that Pillow's save
cannot be asked to write: code-block style bits, SOP and EPH markers, a
region of interest, progression order changes, subsampled components.

Only tests/data/images/make_fixtures.py uses it; the port never loads
libopenjp2. The offsets of opj_cparameters_t's fields are those of
OpenJPEG 2.5 on x86-64 (checked below against the defaults that
opj_set_default_encoder_parameters writes); encode() checks what it asked
for in the codestream it gets back (COD's style byte, SOP, EPH, RGN,
POC, SIZ's subsampling).
"""

import ctypes
import struct
import tempfile
from pathlib import Path

import numpy as np

_PARAMS_SIZE = 18720
_OFF = {"csty": 48, "prog_order": 52, "poc": 56, "numpocs": 4792, "tcp_numlayers": 4796, "tcp_rates": 4800,
        "numresolution": 5600, "cblockw_init": 5604, "cblockh_init": 5608, "mode": 5612, "irreversible": 5616,
        "roi_compno": 5620, "roi_shift": 5624, "res_spec": 5628, "prcw_init": 5632, "prch_init": 5764,
        "subsampling_dx": 18196, "decod_format": 18204, "cp_disto_alloc": 20, "tp_on": 18696, "tp_flag": 18697,
        "tcp_mct": 18698, "tile_size_on": 0, "cp_tdx": 12, "cp_tdy": 16}
_POC_SIZE = 148  # opj_poc_t: resno0, compno0, layno1, resno1, compno1, layno0, precno0, precno1, prg1, prg, ...
_PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


def _lib():
    import PIL

    libs = sorted((Path(PIL.__file__).resolve().parent.parent / "pillow.libs").glob("libopenjp2*"))
    if not libs:
        raise RuntimeError("no libopenjp2 beside Pillow")
    lib = ctypes.CDLL(str(libs[0]))
    for name in ("opj_create_compress", "opj_image_create", "opj_stream_create_default_file_stream"):
        getattr(lib, name).restype = ctypes.c_void_p
    lib.opj_image_create.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int]
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for name in ("opj_setup_encoder", "opj_start_compress"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    for name in ("opj_encode", "opj_end_compress"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.opj_stream_destroy.argtypes = [ctypes.c_void_p]
    lib.opj_destroy_codec.argtypes = [ctypes.c_void_p]
    lib.opj_image_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _params(lib):
    buf = ctypes.create_string_buffer(_PARAMS_SIZE)
    lib.opj_set_default_encoder_parameters(buf)
    ints = lambda off: struct.unpack_from("<i", buf.raw, off)[0]  # noqa: E731
    assert (ints(_OFF["numresolution"]), ints(_OFF["cblockw_init"]), ints(_OFF["roi_compno"]),
            ints(_OFF["subsampling_dx"]), ints(_OFF["decod_format"])) == (6, 64, -1, 1, -1), "opj_cparameters_t"
    return buf


def _put(buf, name, value, fmt="<i", index=0):
    struct.pack_into(fmt, buf, _OFF[name] + index * struct.calcsize(fmt), value)


def encode(planes, sub=None, signed=False, prec=8, irreversible=False, numres=6, cblk=(64, 64), mode=0, sop=False,
           eph=False, roi=None, pocs=(), prog="LRCP", precincts=None, rates=None, mct=0, tiles=None, tile_parts=None):
    """A raw codestream of `planes` (uint arrays [h_c, w_c], component c
    subsampled by sub[c] = (dx, dy)) as OpenJPEG writes it. mode: the
    code-block style bits (1 bypass, 2 reset, 4 terminate each pass, 8
    vertically causal, 16 predictable termination, 32 segmentation
    symbols); roi: (component, shift); pocs: (resno0, compno0, layno1,
    resno1, compno1, progression) each; precincts: [(w, h)] from the
    highest resolution down; rates: the quality layers' compression
    ratios (lossless, one layer, when None); tiles: (width, height);
    tile_parts: "R", "L" or "C", a tile-part for each resolution, layer or
    component."""
    lib = _lib()
    n = len(planes)
    sub = sub or [(1, 1)] * n
    h0, w0 = planes[0].shape
    dx0, dy0 = sub[0]
    W, H = w0 * dx0, h0 * dy0
    cmpt = (ctypes.c_uint32 * (9 * n))()
    for c, ((dx, dy), p) in enumerate(zip(sub, planes)):
        h, w = p.shape
        assert (w, h) == (-(-W // dx), -(-H // dy)), "component size"
        cmpt[9 * c: 9 * c + 9] = [dx, dy, w, h, 0, 0, prec, prec, int(signed)]
    img = lib.opj_image_create(n, cmpt, 1 if n >= 3 else 2)
    head = (ctypes.c_uint32 * 4).from_address(img)
    head[:] = [0, 0, W, H]
    comps = ctypes.c_void_p.from_address(img + 24).value
    for c, p in enumerate(planes):
        data = ctypes.c_void_p.from_address(comps + 64 * c + 48).value
        arr = np.ctypeslib.as_array((ctypes.c_int32 * p.size).from_address(data))
        arr[:] = p.astype(np.int64).reshape(-1)
    buf = _params(lib)
    _put(buf, "numresolution", numres)
    _put(buf, "cblockw_init", cblk[0])
    _put(buf, "cblockh_init", cblk[1])
    _put(buf, "mode", mode)
    _put(buf, "irreversible", int(irreversible))
    _put(buf, "prog_order", _PROG[prog])
    _put(buf, "csty", (2 if sop else 0) | (4 if eph else 0))
    _put(buf, "tcp_mct", mct, "<b")
    if tiles:
        _put(buf, "tile_size_on", 1)
        _put(buf, "cp_tdx", tiles[0])
        _put(buf, "cp_tdy", tiles[1])
    if tile_parts:
        _put(buf, "tp_on", 1, "<b")
        _put(buf, "tp_flag", ord(tile_parts), "<b")
    if roi is not None:
        _put(buf, "roi_compno", roi[0])
        _put(buf, "roi_shift", roi[1])
    if precincts:
        _put(buf, "res_spec", len(precincts))
        for i, (pw, ph) in enumerate(precincts):
            _put(buf, "prcw_init", pw, index=i)
            _put(buf, "prch_init", ph, index=i)
        _put(buf, "csty", (2 if sop else 0) | (4 if eph else 0) | 1)
    layers = rates or [0.0]
    _put(buf, "tcp_numlayers", len(layers))
    for i, r in enumerate(layers):
        _put(buf, "tcp_rates", float(r), "<f", i)
    _put(buf, "cp_disto_alloc", 1)
    for i, (r0, c0, l1, r1, c1, pg) in enumerate(pocs):
        base = _OFF["poc"] + i * _POC_SIZE
        struct.pack_into("<5I", buf, base, r0, c0, l1, r1, c1)
        struct.pack_into("<i", buf, base + 32, _PROG[pg])  # prg1
        struct.pack_into("<I", buf, base + 48, 1)  # tile: the first (and only) tile, counted from 1
    _put(buf, "numpocs", len(pocs))
    codec = lib.opj_create_compress(0)
    try:
        assert lib.opj_setup_encoder(codec, buf, img), "opj_setup_encoder"
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "x.j2k"
            stream = lib.opj_stream_create_default_file_stream(str(path).encode(), 0)
            ok = lib.opj_start_compress(codec, img, stream) and lib.opj_encode(codec, stream) and \
                lib.opj_end_compress(codec, stream)
            lib.opj_stream_destroy(stream)
            assert ok, "opj_encode"
            cs = path.read_bytes()
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
    cod = cs.index(b"\xff\x52")
    assert cs[cod + 12] == mode, "COD's code-block style"
    assert bool(cs[cod + 4] & 2) == sop and bool(cs[cod + 4] & 4) == eph, "COD's SOP / EPH flags"
    assert (b"\xff\x91" in cs) == sop and (roi is None or b"\xff\x5e" in cs) and (not pocs or b"\xff\x5f" in cs)
    assert [tuple(cs[42 + 3 * c + 1: 42 + 3 * c + 3]) for c in range(n)] == [tuple(s) for s in sub], "SIZ"
    assert not tile_parts or cs[cs.index(b"\xff\x90") + 11] > 1, "TNsot"
    return cs
