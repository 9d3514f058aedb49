"""The port's Zstandard decoder (native/zstd_decode.cpp through
ops/zstd.py, what ops/tiff.py reads compression 50000 with) against the
zstandard package on the CPU, byte for byte.

- Seeded inputs (smooth image rows, text, incompressible bytes, long runs)
  at levels 1, 3, 9 and 19, with and without the content checksum and the
  content size: raw, RLE and compressed blocks, Huffman literals in one
  and four streams, treeless literals and every sequence table mode turn
  up among them.
- Inputs past 128 KiB (several blocks), streamed frames (no content
  size), two frames with a skippable frame between them, an empty frame.
- A truncated, a corrupted and a wrongly checksummed stream raise
  ValueError; so does a frame larger than the room given; random bit
  flips never crash the decoder (every read is bounds-checked).

zstandard is only a reference here: the port never imports it
(tests/test_torch_nojax.py)."""

import numpy as np
import pytest

zstandard = pytest.importorskip("zstandard")

from vk_gltf_renderer_tpu_torch.ops.zstd import decompress  # noqa: E402


def _inputs():
    rng = np.random.default_rng(2026)
    y, x = np.mgrid[0:300, 0:700]
    image = np.clip(128 + 60 * np.sin(x / 23.0) * np.cos(y / 17.0) + rng.normal(0, 4, x.shape), 0, 255)
    words = [b"texture", b"mip", b"gather", b"traverse", b"frame", b"zstd", b"tile", b"strip"]
    text = b" ".join(words[i] for i in rng.integers(0, len(words), 40000))
    return {
        "image_rows": image.astype(np.uint8).tobytes(),  # 210,000 bytes: two blocks and more
        "text": text,
        "incompressible": rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes(),
        "runs": bytes(70_000) + b"\x07" * 90_000 + bytes(rng.integers(0, 3, 5000, dtype=np.uint8)),
        "small": b"abcabcabcabcabd",
        "empty": b"",
    }


INPUTS = _inputs()


@pytest.mark.parametrize("checksum", [False, True], ids=["no_checksum", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 9, 19])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decodes_as_zstandard(name, level, checksum):
    data = INPUTS[name]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert decompress(frame, len(data)) == data
    streamed = zstandard.ZstdCompressor(level=level, write_checksum=checksum, write_content_size=False)
    assert decompress(streamed.compress(data), len(data)) == data


def test_streamed_blocks_and_several_frames():
    data = INPUTS["image_rows"]
    obj = zstandard.ZstdCompressor(level=5).compressobj()
    chunked = obj.compress(data[:70_000]) + obj.compress(data[70_000:]) + obj.flush()
    assert decompress(chunked, len(data)) == data
    skippable = (0x184D2A5E).to_bytes(4, "little") + (6).to_bytes(4, "little") + b"ignore"
    second = zstandard.ZstdCompressor(level=19, write_checksum=True).compress(INPUTS["text"][:9000])
    both = zstandard.ZstdCompressor(level=3).compress(data) + skippable + second
    assert decompress(both, len(data) + 9000) == data + INPUTS["text"][:9000]
    assert decompress(skippable + zstandard.ZstdCompressor().compress(b""), 0) == b""


def test_faults_raise_value_error():
    data = INPUTS["image_rows"]
    frame = zstandard.ZstdCompressor(level=9, write_checksum=True).compress(data)
    with pytest.raises(ValueError, match="truncated"):
        decompress(frame[: len(frame) // 2], len(data))
    corrupt = bytearray(frame)
    corrupt[len(corrupt) // 2] ^= 0x5A
    with pytest.raises(ValueError):
        decompress(bytes(corrupt), len(data))
    wrong_sum = bytearray(frame)
    wrong_sum[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        decompress(bytes(wrong_sum), len(data))
    with pytest.raises(ValueError, match="more data"):
        decompress(frame, len(data) - 1)
    with pytest.raises(ValueError):
        decompress(b"not a zstd frame at all", 100)
    dictionary = bytearray(zstandard.ZstdCompressor(level=3).compress(b"x" * 100))
    dictionary[4] |= 1  # a dictionary ID flag: libtiff never writes one
    with pytest.raises(ValueError):
        decompress(bytes(dictionary), 1000)


def test_random_damage_never_crashes():
    """Bit flips and cuts in seeded frames: each decode returns the data or
    raises ValueError; none reads out of bounds (the process survives)."""
    rng = np.random.default_rng(7)
    frames = [zstandard.ZstdCompressor(level=lvl, write_checksum=bool(lvl % 2)).compress(d)
              for lvl in (1, 3, 19) for d in (INPUTS["text"][:30_000], INPUTS["image_rows"][:50_000])]
    outcomes = {"decoded": 0, "refused": 0}
    for i in range(1500):
        damaged = bytearray(frames[i % len(frames)])
        for _ in range(int(rng.integers(1, 4))):
            pos = int(rng.integers(0, len(damaged)))
            damaged[pos] ^= 1 << int(rng.integers(0, 8))
        if rng.random() < 0.2:
            damaged = damaged[: int(rng.integers(0, len(damaged)))]
        try:
            decompress(bytes(damaged), 1 << 17)
            outcomes["decoded"] += 1
        except ValueError:
            outcomes["refused"] += 1
    assert outcomes["refused"] > 0 and sum(outcomes.values()) == 1500
