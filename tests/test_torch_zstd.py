"""The port's hand-written zstd decoder (`native/zstd.cc`) against the
`zstandard` package, its CRC32C, and the raw-block frames the orbax writer
makes without it."""

import numpy as np
import pytest
import zstandard

from audio_classification_icbhi_tpu_torch import native
from audio_classification_icbhi_tpu_torch.utils import orbax_format

LEVELS = (-5, 1, 3, 9, 19, 22)
SIZES = (0, 1, 131_071, 131_072, 131_073, 1 << 20)


def content(kind: str, size: int, seed: int = 0) -> bytes:
    """Random bytes, repetitive bytes (runs, a repeated phrase, a small
    alphabet), alternating copies (runs copied from 1000, 2000, 3000 and
    1500 bytes back in turn, mostly with no literal between: the repeat
    offsets at a literal length of 0) or f32 weights: Gaussian values of a
    conv layer's scale."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.bytes(size)
    if kind == "alternating":
        out = bytearray(rng.bytes(min(size, 4096)))
        k = 0
        while len(out) < size:
            back = (1000, 2000, 3000)[k % 3] if k % 5 else 1500
            start = len(out) - back
            out += out[start:start + int(rng.integers(8, 40))]
            if k % 7 == 0:
                out += rng.bytes(int(rng.integers(1, 4)))
            k += 1
        return bytes(out[:size])
    if kind == "repetitive":
        parts = [b"wheeze crackle normal " * 40, bytes(300), b"\x07" * 257,
                 rng.integers(0, 4, 2000, dtype=np.uint8).tobytes()]
        out = b"".join(parts[i % 4] for i in range(size // 2000 + 4))
        return out[:size]
    weights = (rng.standard_normal(size // 4 + 1) * 0.05).astype(np.float32)
    return weights.tobytes()[:size]


def decode(frame: bytes, size: int) -> bytes:
    return native.zstd_decompress(frame, size).tobytes()


@pytest.mark.parametrize("kind", ["random", "repetitive", "alternating", "weights"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("level", LEVELS)
def test_decoder_matches_zstandard(level, size, kind):
    """Every level, block-edge size and kind of content, with the content
    checksum and the content size each on and off."""
    data = content(kind, size, seed=level + 5 + size)
    for checksum in (True, False):
        for with_size in (True, False):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                             write_content_size=with_size).compress(data)
            assert decode(frame, len(data)) == data, (checksum, with_size)


def test_streamed_frames_without_single_segment():
    """A frame written by the streaming API (a window descriptor, no
    content size, several compressed blocks reusing tables and offsets)."""
    data = content("repetitive", 700_000) + content("weights", 300_000)
    cctx = zstandard.ZstdCompressor(level=3, write_checksum=True)
    frame = b"".join(cctx.read_to_iter(data, read_size=65536))
    assert decode(frame, len(data)) == data


def test_concatenated_and_skippable_frames():
    a, b = content("weights", 200_000), content("repetitive", 50_000)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    frames = (zstandard.compress(a, 3) + skippable
              + zstandard.ZstdCompressor(level=19, write_checksum=True).compress(b)
              + orbax_format.zstd_raw_frame(b"tail"))
    assert decode(frames, len(a) + len(b) + 4) == a + b + b"tail"
    # offsets never reach back into an earlier frame
    assert decode(zstandard.compress(b, 1) * 3, 3 * len(b)) == b * 3


def test_wrong_size_raises():
    data = content("weights", 10_000)
    frame = zstandard.compress(data, 3)
    with pytest.raises(ValueError, match="larger than expected"):
        decode(frame, len(data) - 1)
    with pytest.raises(ValueError, match="expected"):
        decode(frame, len(data) + 1)


@pytest.mark.parametrize("checksum", [True, False])
def test_truncated_frames_raise(checksum):
    data = content("weights", 300_000)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=checksum).compress(data)
    for cut in [0, 1, 4, 5, 6, 9, 100, len(frame) // 2, len(frame) - 5, len(frame) - 1]:
        with pytest.raises(ValueError):
            decode(frame[:cut], len(data))


@pytest.mark.parametrize("level", [1, 19])
def test_bit_flips_raise_or_decode_exactly(level):
    """A flipped bit anywhere in a checksummed frame: ValueError, or (a bit
    the decoder does not read, as in the window descriptor) the exact
    content. Never a crash, never other bytes."""
    data = content("weights", 40_000) + content("repetitive", 40_000)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
    rng = np.random.default_rng(level)
    raised = 0
    for bit in rng.choice(len(frame) * 8, size=400, replace=False):
        bad = bytearray(frame)
        bad[bit // 8] ^= 1 << (bit % 8)
        try:
            got = decode(bytes(bad), len(data))
        except ValueError:
            raised += 1
            continue
        assert got == data, bit
    assert raised > 390


def test_bit_flips_without_checksum_never_crash():
    data = content("repetitive", 100_000)
    frame = zstandard.compress(data, 9)
    rng = np.random.default_rng(1)
    for bit in rng.choice(len(frame) * 8, size=400, replace=False):
        bad = bytearray(frame)
        bad[bit // 8] ^= 1 << (bit % 8)
        try:
            assert len(decode(bytes(bad), len(data))) == len(data)
        except ValueError:
            pass


def test_dictionary_frame_raises():
    samples = [content("repetitive", 2000, seed=i) + bytes([i]) * 50 for i in range(200)]
    dictionary = zstandard.train_dictionary(4096, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(samples[0])
    with pytest.raises(ValueError, match="dictionary"):
        decode(frame, len(samples[0]))


@pytest.mark.parametrize("size", [0, 1, 255, 256, 65_791, 65_792, 131_072, 131_073, 400_000])
def test_raw_block_frames(size):
    """The writer's raw-block frames decode in `zstandard` (which needs the
    content size from the header) and in the port's decoder."""
    data = content("random", size)
    frame = orbax_format.zstd_raw_frame(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert decode(frame, size) == data


def test_crc32c():
    assert native.crc32c(b"123456789") == 0xE3069283
    assert orbax_format.crc32c_py(b"123456789") == 0xE3069283
    data = content("random", 100_003)
    assert native.crc32c(data) == orbax_format.crc32c_py(data)
    assert native.crc32c(data[40_000:], native.crc32c(data[:40_000])) == native.crc32c(data)
    assert native.crc32c(b"") == 0


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No fallback: a decoder that does not build makes every read raise,
    naming g++'s error; writing needs no library."""
    broken = tmp_path / "zstd.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "ZSTD_SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    frame = zstandard.compress(b"x" * 100)
    with pytest.raises(RuntimeError, match="could not build zstd.cc") as caught:
        native.zstd_decompress(frame, 100)
    assert "error" in str(caught.value)
    path = orbax_format.save(tmp_path / "ckpt", {"w": np.ones(3, np.float32), "epoch": 1})
    with pytest.raises(RuntimeError, match="could not build zstd.cc"):
        orbax_format.load(path)


def test_library_lives_under_build():
    lib = native.build(native.ZSTD_SRC)
    assert lib.parent == native.BUILD_DIR and lib.name.startswith("zstd-")
