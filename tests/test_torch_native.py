"""The port's native WAV decoder against its numpy codec and the JAX
package's decoder, and the datasets' batch load against the JAX loader.

Every format the decoders take (PCM 8/16/24/32, IEEE float32/64, each also
as WAVE_FORMAT_EXTENSIBLE) at 1 and 2 channels, written from numpy draws of
a seed. Decodes are compared bit for bit. The port's library is its own
build of its own source under build/native/; the JAX decoder is the JAX
package's.
"""

import shutil
import struct
import warnings

import numpy as np
import pytest

from audio_classification_icbhi_tpu import native as jax_native
from audio_classification_icbhi_tpu.data import wavio as jax_wavio
from audio_classification_icbhi_tpu.data.dataset import ICBHIDataset as JaxDataset
from audio_classification_icbhi_tpu.data.dataset_segmented import (
    ICBHISegmentedDataset as JaxSegmented,
)
from audio_classification_icbhi_tpu_torch import native
from audio_classification_icbhi_tpu_torch.data import synthetic, wavio
from audio_classification_icbhi_tpu_torch.data.dataset import ICBHIDataset
from audio_classification_icbhi_tpu_torch.data.dataset_segmented import ICBHISegmentedDataset
from audio_classification_icbhi_tpu_torch.data.loader import BatchLoader

FORMATS = [(1, 8), (1, 16), (1, 24), (1, 32), (3, 32), (3, 64)]  # (format code, bits)


def wav_bytes(x: np.ndarray, sr: int, code: int, bits: int, extensible: bool) -> bytes:
    """A RIFF/WAVE file of (channels, n) samples in [-1, 1): PCM `bits` or
    IEEE float, with an EXTENSIBLE fmt chunk (sub-format at its offset 24)
    when asked, and a LIST chunk before fmt."""
    ch = x.shape[0]
    inter = x.T.reshape(-1)
    if code == 3:
        payload = inter.astype("<f4" if bits == 32 else "<f8").tobytes()
    elif bits == 8:
        payload = np.clip(np.round(inter * 128 + 128), 0, 255).astype(np.uint8).tobytes()
    elif bits == 24:
        v = np.clip(np.round(inter * 2**23), -2**23, 2**23 - 1).astype(np.int32)
        b = v.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3]
        payload = b.tobytes()
    else:
        dt = {16: "<i2", 32: "<i4"}[bits]
        payload = np.clip(np.round(inter * 2.0 ** (bits - 1)), -2.0 ** (bits - 1),
                          2.0 ** (bits - 1) - 1).astype(dt).tobytes()
    block = ch * bits // 8
    fmt = struct.pack("<HHIIHH", 0xFFFE if extensible else code, ch, sr, sr * block, block,
                      bits)
    if extensible:
        fmt += struct.pack("<HHI", 22, bits, 0) + struct.pack("<H", code) + bytes(14)
    body = b"WAVE" + b"LIST" + struct.pack("<I", 4) + b"INFO"
    body += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    body += b"data" + struct.pack("<I", len(payload)) + payload + bytes(len(payload) & 1)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("extensible", [False, True], ids=["plain", "extensible"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("code,bits", FORMATS)
def test_decode_mono_bit_equal(tmp_path, code, bits, channels, extensible):
    """native.decode_mono == the port's numpy codec == the JAX decoder, bit
    for bit; and the JAX numpy fallback, except float64 at two channels,
    where it rounds each channel to f32 before the mean (one ulp)."""
    rng = np.random.default_rng(code * 100 + bits + 10 * channels + extensible)
    x = 0.4 * rng.standard_normal((channels, 3001))
    path = tmp_path / "x.wav"
    path.write_bytes(wav_bytes(x, 11025, code, bits, extensible))
    got, sr = native.decode_mono(path)
    numpy_mono, numpy_sr = wavio.decode_mono_numpy(path)
    jax_mono, jax_sr = jax_native.decode_mono(path)
    assert sr == numpy_sr == jax_sr == 11025 and got.dtype == np.float32
    assert got.shape == (3001,)
    np.testing.assert_array_equal(got, numpy_mono)
    np.testing.assert_array_equal(got, jax_mono)
    ref, _ = jax_wavio.read_wav(path)
    jax_fallback = ref.mean(axis=0) if channels > 1 else ref[0]
    if (code, bits, channels) == (3, 64, 2):
        assert np.abs(got - jax_fallback).max() <= np.spacing(np.abs(got)).max()
    else:
        np.testing.assert_array_equal(got, jax_fallback)
    np.testing.assert_array_equal(wavio.read_wav(path)[0], ref)  # the codec itself


def test_decode_batch_pads_and_crops(tmp_path):
    """decode_batch == wavio.pad_or_crop of each file, in 2 threads."""
    rng = np.random.default_rng(1)
    lengths = [3000, 6000, 9000, 9001, 1]
    paths = []
    for i, n in enumerate(lengths):
        paths.append(tmp_path / f"f{i}.wav")
        wavio.write_wav(paths[-1], (0.2 * rng.standard_normal(n)).astype(np.float32), 16000)
    batch, srs, lens = native.decode_batch(paths, 6000, n_threads=2)
    assert batch.shape == (5, 6000) and list(srs) == [16000] * 5 and list(lens) == lengths
    for row, p in zip(batch, paths):
        np.testing.assert_array_equal(row, wavio.pad_or_crop(wavio.read_wav(p)[0][0], 6000))
    jax_batch, _, _ = jax_native.decode_batch(paths, 6000, n_threads=2)
    np.testing.assert_array_equal(batch, jax_batch)


def test_truncated_fmt_and_bad_files_return_error_codes(tmp_path):
    """A fmt chunk under 16 bytes, an EXTENSIBLE one under 26, a chunk that
    declares more than the file holds, a non-RIFF file and a missing one:
    decode_mono gives None, decode_batch a zero row, a negative rate and
    length 0, with the good row decoded; the numpy codec raises."""
    short = struct.pack("<HHI", 1, 1, 16000)
    noext = struct.pack("<HHIIHH", 0xFFFE, 1, 16000, 32000, 2, 16)
    bad = []
    for name, fmt in (("shortfmt.wav", short), ("shortext.wav", noext)):
        hdr = b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8) + b"WAVE"
        hdr += b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", 0)
        bad.append(tmp_path / name)
        bad[-1].write_bytes(hdr)
    good = tmp_path / "good.wav"
    wavio.write_wav(good, np.full(100, 0.25, np.float32), 8000)
    bad.append(tmp_path / "truncated.wav")
    bad[-1].write_bytes(good.read_bytes()[:-10])
    bad.append(tmp_path / "garbage.wav")
    bad[-1].write_bytes(b"garbage")
    bad.append(tmp_path / "missing.wav")
    for p in bad:
        assert native.decode_mono(p) is None
        with pytest.raises((ValueError, OSError)):
            wavio.read_wav(p)
    batch, srs, lens = native.decode_batch([good, *bad], 200, n_threads=3)
    assert srs[0] == 8000 and lens[0] == 100 and batch[0, :100].min() > 0.2
    assert (srs[1:] < 0).all() and (lens[1:] == 0).all() and not batch[1:].any()


def test_build_failure_warns_with_the_compiler_output(tmp_path, monkeypatch):
    """A source that does not compile: one warning naming g++'s error, then
    None from every call and the numpy codec in load_audio."""
    broken = tmp_path / "fastwav.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.warns(RuntimeWarning, match="could not build fastwav.cc") as caught:
        assert not native.available()
    assert "error" in str(caught[0].message)
    path = tmp_path / "x.wav"
    wavio.write_wav(path, np.zeros(10, np.float32), 16000)
    native.ROWS.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # warned once, not again
        assert native.decode_mono(path) is None and native.decode_batch([path], 10) is None
        wavio.load_audio(path)
    assert native.ROWS.as_dict() == {"native": 0, "numpy": 1, "per_row": 0}


def test_library_lives_under_build():
    lib = native.build()
    assert lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert lib.name.startswith("fastwav-") and lib.suffix == ".so"
    assert not list(native.SRC.parent.glob("*.so"))


@pytest.fixture(scope="module")
def mixed_corpus(tmp_path_factory):
    """A 16 kHz whole-recording corpus with the corpus fixture's 4 / 10 /
    44.1 kHz recordings added to the same directory, and a segmented layout
    with a 4 kHz and a 44.1 kHz cycle in two class directories."""
    root = tmp_path_factory.mktemp("mixed")
    whole = synthetic.generate_icbhi_dataset(root / "whole", num_recordings=8, seed=3)
    fixture = synthetic.generate_icbhi_corpus_fixture(root / "fixture", num_recordings=3,
                                                      cycles_per_recording=1, seed=4)
    for p in (fixture / "audio_and_txt_files").iterdir():
        shutil.copy(p, whole / "audio_and_txt_files" / p.name)
    seg = synthetic.generate_segmented_dataset(root / "seg", per_class=3, duration=0.6, seed=5)
    rng = np.random.default_rng(6)
    for cls, sr in (("crackle", 4000), ("both", 44100)):
        wavio.write_wav(seg / cls / f"999_1b1_Al_sc_Other_seg000_{cls}.wav",
                        (0.1 * rng.standard_normal(int(0.7 * sr))).astype(np.float32), sr)
    return whole, seg


@pytest.mark.parametrize("segmented", [False, True], ids=["whole", "segmented"])
def test_load_batch_equals_jax(mixed_corpus, segmented):
    """One batch over every row (16 kHz and the other rates) equals the JAX
    loader's bit for bit, and the port's numpy path; the row counts add up:
    each row decoded once, the other rates by the per-row path."""
    whole, seg = mixed_corpus
    config = {"data": {"sample_rate": 16000, "duration": 1.0, "train_split": 0.99,
                       "val_split": 0.0}}
    cls, jax_cls, root = ((ICBHISegmentedDataset, JaxSegmented, seg) if segmented
                          else (ICBHIDataset, JaxDataset, whole))
    ds = cls(root, "train", config)
    jds = jax_cls(root, "train", config)
    assert ds.data == jds.data
    idxs = np.arange(len(ds))
    other_rate = [i for i in idxs if wavio.read_wav(ds.data[i][0])[1] != 16000]
    assert len(other_rate) >= 2
    native.ROWS.reset()
    wavs, labels = ds.load_batch(idxs)
    rows = native.ROWS.as_dict()
    jwavs, jlabels = jds.load_batch(idxs)
    np.testing.assert_array_equal(wavs, jwavs)
    np.testing.assert_array_equal(labels, jlabels)
    assert wavs.shape == (len(idxs), 16000) and wavs.dtype == np.float32
    assert rows == {"native": len(idxs), "numpy": 0, "per_row": len(other_rate)}
    plain = np.stack([wavio.pad_or_crop(wavio.load_audio(ds.data[i][0], 16000)[0], 16000)
                      for i in idxs])
    np.testing.assert_array_equal(wavs, plain)

    native.ROWS.reset()  # the loader's threads count under the lock
    loaded = np.concatenate([w for w, _ in BatchLoader(ds, 4, num_threads=3)])
    np.testing.assert_array_equal(loaded, wavs)
    assert sum(native.ROWS.as_dict()[k] for k in ("native", "numpy")) == len(idxs)
