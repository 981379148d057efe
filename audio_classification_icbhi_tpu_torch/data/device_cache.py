"""Device-resident waveform cache.

Port of `audio_classification_icbhi_tpu/data/device_cache.py:27-167`. The
whole decoded waveform tensor lives in device memory, decoded once at
construction (whole on every rank of a process group); per step only
index batches cross from the host, and the fused multi-step epoch
(`parallel/data_parallel.make_step_fns`'s `train_many` / `eval_many`)
gathers its rows on the device.

Storage dtype (`data.cache_dtype`): 16-bit-PCM-sourced audio (the whole
ICBHI corpus, the synthetic corpora) is kept as int16 and dequantized on the
device inside the gather, bit-exact by a round-trip check at construction
(`_pcm16_quantize`); it halves the upload and the footprint. "auto" (the
default) falls back to float32 where a sample does not round-trip
(resampled, normalized or float-source audio), "float32" forces it, and
"int16" raises on lossy audio instead of falling back.

The cache is one ordinary allocation on an explicit device, made before
any CUDA graph is captured, so every graph of the fused epoch reads it by
address and no graph's memory pool holds it.

Enable with config data.cache_on_device: true (the Trainer picks the loader).
"""

from __future__ import annotations

import numpy as np
import torch

from audio_classification_icbhi_tpu_torch.data.loader import BatchLoader


def dequantize(wavs: torch.Tensor) -> torch.Tensor:
    """Exact int16 -> float32 PCM dequant (x · 2^-15) for gathers out of a
    PCM16-stored cache; the identity on anything else. Both decoders use
    the same /32768 convention (`data/wavio.py`)."""
    if wavs.dtype == torch.int16:
        return wavs.float() * (1.0 / 32768.0)
    return wavs


def _pcm16_quantize(wavs: np.ndarray) -> np.ndarray | None:
    """int16 image of a float32 waveform tensor when q = rint(x · 32768)
    dequantizes back EXACTLY (q · 2^-15 == x for every sample): true
    whenever the data came from 16-bit PCM WAVs through this package's
    decoder and was only cropped or zero-padded since. None on any sample
    that does not round-trip (resampled, normalized, float-source,
    out-of-range or non-finite audio), so callers keep the float32 cache
    with numerics untouched. Chunked: about 16 MB of extra memory at most,
    whatever the dataset's size."""
    if wavs.dtype != np.float32 or wavs.size == 0 or wavs.ndim < 1:
        return None
    out = np.empty(wavs.shape, np.int16)
    flat_in = wavs.reshape(wavs.shape[0], -1) if wavs.ndim > 1 else wavs[None]
    flat_out = out.reshape(flat_in.shape)
    rows_per_chunk = max(1, (1 << 22) // max(flat_in.shape[-1], 1))
    for s in range(0, flat_in.shape[0], rows_per_chunk):
        w = flat_in[s:s + rows_per_chunk]
        q = np.rint(w * np.float32(32768.0))
        if not np.isfinite(q).all() or q.min() < -32768 or q.max() > 32767:
            return None
        qi = q.astype(np.int16)
        # the on-device dequant must give w back bit for bit
        if not np.array_equal(qi.astype(np.float32) / np.float32(32768.0), w):
            return None
        flat_out[s:s + rows_per_chunk] = qi
    return out


class DeviceCachedLoader(BatchLoader):
    """BatchLoader whose waveforms live on `device`.

    The same seeded shuffle and drop_last semantics (it reuses
    BatchLoader's index machinery), but the decode happens ONCE, at
    construction, in chunks of 512 through `_load_batch`, and `__iter__`
    yields (wavs: (B, L) float32 tensor on `device`, labels: (B,) numpy
    int32). Labels stay on the host: the loss masks, metrics and ICBHI
    score want them there.

    Every row of the dataset is cached, on every rank of a process group
    too, as the JAX loader replicates its cache over the mesh (`P()`): a
    shuffled epoch draws any row for any rank's columns, so a rank's
    `shard` of rows does not apply. Each rank decodes every row with the
    same decoder from the same files, so the replicas hold the same bytes.
    `columns` is this rank's `local_batch_slice` of a batch: `__iter__`
    then gathers only those columns of each batch's indices and yields
    every row's labels, as `BatchLoader(shard=...)` does (a short last
    batch leaves some ranks' columns short or empty); `epoch_index_batches`
    and `cache` stay global, and the fused epoch takes its columns itself.
    """

    def __init__(self, dataset, batch_size: int = 32, *,
                 device: str | torch.device = "cuda", cache_dtype: str = "auto",
                 columns: slice | None = None, **kwargs):
        super().__init__(dataset, batch_size, **kwargs)
        if self.rows is not None:
            raise ValueError("the device cache holds every row: it takes no rank shard")
        self.columns = columns
        if cache_dtype not in ("auto", "int16", "float32"):
            raise ValueError(f"cache_dtype must be auto|int16|float32, got {cache_dtype!r}")
        n = len(dataset)
        chunks_w, chunks_l = [], []
        for start in range(0, n, 512):
            w, lbl = self._load_batch(np.arange(start, min(start + 512, n)))
            chunks_w.append(w)
            chunks_l.append(lbl)
        wavs = np.concatenate(chunks_w) if chunks_w else np.zeros((0, 0), np.float32)
        self.labels_all = (np.concatenate(chunks_l).astype(np.int32) if chunks_l
                           else np.zeros(0, np.int32))
        stored = wavs
        if cache_dtype in ("auto", "int16"):
            q = _pcm16_quantize(wavs)
            if q is not None:
                stored = q
            elif cache_dtype == "int16":
                raise ValueError(
                    "data.cache_dtype=int16: waveforms do not round-trip PCM16 "
                    "losslessly (resampled/normalized/float-source audio); use "
                    "'auto' or 'float32'")
        self.device = torch.device(device)
        self._cache = torch.from_numpy(np.ascontiguousarray(stored)).to(self.device)

    @property
    def nbytes(self) -> int:
        return self._cache.numel() * self._cache.element_size()

    @property
    def cache(self) -> torch.Tensor:
        """The (N, L) waveform tensor on the device (int16 or float32),
        passed whole to the fused epoch, which gathers its batches from it
        on the device."""
        return self._cache

    def gather(self, idxs) -> torch.Tensor:
        """Rows `idxs` (numpy or a tensor, any shape) of the cache as float32
        waveforms of shape idxs.shape + (L,): index_select, then dequantize."""
        idx = torch.as_tensor(idxs, dtype=torch.int64, device=self.device)
        rows = dequantize(self._cache.index_select(0, idx.reshape(-1)))
        return rows.reshape(tuple(idx.shape) + (self._cache.shape[-1],))

    def epoch_index_batches(self) -> np.ndarray:
        """(S, B) int32 dataset indices of this epoch's full batches, in the
        seeded shuffle's order: for S optimizer steps, they are all that
        crosses from the host. A partial tail batch is left out (callers
        step it apart)."""
        full = [b for b in self._batch_indices() if len(b) == self.batch_size]
        if not full:
            return np.zeros((0, self.batch_size), np.int32)
        return np.stack(full).astype(np.int32)

    def __iter__(self):
        for idxs in self._batch_indices():
            own = idxs if self.columns is None else idxs[self.columns]
            yield self.gather(own), self.labels_all[idxs]
        self._epoch += 1
