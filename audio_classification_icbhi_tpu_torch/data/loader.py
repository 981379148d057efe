"""Prefetching host batch loader.

Port of `audio_classification_icbhi_tpu/data/loader.py:21-143`, unchanged:
worker threads decode wav files into numpy batches while the device
computes, behind a lookahead window on batch indices. The shuffle is
`np.random.default_rng(seed + epoch)`, so the port and the JAX package see
the same batches in the same order.

On a data mesh of several ranks each rank reads the same seeded batches but
decodes only its own rows of each (`shard`), where the JAX package decodes
a host's whole batch once for all of its devices.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class BatchLoader:
    """Iterable over (waveforms (B, L) f32, labels (B,) i32) numpy batches.

    shuffle/drop_last semantics match the reference train/val loaders
    (trainer_fixed.py:35-50). Shuffling is seeded per epoch for determinism.

    `shard` = (rank, ranks): a batch's rows are cut into `ranks` parts of
    batch_size / ranks rows, and the waveforms are decoded for part `rank`
    alone (a short last batch leaves some parts short or empty); the labels
    stay the whole batch's, read from `dataset.labels` without decoding.
    """

    def __init__(
        self,
        dataset,
        batch_size: int = 32,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        num_threads: int = 2,
        prefetch: int = 2,
        shard: tuple[int, int] = (0, 1),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = max(1, num_threads)
        self.prefetch = max(1, prefetch)
        self._epoch = 0
        rank, ranks = shard
        if batch_size % ranks:
            raise ValueError(f"batch size {batch_size} does not split into {ranks} equal parts")
        per = batch_size // ranks
        self.rows = slice(rank * per, (rank + 1) * per) if ranks > 1 else None

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _batch_indices(self) -> list[np.ndarray]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        batches = [
            order[i : i + self.batch_size] for i in range(0, n, self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _load_batch(self, idxs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if self.rows is None:
            return self._decode(idxs)
        own = idxs[self.rows]
        wavs = self._decode(own)[0] if len(own) else \
            np.zeros((0, self.dataset.target_length), np.float32)
        return wavs, self._labels[idxs]

    def _decode(self, idxs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        if hasattr(self.dataset, "load_batch"):
            # Native fast path: one threaded C++ call assembles the batch.
            return self.dataset.load_batch(idxs)
        wavs, labels = [], []
        for i in idxs:
            w, lbl = self.dataset[int(i)]
            wavs.append(w)
            labels.append(lbl)
        return np.stack(wavs).astype(np.float32), np.asarray(labels, dtype=np.int32)

    def __iter__(self):
        batches = self._batch_indices()
        if not batches:
            return
        if self.rows is not None:
            self._labels = np.asarray(self.dataset.labels, np.int32)
        # Backpressure = a LOOKAHEAD WINDOW on batch indices: a worker may
        # START batch bi only while bi < next_bi + window, so one slow batch
        # can park at most `window` completed successors in host memory.
        # (History: a semaphore released when out-of-order batches were
        # parked let a fast worker run unboundedly ahead of one slow batch —
        # O(all batches) of decoded waveforms in RAM; NOT releasing parked
        # batches' slots deadlocked both sides. The window has neither
        # failure mode: batch next_bi always satisfies the predicate, so the
        # in-order batch can always be decoded.)
        window = self.prefetch + self.num_threads
        work_q: queue.Queue = queue.Queue()
        done_q: queue.Queue = queue.Queue()
        for bi, idxs in enumerate(batches):
            work_q.put((bi, idxs))
        stop = threading.Event()
        cursor = [0]  # next_bi, read by workers under cond
        cond = threading.Condition()

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = work_q.get_nowait()
                except queue.Empty:
                    return
                with cond:
                    while bi >= cursor[0] + window and not stop.is_set():
                        cond.wait(0.5)  # timeout guards a missed final notify
                if stop.is_set():
                    return
                try:
                    done_q.put((bi, self._load_batch(idxs), None))
                except Exception as exc:  # surface decode errors to the consumer
                    done_q.put((bi, None, exc))

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        try:
            pending: dict[int, tuple] = {}
            next_bi = 0
            total = len(batches)
            while next_bi < total:
                if next_bi in pending:
                    batch = pending.pop(next_bi)
                else:
                    bi, batch, exc = done_q.get()
                    if exc is not None:
                        raise exc
                    if bi != next_bi:
                        pending[bi] = batch
                        continue
                yield batch
                next_bi += 1
                with cond:
                    cursor[0] = next_bi
                    cond.notify_all()
        finally:
            stop.set()
            with cond:
                cond.notify_all()  # unblock workers parked on the window
        self._epoch += 1
