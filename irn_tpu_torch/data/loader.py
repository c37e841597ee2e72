"""Batch loading with background prefetch: the port's own copy of
``irn_tpu.data.loader`` (numpy and threads only), the capability of the
reference's torch DataLoader in its train stages.

Batches are collated to stacked numpy arrays ready for one host->device
copy; a thread pool overlaps JPEG decode and augmentation with the card's
work. ``local_rows`` serves data-parallel training: each rank decodes its
contiguous rows of every global batch."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def shard_indices(n: int, shard: int, num_shards: int) -> np.ndarray:
    """Strided shard of range(n) (torchutils.split_dataset semantics)."""
    return np.arange(shard, n, num_shards)


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack same-shaped arrays; keep lists for strings/ragged entries."""
    out: Dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        first = vals[0]
        if isinstance(first, np.ndarray) and all(
            isinstance(v, np.ndarray) and v.shape == first.shape for v in vals
        ):
            out[key] = np.stack(vals, axis=0)
        else:
            out[key] = vals
    return out


class BatchLoader:
    """Iterate a dataset in shuffled fixed-size batches with prefetch.

    Args:
      dataset: indexable with __len__/__getitem__ returning sample dicts.
      batch_size: samples per batch.
      shuffle: reshuffle indices each epoch (seeded, reproducible).
      drop_last: drop the trailing partial batch (the reference's training
        loaders use drop_last=True).
      num_workers: decode/augment threads.
      prefetch: max batches in flight.
      indices: optional explicit index subset (e.g. a shard).
      local_rows: optional (lo, hi) — decode only these rows of every
        (globally shuffled) batch. Data parallelism over ranks: each rank
        forms the SAME global batch stream (seeded shuffle) and loads only
        its contiguous row range of each batch
        (parallel/mesh.local_batch_slice). Requires drop_last (a ragged
        tail batch has no well-defined row range).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        indices: Optional[np.ndarray] = None,
        local_rows: Optional[tuple] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.indices = (
            np.asarray(indices) if indices is not None else np.arange(len(dataset))
        )
        if local_rows is not None:
            lo, hi = local_rows
            if not (0 <= lo < hi <= batch_size):
                raise ValueError(f"local_rows {local_rows} outside batch "
                                 f"[0, {batch_size})")
            if (lo, hi) != (0, batch_size) and not drop_last:
                raise ValueError(
                    "local_rows requires drop_last=True (a ragged tail "
                    "batch has no well-defined per-rank row range)"
                )
        self.local_rows = local_rows
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        """Pin the next iteration's (shuffle, augmentation) RNG stream: the
        train stage calls this with the true epoch number each epoch, so a
        resumed run continues the stream where it left off."""
        self._epoch = int(epoch)

    def _epoch_indices(self) -> np.ndarray:
        idx = self.indices.copy()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[Dict]:
        idx = self._epoch_indices()
        if hasattr(self.dataset, "set_epoch"):
            # per-sample RNGs derive from (seed, epoch, idx): reproducible
            # for any num_workers, fresh draws each epoch
            self.dataset.set_epoch(self._epoch)
        self._epoch += 1
        n_batches = len(self)
        batches: List[np.ndarray] = [
            idx[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]
        if self.local_rows is not None:
            # slice AFTER forming global batches so every rank sees the
            # same global shuffle stream and decodes disjoint rows of it
            lo, hi = self.local_rows
            batches = [b[lo:hi] for b in batches]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_interruptible(item) -> bool:
            # an abandoned iterator sets `stop` from the consumer's finally;
            # a producer parked in a blocking put would leak its thread,
            # pool and queued batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self.dataset.__getitem__, b))
                        if not put_interruptible(collate(samples)):
                            return
                sentinel = None
            except BaseException as exc:  # forward, don't hang the consumer
                sentinel = exc
            put_interruptible(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    # a worker failure (corrupt image, IO error) fails the
                    # training loop instead of blocking it
                    raise item
                yield item
        finally:
            stop.set()
