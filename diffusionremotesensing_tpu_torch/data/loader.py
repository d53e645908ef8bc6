"""Host-side data loader producing NHWC numpy dict-batches (port of
``diffusionremotesensing_tpu/data/loader.py``, numpy only, so one seed gives
the reference loader's batches).

What the reference launchers use of torch's DataLoader and
DistributedSampler: shuffling (``numpy.random.default_rng(seed + epoch)``,
reseeded by ``set_epoch``), batching (the last partial batch kept unless
``drop_last``), sharding by rank with wrap-around padding so every shard has
the same length, and ``pad_to_multiple``: the final partial batch padded by
repeating its rows, with a 'pad_mask' (1 for real rows, 0 for pads) that the
losses weight by. ``num_workers`` > 0 fetches items on a thread pool ahead
of the consumer; batches arrive in the same order with the same contents.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        pad_to_multiple: Optional[int] = None,
        drop_last: bool = False,
        num_workers: int = 0,
        prefetch: int = 2,
    ):
        """``num_workers`` > 0 fetches items on a thread pool and prepares
        batches ahead while the device computes (PIL/cv2/numpy item work
        releases the GIL, so threads give real overlap).

        Batches arrive in the same order (and, for deterministic datasets,
        with the same contents) as the single-threaded path. Datasets with
        internal augmentation RNG (e.g. DownBlurNoise) draw in thread order,
        so their *augmentations* are not run-reproducible under num_workers>0
        — the underlying items and batch order still are.
        """
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.pad_to_multiple = pad_to_multiple
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle per epoch (DistributedSampler.set_epoch parity)."""
        self.epoch = epoch

    def __len__(self) -> int:
        n = len(self._shard_indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _shard_indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.num_shards > 1:
            # DistributedSampler parity: pad by wrap-around so every shard
            # has the SAME length — in a multi-process mesh each train step
            # is a collective all processes must enter, so unequal shard
            # sizes would deadlock the job on the last batches of an epoch.
            total = -(-n // self.num_shards) * self.num_shards
            if total > n:
                idx = np.concatenate([idx, idx[: total - n]])
        return idx[self.shard_index :: self.num_shards]

    def _batch_indices(self):
        idx = self._shard_indices()
        bs = self.batch_size
        stop = len(idx) - (len(idx) % bs) if self.drop_last else len(idx)
        return [idx[s : s + bs] for s in range(0, stop, bs)]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        chunks = self._batch_indices()
        if self.num_workers <= 0:
            for chunk in chunks:
                yield self._collate([self.dataset[int(i)] for i in chunk])
            return

        from concurrent.futures import ThreadPoolExecutor

        def fetch(chunk):
            return self._collate([self.dataset[int(i)] for i in chunk])

        # keep enough batches in flight to occupy every worker (plus the
        # lookahead) — otherwise num_workers > prefetch threads sit idle
        inflight = max(self.prefetch, self.num_workers)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = [pool.submit(fetch, c) for c in chunks[:inflight]]
            nxt = len(pending)
            while pending:
                fut = pending.pop(0)
                if nxt < len(chunks):
                    pending.append(pool.submit(fetch, chunks[nxt]))
                    nxt += 1
                yield fut.result()

    def _collate(self, items: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        batch = {
            k: np.stack([np.asarray(it[k]) for it in items]) for k in items[0]
        }
        m = self.pad_to_multiple
        if m:
            n = len(items)
            rem = (-n) % m
            if rem:
                # wrap-around indexing: rem may exceed n (e.g. a 3-row final
                # batch padded to a multiple of 8 needs 5 repeats)
                idx = np.arange(rem) % n
                batch = {
                    k: np.concatenate([v, v[idx]], axis=0) for k, v in batch.items()
                }
                # pad rows are repeats of real samples; the trainer's loss
                # excludes them via this mask (losses._reduce), so the final
                # partial batch is not over-weighted. Pad rows still enter
                # train-mode BatchNorm batch statistics (as they do under the
                # reference's DistributedSampler wrap padding).
                batch["pad_mask"] = np.concatenate(
                    [np.ones(n, np.float32), np.zeros(rem, np.float32)]
                )
        return batch
