"""Multi-threaded prefetching data loader with rank sharding (the port's
own copy of `jperceiver_tpu/data/loader.py`): each process takes a
rank-strided shard of an epoch-seeded permutation, worker threads load
samples (PIL and numpy release the GIL), and a bounded queue keeps samples
ready. The index list is padded to a multiple of the global batch with
wrap-around repeats, whose entries the `_valid` mask marks False, or, with
`drop_last` (the default), the last partial batch is dropped. A worker's
error is raised in the caller. Batches are numpy, in the datasets' layout.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def collate(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        out[k] = np.stack([s[k] for s in samples], axis=0)
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (dataset indices, validity mask) for this rank's shard.

        The mask is False for wrap-around pad entries so consumers (the
        eval hook) can keep duplicates out of metric means — the
        reference's rank-strided eval sees each sample exactly once
        (`eval_hooks.py:128`).
        """
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        valid = np.ones(n, bool)
        global_batch = self.batch_size * self.process_count
        if self.drop_last:
            usable = (n // global_batch) * global_batch
            idx, valid = idx[:usable], valid[:usable]
        else:
            # Pad to a multiple of the global batch with wrap-around
            # repeats (`sampler.py:31-36` semantics); np.resize wraps, so
            # this is correct even when the pad exceeds the dataset size.
            pad = (-n) % global_batch
            if pad:
                idx = np.resize(idx, n + pad)
                valid = np.concatenate([valid, np.zeros(pad, bool)])
        # Rank-strided shard (`sampler.py:37-39`).
        sl = slice(self.process_index, None, self.process_count)
        return idx[sl], valid[sl]

    def __len__(self) -> int:
        return len(self._epoch_indices()[0]) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        indices, valid = self._epoch_indices()
        # Advance the epoch counter up front: consumers (Trainer._prefetch)
        # may abandon the iterator after exactly len(self) batches, so a
        # post-exhaustion increment would never run and every epoch would
        # re-see the same permutation. `set_epoch` still overrides (the
        # reference's DistSamplerSeedHook contract, `sampler.py:16-39`).
        self.epoch += 1
        n_batches = len(indices) // self.batch_size
        sample_q: queue.Queue = queue.Queue(maxsize=self.prefetch * self.batch_size)
        results: dict[int, dict] = {}
        results_lock = threading.Lock()
        todo = queue.Queue()
        for pos, ds_idx in enumerate(indices[: n_batches * self.batch_size]):
            todo.put((pos, int(ds_idx)))
        stop = threading.Event()

        worker_error: list[BaseException] = []

        def worker():
            while not stop.is_set():
                try:
                    pos, ds_idx = todo.get_nowait()
                except queue.Empty:
                    return
                try:
                    sample = self.dataset[ds_idx]
                except BaseException as e:
                    # Surface dataset errors (corrupt PNG, calib parse
                    # failure) instead of dying silently and hanging the
                    # consumer on sample_q.get() forever.
                    worker_error.append(e)
                    sample_q.put(-1)
                    return
                with results_lock:
                    results[pos] = sample
                sample_q.put(pos)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        try:
            next_pos = 0
            ready: set[int] = set()
            for _ in range(n_batches):
                batch_samples = []
                while len(batch_samples) < self.batch_size:
                    while next_pos not in ready:
                        got = sample_q.get()
                        if got < 0:
                            raise RuntimeError(
                                "data loader worker failed"
                            ) from worker_error[0]
                        ready.add(got)
                    with results_lock:
                        batch_samples.append(results.pop(next_pos))
                    ready.discard(next_pos)
                    next_pos += 1
                batch = collate(batch_samples)
                if not self.drop_last:
                    # Wrap-around pads possible: expose which samples are
                    # real so eval keeps duplicates out of metric means.
                    batch["_valid"] = valid[next_pos - self.batch_size : next_pos]
                yield batch
        finally:
            stop.set()
