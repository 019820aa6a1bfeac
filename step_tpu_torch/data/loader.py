"""Batching data loader with threaded prefetch.

Port of `step_tpu/data/loader.py`: worker threads load and assemble the
next batches (`build_model_batch`) while the card runs the current step.
The per-epoch order is a seeded shuffle, the same on every process, so a
run resumed at `(epoch, batch_index)` sees the batches it would have seen;
in a data-parallel run each process takes its strided slice of it
(`parallel.process_shard`'s order), cut to the same length on every
process, so that every process runs the same number of steps.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

from step_tpu_torch.config import StepConfig
from step_tpu_torch.data.pipeline import build_model_batch
from step_tpu_torch.parallel.distributed import process_shard
from step_tpu_torch.utils.spans import span

_STACK_KEYS = ("rgb", "flow", "gt_tubes", "gt_labels", "gt_mask")


def collate(clips: list[dict]) -> dict:
    """Stack per-clip dicts into one raw batch; other keys go to `meta`."""
    out = {k: np.stack([c[k] for c in clips]) for k in _STACK_KEYS if k in clips[0]}
    out["meta"] = [{k: c[k] for k in c if k not in _STACK_KEYS} for c in clips]
    return out


class DataLoader:
    """Model batches over a dataset (`len` and `__getitem__` → clip dict),
    shuffled per epoch from `seed + epoch`, assembled by worker threads up
    to `prefetch` batches ahead; `drop_last` drops a short last batch;
    rgb ships as uint8 unless `emit_uint8` (default
    `cfg.uint8_transfer`) says otherwise. With `process_count` > 1 the
    loader serves process `process_index`'s slice of each epoch, and its
    `batch_size` is the process's share of the global batch."""

    def __init__(self, dataset, cfg: StepConfig, batch_size: Optional[int] = None,
                 shuffle: bool = True, train: bool = True, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 4, drop_last: bool = True,
                 emit_uint8: Optional[bool] = None, process_count: int = 1,
                 process_index: int = 0):
        self.dataset = dataset
        self.cfg = cfg
        self.emit_uint8 = cfg.uint8_transfer if emit_uint8 is None else emit_uint8
        self.batch_size = batch_size or cfg.batch_size
        self.shuffle = shuffle
        self.train = train
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.process_count = process_count
        self.process_index = process_index

    def __len__(self):
        n, rem = divmod(len(self.dataset) // self.process_count, self.batch_size)
        return n + (1 if rem and not self.drop_last else 0)

    def _epoch_batches(self, epoch: int) -> list[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        if self.process_count > 1:
            idx = idx[process_shard(len(idx), self.process_count, self.process_index)]
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def epoch(self, epoch: int = 0, start: int = 0) -> Iterator[dict]:
        """Yield the model batches of one epoch from batch index `start`
        (the ones before it are not loaded), prefetched."""
        self.dataset._epoch = epoch     # datasets salt their augmentation with it
        batches = self._epoch_batches(epoch)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        pool = ThreadPoolExecutor(self.num_workers) if self.num_workers > 1 else None

        def load_clips(idxs):
            if pool is None:
                return [self.dataset[int(i)] for i in idxs]
            return list(pool.map(lambda i: self.dataset[int(i)], idxs))

        def put(item) -> bool:
            # gives up once the consumer left the epoch, so the thread ends
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for bi in range(start, len(batches)):
                    if stop.is_set():
                        return
                    raw = collate(load_clips(batches[bi]))
                    batch = build_model_batch(
                        raw, self.cfg, train=self.train,
                        seed=self.seed + epoch * len(batches) + bi,
                        emit_uint8=self.emit_uint8)
                    batch["meta"] = raw["meta"]
                    if not put(batch):
                        return
            except Exception as e:      # handed to the consumer, which raises it
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with span("loader.wait"):
                    batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join(timeout=5.0)
            if pool is not None:
                pool.shutdown(wait=False)

    def __iter__(self):
        return self.epoch(0)
