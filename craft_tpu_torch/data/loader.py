"""Epoch-shuffled, sharded batch loaders (port of
``craft_tpu.data.loader``; reference datasets.py:569-577 and
train_ddp.py's DistributedSampler): the same batches in the same order as
the JAX package's loaders.

Per epoch: a global permutation from ``RandomState(seed + epoch)``, this
process's strided shard ``idx[rank::world]``, batches of ``batch_size``
with the ragged last one dropped, dealt round-robin to the workers (batch
i to worker i % n_workers), each worker seeding ``np.random`` and
``random`` with seed + epoch * 1000 + its id, and the batches emitted in
order.  Batches are dicts of CPU tensors holding the JAX loaders' arrays
(``extra_info`` a list), in pinned memory when asked for (``pin_memory``),
so that a copy to the card need not wait for the host.

  * ``MultiprocessLoader``: worker processes, a ``torch.utils.data.
    DataLoader`` over that batch order (tensors cross from the workers in
    shared memory).
  * ``ShardedLoader``: worker threads.  They seed the one global numpy
    generator, so a run is deterministic with one worker only (as in the
    JAX package).
"""

from __future__ import annotations

import queue
import random as _random
import threading
from typing import Dict, Iterator

import numpy as np
import torch.utils.data


def _collate(items):
    out = {}
    for k in items[0]:
        if k == "extra_info":
            out[k] = [it[k] for it in items]
        else:
            out[k] = torch.from_numpy(np.stack([it[k] for it in items]))
    return out


def _pinned(batch):
    return {k: v if k == "extra_info" else v.pin_memory()
            for k, v in batch.items()}


def _seed_worker(seed: int) -> None:
    np.random.seed(seed % (2 ** 31))
    _random.seed(seed)


class _Loader:
    """The sampling both loaders share."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 seed: int = 1234, prefetch: int = 4,
                 pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.seed = seed
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def epoch_batches(self):
        """This process's batches of the current epoch, as index arrays."""
        n = len(self.dataset)
        idx = (np.random.RandomState(self.seed + self.epoch).permutation(n)
               if self.shuffle else np.arange(n))
        idx = idx[self.process_index::self.process_count]
        nb = len(idx) // self.batch_size if self.drop_last else \
            (len(idx) + self.batch_size - 1) // self.batch_size
        return [idx[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(nb)]

    def worker_seed(self, wid: int) -> int:
        return self.seed + self.epoch * 1000 + wid


class _WorkerInit:
    """worker_init_fn of one epoch (picklable): worker wid seeds
    np.random and random with base + wid."""

    def __init__(self, base: int):
        self.base = base

    def __call__(self, wid: int) -> None:
        _seed_worker(self.base + wid)


class MultiprocessLoader(_Loader):
    """Worker processes (the reference's num_workers DataLoader): batch i
    is made by worker i % n_workers, n_workers = min(num_workers, the
    epoch's batch count), and the batches come out in order."""

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        batches = [b.tolist() for b in self.epoch_batches()]
        nw = min(self.num_workers, max(1, len(batches)))
        loader = torch.utils.data.DataLoader(
            self.dataset, batch_sampler=batches, num_workers=nw,
            collate_fn=_collate, worker_init_fn=_WorkerInit(
                self.worker_seed(0)),
            prefetch_factor=max(1, self.prefetch),
            pin_memory=self.pin_memory,
            # The base seed torch draws for its workers comes from this
            # generator, not from the process's default one.
            generator=torch.Generator().manual_seed(self.seed))
        yield from loader
        self.epoch += 1


class ShardedLoader(_Loader):
    """Worker threads, each taking the next batch from a queue and
    emitting in order (deterministic with one worker)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 2,
                 **kwargs):
        super().__init__(dataset, batch_size, num_workers=num_workers,
                         **kwargs)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        batches = self.epoch_batches()
        work_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        for bi, b in enumerate(batches):
            work_q.put((bi, b))
        next_emit = [0]
        lock = threading.Lock()
        stop = threading.Event()
        errors = []

        def worker(wid):
            _seed_worker(self.worker_seed(wid))
            try:
                while not stop.is_set():
                    try:
                        bi, b = work_q.get_nowait()
                    except queue.Empty:
                        return
                    batch = _collate([self.dataset[int(i)] for i in b])
                    if self.pin_memory:
                        batch = _pinned(batch)
                    while not stop.is_set():
                        with lock:
                            if next_emit[0] == bi:
                                out_q.put(batch)
                                next_emit[0] += 1
                                break
                        stop.wait(0.005)
            except Exception as e:  # raised on the consumer's side
                errors.append(e)
                out_q.put(None)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for _ in range(len(batches)):
                batch = out_q.get()
                if batch is None:
                    raise errors[0]
                yield batch
        finally:
            stop.set()
        self.epoch += 1


class InfiniteLoader:
    """A loader iterated forever, epoch after epoch."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        while True:
            yield from self.loader
