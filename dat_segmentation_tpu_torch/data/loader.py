"""Host-side data loading: threaded decode and augmentation, and the copy
of each batch to the card beside the step.

Counterpart of ``dat_segmentation_tpu/data/loader.py``. ``DataLoader`` is
the JAX package's: a thread pool runs ``dataset[i]`` two batches ahead,
the shuffle comes from ``RandomState(seed + epoch)``, ``set_epoch`` is
called each epoch, ``shard_info`` slices the index space, and batches are
collated into numpy arrays. Each loader thread runs PyTorch's CPU ops (the
uint8 resize) on one intra-op thread (``torch.set_num_threads(1)`` in the
thread): the loader's parallelism is its threads, and a pool a thread
per core inside each of them would oversubscribe the cores. (PyTorch takes
the count into a thread at its first parallel op, so a thread that has
already run one, such as the trainer's after building the model, keeps its
own.)

``device_prefetch`` keeps ``DEPTH`` batches in flight to the device. On
the card a producer thread pins each batch (``pin_memory``) and copies it
with ``non_blocking=True`` on a side ``torch.cuda.Stream``, then records
an event; the consumer makes its current stream wait on that event before
it hands the batch on, and ``record_stream`` tells the caching allocator
that the consumer's stream uses the tensors, so their memory is not given
out again while the step may still read it. On the CPU the batch is
handed on as tensors. An exception in the producer is raised in the
consumer; closing the consumer stops the producer.
"""

from __future__ import annotations

import itertools
import queue
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Union

import numpy as np
import torch

DEPTH = 2  # batches in flight to the device


def _one_intra_op_thread():
    torch.set_num_threads(1)


class DataLoader:
    """Batched iterator over a map-style dataset.

    * shuffle with a per-epoch seed (``RandomState(seed + epoch)``, the
      DistributedSampler ``set_epoch`` semantics);
    * ``drop_last`` for training (every batch of one shape);
    * ``shard_info=(rank, world)`` slices the index space per process;
    * ``infinite`` cycles epochs from ``epoch``.
    """

    _shuffle_keys_seen: set = set()

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = False,
        drop_last: bool = False,
        num_threads: int = 0,
        seed: int = 0,
        shard_info: Optional[tuple] = None,
        infinite: bool = False,
        epoch: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if not num_threads:  # auto-size to the host (reference workers=32)
            import os

            num_threads = min(32, os.cpu_count() or 4)
        self.num_threads = num_threads
        self.seed = seed
        self.shard_info = shard_info or (0, 1)
        self.infinite = infinite
        self.epoch0 = epoch
        # the per-item aug RNG is keyed (seed, epoch, idx): a second shuffling
        # loader over one dataset from one epoch repeats the first bit for bit
        if shuffle and not infinite:
            key = (id(dataset), seed, epoch)
            if key in DataLoader._shuffle_keys_seen:
                warnings.warn(
                    "DataLoader(shuffle=True) constructed twice over the "
                    f"same dataset with epoch={epoch}: per-item aug RNG is "
                    "keyed (seed, epoch, idx), so this loader repeats the "
                    "previous one bit-for-bit. Pass epoch=<epoch index> "
                    "when building one loader per epoch.",
                    stacklevel=2,
                )
            DataLoader._shuffle_keys_seen.add(key)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = np.random.RandomState(self.seed + epoch).permutation(n)
        rank, world = self.shard_info
        if world > 1:
            pad = (-len(idx)) % world  # pad to a multiple of world, as DistributedSampler
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
            idx = idx[rank::world]
        return idx

    def __len__(self) -> int:
        n = len(self._epoch_indices(0))
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        epochs = itertools.count(self.epoch0) if self.infinite else [self.epoch0]
        with ThreadPoolExecutor(self.num_threads, initializer=_one_intra_op_thread) as pool:
            for epoch in epochs:
                # every future of the previous epoch is consumed before this
                set_epoch = getattr(self.dataset, "set_epoch", None)
                if set_epoch is not None:
                    set_epoch(epoch)
                idx = self._epoch_indices(epoch)
                usable = len(idx) - len(idx) % self.batch_size if self.drop_last else len(idx)
                batches = [idx[i : i + self.batch_size] for i in range(0, usable, self.batch_size)]

                def submit(b):
                    return [pool.submit(self.dataset.__getitem__, int(j)) for j in b]

                futures = [submit(b) for b in batches[:2]]  # two batches ahead
                for bi in range(len(batches)):
                    if bi + 2 < len(batches):
                        futures.append(submit(batches[bi + 2]))
                    yield _collate([f.result() for f in futures[bi]])


def _collate(items):
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], (np.ndarray, np.generic)):
            out[key] = np.stack(vals)
        else:
            out[key] = vals
    return out


def device_prefetch(iterator, device: Union[str, torch.device]) -> Iterator[dict]:
    """Yield the batches of ``iterator`` with their numpy arrays as tensors
    on ``device``, keeping ``DEPTH`` batches in flight. Other entries (the
    paths) pass as they are."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=DEPTH)
    stop = threading.Event()
    sentinel = object()

    def put(batch):
        out = dict(batch)
        names = [k for k, v in batch.items() if isinstance(v, np.ndarray)]
        if not cuda:
            for k in names:
                out[k] = torch.from_numpy(batch[k]).to(device)
            return out, None
        with torch.cuda.device(device), torch.cuda.stream(side):
            for k in names:
                out[k] = torch.from_numpy(batch[k]).pin_memory().to(device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, (names, ready)

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        it = iter(iterator)
        try:
            for batch in it:
                if not offer(put(batch)):
                    break
            else:
                offer(sentinel)
        except BaseException as e:  # raised in the consumer
            offer(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, daemon=True, name="device_prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            batch, pending = item
            if pending is not None:
                names, ready = pending
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for k in names:
                    batch[k].record_stream(stream)
            yield batch
    finally:
        stop.set()
        thread.join()
