"""DataLoader — port of paddle_tpu/io/dataloader.py.

num_workers=0 runs in-process with a background prefetch thread
double-buffering batches; num_workers>0 forks worker processes that feed
an in-order lookahead window, through the native shared-memory ring
(io/shm_ring.py) when `use_shared_memory` is set, else a queue.

The parent has usually touched CUDA before it forks (the model is on the
card), and a forked child must make no CUDA call: a worker turns each
sample into numpy, collates numpy (`numpy_collate_fn`, as the JAX
package's child does) and runs its transforms on the CPU with one
thread; the parent makes the tensors, on the current place.
"""
from __future__ import annotations

import itertools
import random
import multiprocessing as mp
import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..core import random as prandom
from ..core.device import _device
from ..core.tensor import Tensor
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler


def default_collate_fn(batch):
    """List of samples → batched Tensors (paddle default_collate_fn shape)."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor(torch.stack([s._data for s in batch]))
    if isinstance(sample, np.ndarray):
        return Tensor(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return Tensor(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return Tensor(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    return list(batch)


def numpy_collate_fn(batch):
    """default_collate_fn's structure, numpy-only — safe in forked workers
    (never builds a tensor; the main process makes them in
    _to_tensor_tree)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: numpy_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [numpy_collate_fn(list(items)) for items in zip(*batch)]
    return list(batch)


def _picklable(obj) -> bool:
    import pickle
    try:
        pickle.dumps(obj)
        return True
    # ptlint: disable=EXC001 — pickle raises whatever the object's
    # __reduce__ raises; ANY failure means "not picklable", the answer
    except Exception:
        return False


class WorkerInfo:
    """paddle.io.get_worker_info payload (id/num_workers/dataset/seed)."""

    def __init__(self, id, num_workers, seed, dataset):
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    """Inside a DataLoader worker: that worker's WorkerInfo; None in the
    main process (reference contract)."""
    return _worker_info


def _worker_loop(dataset, index_queue, data_queue, collate_fn, worker_init_fn,
                 worker_id, seed, ring_name=None, num_workers=1):
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, seed + worker_id,
                              dataset)
    np.random.seed((seed + worker_id) % (2 ** 31))
    # the transforms draw from Python's random: each worker its own stream
    # (the JAX package's workers all inherit the parent's)
    random.seed(seed + worker_id)
    # the CPU transforms of 8 workers would otherwise each start a thread
    # per core
    torch.set_num_threads(1)
    ring = None
    if ring_name is not None:
        from .shm_ring import ShmRing
        try:
            ring = ShmRing.attach(ring_name)
        except (OSError, RuntimeError):
            ring = None  # no native lib / shm gone → queue transport
    if worker_init_fn is not None:
        worker_init_fn(worker_id)

    def emit(job_id, batch, err):
        if err is not None and not _picklable(err):
            # exceptions can hold unpicklable members (locks, sockets);
            # neither transport can carry those, and a silently-dropped
            # Queue item would hang the main process forever
            err = RuntimeError(f"{type(err).__name__}: {err}")
        if ring is not None:
            try:
                ring.send(job_id, (job_id, batch, err))
                return
            # ptlint: disable=EXC001 — shutdown race: the ring can die
            # mid-send in arbitrary ways; the queue below ALWAYS carries
            # the item so the main process can never hang on a lost batch
            except Exception:
                pass  # ring stopped/raced at shutdown → last-resort queue
        data_queue.put((job_id, batch, err))

    while True:
        job = index_queue.get()
        if job is None:
            break
        job_id, indices = job
        try:
            # numpy-ify BEFORE collating so the default collate never builds
            # a tensor here: a forked child must make no CUDA call
            samples = [_to_numpy_tree(dataset[i]) for i in indices]
            batch = collate_fn(samples) if collate_fn else samples
            batch = _to_numpy_tree(batch)
            emit(job_id, batch, None)
        # ptlint: disable=EXC001 — worker boundary: the exception is
        # shipped to the main process and re-raised there (not swallowed)
        except Exception as e:  # surface worker errors to the main process
            emit(job_id, None, e)


def _to_numpy_tree(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy_tree(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_numpy_tree(v) for k, v in x.items()}
    return x


def _to_tensor_tree(x, dev=None):
    """A worker's numpy batch as Tensors on the current place. To the
    card the copy goes through pinned memory without waiting for the
    work already queued there, as the JAX package's device_put does not
    wait."""
    dev = _device() if dev is None else dev
    if isinstance(x, np.ndarray):
        if dev.type != "cuda":
            return Tensor(x)
        t = torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
        return Tensor(t.to(dev, non_blocking=True))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_tensor_tree(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _to_tensor_tree(v, dev) for k, v in x.items()}
    return x


class _SingleProcessIter:
    def __init__(self, loader):
        self.loader = loader
        self.sampler_iter = iter(loader.batch_sampler)

    def __iter__(self):
        return self

    def __next__(self):
        indices = next(self.sampler_iter)
        samples = [self.loader.dataset[i] for i in indices]
        return self.loader.collate_fn(samples)


class _IterableDatasetIter:
    def __init__(self, loader):
        self.loader = loader
        self.it = iter(loader.dataset)

    def __iter__(self):
        return self

    def __next__(self):
        batch = list(itertools.islice(self.it, self.loader.batch_size))
        if not batch:
            raise StopIteration
        if self.loader.drop_last and len(batch) < self.loader.batch_size:
            raise StopIteration
        return self.loader.collate_fn(batch)


class _MultiProcessIter:
    """Out-of-order worker pool with in-order delivery + lookahead window.

    Transport: with use_shared_memory (and the native lib buildable), worker
    batches travel through the C++ shared-memory ring (io/native/shm_ring.cc)
    instead of the pickling multiprocessing.Queue — the queue stays as a
    control/fallback channel only.
    """

    def __init__(self, loader):
        self.loader = loader
        self.sampler_iter = enumerate(iter(loader.batch_sampler))
        methods = mp.get_all_start_methods()
        ctx = mp.get_context("fork" if "fork" in methods else "spawn")
        self.index_queues = []
        self.data_queue = ctx.Queue()
        self.workers = []
        self.ring = None
        if loader.use_shared_memory:
            from . import shm_ring
            if shm_ring.native_available():
                self.ring = shm_ring.ShmRing(
                    n_slots=max(8, 2 * loader.num_workers
                                * loader.prefetch_factor))
        seed = prandom.default_generator("cpu").initial_seed()
        for wid in range(loader.num_workers):
            iq = ctx.Queue()
            worker_collate = (numpy_collate_fn
                              if loader.collate_fn is default_collate_fn
                              else loader.collate_fn)
            w = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, iq, self.data_queue, worker_collate,
                      loader.worker_init_fn, wid, seed,
                      self.ring.name if self.ring is not None else None,
                      loader.num_workers),
                daemon=True)
            w.start()
            self.index_queues.append(iq)
            self.workers.append(w)
        self.next_job = 0
        self.next_deliver = 0
        self.cache = {}
        self.outstanding = 0
        for _ in range(loader.num_workers * loader.prefetch_factor):
            self._dispatch()

    def _dispatch(self):
        try:
            job_id, indices = next(self.sampler_iter)
        except StopIteration:
            return
        self.index_queues[job_id % len(self.index_queues)].put((job_id, indices))
        self.outstanding += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self.next_deliver not in self.cache and self.outstanding == 0:
            self._shutdown()
            raise StopIteration
        while self.next_deliver not in self.cache:
            job_id, batch, err = self._recv()
            self.outstanding -= 1
            if err is not None:
                self._shutdown()
                raise err
            self.cache[job_id] = batch
        batch = self.cache.pop(self.next_deliver)
        self.next_deliver += 1
        self._dispatch()
        return _to_tensor_tree(batch)

    def _recv(self):
        if self.ring is None:
            return self.data_queue.get()
        while True:
            got = self.ring.recv(timeout_ms=100)
            if got is not None:
                return got[1]
            try:  # fallback channel (ring send failed in a worker)
                return self.data_queue.get_nowait()
            except queue.Empty:
                if not any(w.is_alive() for w in self.workers):
                    raise RuntimeError(
                        "DataLoader workers exited unexpectedly")

    def _shutdown(self):
        for iq in self.index_queues:
            try:
                iq.put(None)
            except (OSError, ValueError, AssertionError):
                pass   # queue already closed/broken mid-shutdown
        if self.ring is not None:
            self.ring.stop()
        for w in self.workers:
            w.join(timeout=1.0)
            if w.is_alive():
                w.terminate()
        if self.ring is not None:
            self.ring.close(unlink=True)
            self.ring = None

    def __del__(self):
        self._shutdown()


class _PrefetchIter:
    """Background-thread double buffering (BufferedReader parity)."""

    def __init__(self, inner, depth=2):
        self.inner = inner
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.done = object()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            for item in self.inner:
                self.q.put(item)
        # ptlint: disable=EXC001 — prefetch boundary: the exception is
        # handed to the consuming thread and re-raised from __next__
        except Exception as e:
            self.q.put(e)
        self.q.put(self.done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self.done:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", batch_size)
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __iter__(self):
        if self._iterable:
            it = _IterableDatasetIter(self)
        elif self.num_workers > 0:
            it = _MultiProcessIter(self)
        else:
            it = _SingleProcessIter(self)
        if self.use_buffer_reader and self.num_workers == 0 and not self._iterable:
            return _PrefetchIter(it, depth=self.prefetch_factor)
        return it

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no length")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()
