"""Samplers — port of paddle_tpu/io/sampler.py. `RandomSampler` draws from
the port's seeded CPU generator (`core.random`) where the JAX package
draws from `jax.random` (:41-50): both give a permutation, not the same
one (ROADMAP.md Queue 3). `DistributedBatchSampler` takes its replica
count and rank from an initialized `torch.distributed` group, else one
replica."""
from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core import random as prandom


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        g = prandom.default_generator("cpu")
        if self.replacement:
            idx = torch.randint(0, n, (self.num_samples,), generator=g)
        else:
            idx = torch.randperm(n, generator=g)[:self.num_samples]
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.default_rng().choice(
            len(self.weights), size=self.num_samples, replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        self.indices = list(indices)

    def __iter__(self):
        perm = np.random.default_rng().permutation(len(self.indices))
        return iter([self.indices[i] for i in perm])

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards indices across data-parallel ranks. num_replicas/rank
    default to the initialized torch.distributed group's, else 1 and 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            ready = dist.is_available() and dist.is_initialized()
            if num_replicas is None:
                num_replicas = dist.get_world_size() if ready else 1
            if rank is None:
                rank = dist.get_rank() if ready else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        n = len(dataset)
        if drop_last:
            self.num_samples = n // num_replicas
        else:
            self.num_samples = int(math.ceil(n / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        if not self.drop_last:
            while len(indices) < self.total_size:  # pad may exceed len(dataset)
                indices += indices[: self.total_size - len(indices)]
        else:
            indices = indices[: self.total_size]
        local = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size
