"""Datasets — port of paddle_tpu/io/dataset.py. `random_split` draws its
permutation from the port's seeded CPU generator (`core.random`) where
the JAX package draws from `jax.random`: the same seed gives another
split (ROADMAP.md Queue 3)."""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence

import numpy as np
import torch

from ..core import random as prandom


def _permutation(n: int) -> np.ndarray:
    """A permutation of range(n) from the port's seeded CPU generator."""
    return torch.randperm(n, generator=prandom.default_generator("cpu")
                          ).numpy()


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is index-free; iterate it instead")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        lens = {t.shape[0] for t in tensors}
        if len(lens) > 1:
            raise ValueError("all tensors must share dim 0")
        self.tensors = list(tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ConcatDataset(Dataset):
    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        d = bisect.bisect_right(self.cum, idx)
        prev = 0 if d == 0 else self.cum[d - 1]
        return self.datasets[d][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence, generator=None):
    total = len(dataset)
    lengths = list(lengths)
    if all(isinstance(l, float) for l in lengths):
        counts = [int(np.floor(total * f)) for f in lengths]
        for i in range(total - sum(counts)):
            counts[i % len(counts)] += 1
        lengths = counts
    if sum(lengths) != total:
        raise ValueError(f"lengths sum {sum(lengths)} != dataset size {total}")
    perm = _permutation(total)
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out
