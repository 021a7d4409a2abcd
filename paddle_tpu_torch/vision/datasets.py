"""Vision datasets — port of paddle_tpu/vision/datasets.py's FakeData,
the synthetic image-classification set the tests and the card run use
(images drawn from a seed, nothing downloaded). The file-backed sets
(MNIST, Cifar, ImageFolder, ...) arrive with a later slice."""
from __future__ import annotations

import numpy as np

from ..io.dataset import Dataset


class FakeData(Dataset):
    """Image `idx` and its label drawn from numpy's generator seeded
    `seed + idx`, so every worker and both packages see the same set."""

    def __init__(self, size=1000, image_shape=(3, 224, 224), num_classes=10,
                 transform=None, seed=0):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed + idx)
        img = rng.standard_normal(self.image_shape).astype(np.float32)
        label = int(rng.integers(0, self.num_classes))
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(label, dtype=np.int64)

    def __len__(self):
        return self.size
