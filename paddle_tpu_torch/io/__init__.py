"""paddle_tpu_torch.io — datasets, samplers and the DataLoader with its
shared-memory worker transport: port of paddle_tpu/io/."""
from .dataset import (  # noqa: F401
    Dataset, IterableDataset, TensorDataset, ComposeDataset, ChainDataset,
    ConcatDataset, Subset, random_split,
)
from .sampler import (  # noqa: F401
    Sampler, SequenceSampler, RandomSampler, WeightedRandomSampler,
    SubsetRandomSampler, BatchSampler, DistributedBatchSampler,
)
from .dataloader import (DataLoader, default_collate_fn,  # noqa: F401
                         get_worker_info, WorkerInfo)
