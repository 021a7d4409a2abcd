"""paddle_tpu_torch.optimizer — the optimizers: the eager API's
`Optimizer`, `Adam`, `AdamW` and `ClipGradByGlobalNorm` (`optimizers`),
the optax-style transformations of the training step (`transform`) and
the 8-bit blockwise AdamW with its fused CUDA update (`quant_state`)."""
from .optimizers import (Optimizer, Adam, AdamW,  # noqa: F401
                         ClipGradByGlobalNorm)
