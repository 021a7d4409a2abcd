"""paddle_tpu_torch.optimizer — the optimizers: the eager API's
`Optimizer`, `SGD`, `Momentum`, `Adam`, `AdamW`, `Adagrad`, `RMSProp`,
`Adamax`, `Lamb`, `Adadelta`, `Rprop`, `ASGD`, `NAdam`, `RAdam` and the
closure-driven `LBFGS`, the three clips and the regularizers `L1Decay`
and `L2Decay` (`optimizers`), the learning-rate schedulers (`lr`), the
optax-style transformations of the training step (`transform`) and the
8-bit blockwise AdamW with its fused CUDA update (`quant_state`)."""
from . import lr  # noqa: F401
from .optimizers import (Optimizer, SGD, Momentum, Adam,  # noqa: F401
                         AdamW, Adagrad, RMSProp, Adamax, Lamb, Adadelta,
                         Rprop, ASGD, NAdam, RAdam, LBFGS,
                         ClipGradByGlobalNorm, ClipGradByNorm,
                         ClipGradByValue, L1Decay, L2Decay)
