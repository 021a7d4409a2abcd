"""paddle_tpu_torch.incubate — the experimental namespace of the eager
API: the fused layers and functionals of `incubate.nn`."""
from . import nn  # noqa: F401
