"""paddle_tpu_torch.autograd — grad-mode switches and `backward` over
torch autograd (`tape`)."""
from .tape import (backward, enable_grad, grad_enabled, no_grad,  # noqa: F401
                   set_grad_enabled)
