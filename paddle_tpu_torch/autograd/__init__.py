"""paddle_tpu_torch.autograd — the grad-mode switches, `backward` and
`grad` over torch autograd (`tape`), `PyLayer` (`pylayer`) and the
functional transforms over torch.func (`functional`)."""
from .tape import (backward, grad, enable_grad, grad_enabled,  # noqa: F401
                   is_grad_enabled, no_grad, set_grad_enabled)
from .pylayer import PyLayer, PyLayerContext, LegacyPyLayer  # noqa: F401
from .functional import (jacobian, hessian, vjp, jvp,  # noqa: F401
                         Jacobian, Hessian)
from . import functional  # noqa: F401
