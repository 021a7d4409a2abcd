"""paddle_tpu_torch.vision — port of paddle_tpu/vision/: the transforms,
the ResNet models and the synthetic FakeData dataset."""
from . import transforms  # noqa: F401
from . import models  # noqa: F401
from . import datasets  # noqa: F401
from .datasets import FakeData  # noqa: F401
from .models import *  # noqa: F401,F403
