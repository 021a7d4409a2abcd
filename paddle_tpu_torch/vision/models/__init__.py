"""paddle_tpu_torch.vision.models — port of paddle_tpu/vision/models/:
the ResNet family so far; the other families arrive with later slices
(ROADMAP.md Queue 1)."""
from .resnet import (  # noqa: F401
    ResNet, BasicBlock, BottleneckBlock, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext101_64x4d, wide_resnet50_2,
)
