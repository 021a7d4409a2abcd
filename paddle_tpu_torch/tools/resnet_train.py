"""ResNet-50 training on the eager API: BASELINE.md config 0.

    from paddle_tpu_torch.tools import resnet_train
    model, opt, sched = resnet_train.build(paddle, depth=50)
    loss = resnet_train.train_step(paddle, model, opt, sched, x, y,
                                   amp_dtype="bfloat16")

The recipe of He et al. 2016 §3.4: Momentum 0.9, weight decay 1e-4 (a
float coefficient: L2Decay objects arrive with the rest of the eager
API), the learning rate 0.1 divided by 10 at epochs 30 and 60 of
ImageNet's 1,281,167 images at batch 256 (`PiecewiseDecay`, stepped once
a step), the model from its own initializer (`pretrained=False`).
`image_pipeline` is the input side of the same recipe over seeded uint8
HWC images: RandomResizedCrop(224), RandomHorizontalFlip, Normalize with
the ImageNet channel statistics and Transpose to CHW, in DataLoader
workers. `forward_macs` counts one image's multiply-accumulates of the
convolutions and the classifier from the layers' shapes.
"""
from __future__ import annotations

import contextlib

import numpy as np

from ..io.dataset import Dataset

IMAGENET_TRAIN = 1281167
EPOCH_BOUNDARIES = (30, 60)
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def build(paddle, depth: int = 50, num_classes: int = 1000,
          batch: int = 256):
    """(model, Momentum optimizer, PiecewiseDecay scheduler) on the
    current place."""
    model = getattr(paddle.vision.models, f"resnet{depth}")(
        num_classes=num_classes)
    steps = -(-IMAGENET_TRAIN // batch)
    sched = paddle.optimizer.lr.PiecewiseDecay(
        [e * steps for e in EPOCH_BOUNDARIES], [0.1, 0.01, 0.001])
    opt = paddle.optimizer.Momentum(
        learning_rate=sched, momentum=0.9, weight_decay=1e-4,
        parameters=model.parameters())
    return model, opt, sched


def train_step(paddle, model, opt, sched, images, labels, amp_dtype=None,
               span=None):
    """Forward and cross-entropy (under O1 auto_cast in `amp_dtype`, or
    f32), backward, the Momentum step, clear_grad and the scheduler's
    step. Returns the loss Tensor. `span(name)`, when given, is entered
    around "resnet_forward", "resnet_backward" and "resnet_optimizer"."""
    span = span or (lambda name: contextlib.nullcontext())
    with span("resnet_forward"), paddle.amp.auto_cast(
            enable=amp_dtype is not None, level="O1",
            dtype=amp_dtype or "bfloat16"):
        loss = paddle.nn.functional.cross_entropy(model(images), labels)
    with span("resnet_backward"):
        loss.backward()
    with span("resnet_optimizer"):
        opt.step()
        opt.clear_grad()
        sched.step()
    return loss


def forward_macs(paddle, model, image_size: int = 224) -> int:
    """One image's multiply-accumulates in the convolutions and the
    classifier, from each layer's output shape in a batch-1 forward (eval
    mode, no gradient: the BatchNorm statistics do not move)."""
    nn = paddle.nn
    macs = []

    def conv_hook(layer, inputs, out):
        k = int(np.prod(layer._kernel_size))
        per_out = (layer._in_channels // layer._groups) * k
        macs.append(int(np.prod(out.shape[1:])) * per_out)

    def fc_hook(layer, inputs, out):
        macs.append(int(np.prod(layer.weight.shape)))

    hooks = []
    for layer in model.sublayers(include_self=True):
        if isinstance(layer, nn.Conv2D):
            hooks.append(layer.register_forward_post_hook(conv_hook))
        elif isinstance(layer, nn.Linear):
            hooks.append(layer.register_forward_post_hook(fc_hook))
    was_training = model.training
    model.eval()
    try:
        with paddle.no_grad():
            model(paddle.zeros([1, 3, image_size, image_size]))
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            model.train()
    return int(sum(macs))


class SyntheticImages(Dataset):
    """`n` uint8 HWC images of `hw` and their labels, drawn in bulk from
    `seed`, each passed through `transform` when read."""

    def __init__(self, n, hw=(256, 320), num_classes=1000, transform=None,
                 seed=0):
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n,) + tuple(hw) + (3,),
                                   dtype=np.uint8)
        self.labels = rng.integers(0, num_classes, (n,)).astype(np.int64)
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = self.images[i]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[i]


def image_pipeline(paddle, n=1024, hw=(256, 320), batch=256, workers=8,
                   size=224, seed=0):
    """A DataLoader over `SyntheticImages` with the training transforms,
    shuffled, in `workers` processes over the shared-memory ring."""
    T = paddle.vision.transforms
    tf = T.Compose([T.RandomResizedCrop(size), T.RandomHorizontalFlip(),
                    T.Normalize(MEAN, STD, data_format="HWC"),
                    T.Transpose()])
    data = SyntheticImages(n, hw, transform=tf, seed=seed)
    return paddle.io.DataLoader(data, batch_size=batch, shuffle=True,
                                num_workers=workers, use_shared_memory=True)
