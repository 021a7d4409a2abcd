"""Vision transforms — port of paddle_tpu/vision/transforms.py, every
class and function.

Host-side preprocessing on HWC numpy arrays, as in the JAX package: the
transforms run in the DataLoader's workers, which make no CUDA call.
Randomness comes from Python's `random` module, as in the JAX package,
so the same seed gives the same crops and flips in both. `Resize` runs
`torch.nn.functional.interpolate` with antialiasing on the CPU where the
JAX package runs `jax.image.resize` (a recorded divergence: close, not
bit-equal); `erase` on a Tensor writes into its torch tensor.
"""
from __future__ import annotations

import numbers
import random as pyrandom
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as TF


def _to_hwc_array(img):
    if isinstance(img, np.ndarray):
        return img
    # PIL image duck-typing
    return np.asarray(img)


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(_to_hwc_array(img))


class ToTensor(BaseTransform):
    """HWC uint8 [0,255] → CHW float32 [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        out = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 \
            else img.astype(np.float32)
        if self.data_format == "CHW":
            out = out.transpose(2, 0, 1)
        return out


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        img = img.astype(np.float32)
        if self.data_format == "CHW":
            shape = (-1, 1, 1)
        else:
            shape = (1, 1, -1)
        return (img - self.mean.reshape(shape)) / self.std.reshape(shape)


class Resize(BaseTransform):
    """Resize an HWC image on the CPU with `F.interpolate(...,
    antialias=True)` in f32: the triangle (bilinear) or cubic filter
    widened by the scale when it downsamples, as `jax.image.resize` does.
    The two agree closely, not bit for bit (tests/test_torch_vision.py
    states the gap); a uint8 image is clipped and truncated back to
    uint8, as in the JAX package."""

    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.interpolation = interpolation

    def _apply_image(self, img):
        h, w = self.size
        mode = {"bilinear": "bilinear", "nearest": "nearest",
                "bicubic": "bicubic"}[self.interpolation]
        squeeze = img.ndim == 2
        if squeeze:
            img = img[:, :, None]
        x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
        x = x.permute(2, 0, 1)[None]
        if mode == "nearest":
            y = TF.interpolate(x, size=(h, w), mode="nearest-exact")
        else:
            y = TF.interpolate(x, size=(h, w), mode=mode,
                               align_corners=False, antialias=True)
        out = y[0].permute(1, 2, 0).numpy()
        if img.dtype == np.uint8:
            out = np.clip(out, 0, 255).astype(np.uint8)
        return out[:, :, 0] if squeeze else out


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        h, w = img.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return img[i:i + th, j:j + tw]


def _norm_padding4(p):
    """int | (lr, tb) | (l, t, r, b) → (l, t, r, b)."""
    if isinstance(p, (int, numbers.Integral)):
        return (p, p, p, p)
    p = tuple(p)
    if len(p) == 2:
        return (p[0], p[1], p[0], p[1])
    if len(p) == 4:
        return p
    raise ValueError(f"padding must be int, 2-tuple, or 4-tuple; got {p}")


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill

    def _apply_image(self, img):
        if self.padding:
            l, t, r, b = _norm_padding4(self.padding)
            pads = [(t, b), (l, r)] + [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pads, constant_values=self.fill)
        h, w = img.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            pads = [(0, max(th - h, 0)), (0, max(tw - w, 0))] + \
                [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pads, constant_values=self.fill)
            h, w = img.shape[:2]
        if h < th or w < tw:
            raise ValueError(
                f"image ({h},{w}) smaller than crop {self.size}; pass "
                "pad_if_needed=True")
        i = pyrandom.randint(0, h - th)
        j = pyrandom.randint(0, w - tw)
        return img[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if pyrandom.random() < self.prob:
            return img[:, ::-1].copy()
        return img


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if pyrandom.random() < self.prob:
            return img[::-1].copy()
        return img


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * pyrandom.uniform(*self.scale)
            ar = np.exp(pyrandom.uniform(np.log(self.ratio[0]), np.log(self.ratio[1])))
            tw = int(round(np.sqrt(target_area * ar)))
            th = int(round(np.sqrt(target_area / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = pyrandom.randint(0, h - th)
                j = pyrandom.randint(0, w - tw)
                return self.resize._apply_image(img[i:i + th, j:j + tw])
        return self.resize._apply_image(CenterCrop(min(h, w))._apply_image(img))


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant"):
        self.padding = _norm_padding4(padding)
        self.fill = fill

    def _apply_image(self, img):
        l, t, r, b = self.padding
        pads = [(t, b), (l, r)] + [(0, 0)] * (img.ndim - 2)
        return np.pad(img, pads, constant_values=self.fill)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        if img.ndim == 2:
            img = img[:, :, None]
        return img.transpose(self.order)


class BrightnessTransform(BaseTransform):
    def __init__(self, value):
        self.value = value

    def _apply_image(self, img):
        f = 1 + pyrandom.uniform(-self.value, self.value)
        return np.clip(img.astype(np.float32) * f, 0,
                       255 if img.dtype == np.uint8 else np.inf).astype(img.dtype)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast

    def _apply_image(self, img):
        out = img.astype(np.float32)
        if self.brightness:
            out = out * (1 + pyrandom.uniform(-self.brightness, self.brightness))
        if self.contrast:
            mean = out.mean()
            out = (out - mean) * (1 + pyrandom.uniform(-self.contrast, self.contrast)) + mean
        hi = 255 if img.dtype == np.uint8 else np.inf
        return np.clip(out, 0, hi).astype(img.dtype)


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(_to_hwc_array(img))


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return _to_hwc_array(img)[:, ::-1].copy()


def center_crop(img, output_size):
    return CenterCrop(output_size)(img)


# ---------------------------------------------------------------------------
# Functional surface — paddle.vision.transforms functional parity
# (python/paddle/vision/transforms/functional.py, upstream-canonical,
# unverified — SURVEY.md §0). Numpy-array HWC images in/out, like the
# reference's numpy backend; the class transforms above compose these.
# ---------------------------------------------------------------------------

def vflip(img):
    return _to_hwc_array(img)[::-1].copy()


def crop(img, top, left, height, width):
    return _to_hwc_array(img)[top:top + height, left:left + width].copy()


def pad(img, padding, fill=0, padding_mode="constant"):
    a = _to_hwc_array(img)
    l, t, r, b = _norm_padding4(padding)
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kw = {"constant_values": fill} if padding_mode == "constant" else {}
    return np.pad(a, ((t, b), (l, r), (0, 0)), mode=mode, **kw)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate by `angle` degrees counter-clockwise about the center
    (nearest-neighbor resampling; the reference's PIL backend default)."""
    orig = _to_hwc_array(img)
    a = orig.astype(np.float32)
    h, w = a.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else \
        (center[1], center[0])
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    xs = cos * (xx - cx) + sin * (yy - cy) + cx
    ys = -sin * (xx - cx) + cos * (yy - cy) + cy
    xi = np.round(xs).astype(np.int64)
    yi = np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full_like(a, float(fill))
    out[valid] = a[yi[valid], xi[valid]]
    return out.astype(orig.dtype)


def adjust_brightness(img, brightness_factor):
    orig = _to_hwc_array(img)
    a = orig.astype(np.float32)
    hi = 255.0 if np.issubdtype(orig.dtype, np.integer) else 1.0
    return np.clip(a * brightness_factor, 0, hi).astype(orig.dtype)


def adjust_contrast(img, contrast_factor):
    orig = _to_hwc_array(img)
    a = orig.astype(np.float32)
    mean = a.mean()
    hi = 255.0 if np.issubdtype(orig.dtype, np.integer) else 1.0
    return np.clip(mean + contrast_factor * (a - mean), 0, hi).astype(
        orig.dtype)


def adjust_hue(img, hue_factor):
    """Shift hue by hue_factor (in [-0.5, 0.5] turns) via RGB<->HSV."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError(f"hue_factor {hue_factor} not in [-0.5, 0.5]")
    orig = _to_hwc_array(img)
    hi = 255.0 if np.issubdtype(orig.dtype, np.integer) else 1.0
    a = orig.astype(np.float32) / hi
    r, g, b = a[..., 0], a[..., 1], a[..., 2]
    mx, mn = a.max(-1), a.min(-1)
    d = mx - mn
    h = np.zeros_like(mx)
    mask = d > 0
    rm = mask & (mx == r)
    gm = mask & (mx == g) & ~rm
    bm = mask & ~rm & ~gm
    h[rm] = ((g - b)[rm] / d[rm]) % 6
    h[gm] = (b - r)[gm] / d[gm] + 2
    h[bm] = (r - g)[bm] / d[bm] + 4
    h = (h / 6.0 + hue_factor) % 1.0
    s = np.where(mx > 0, d / np.maximum(mx, 1e-12), 0)
    v = mx
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.astype(np.int64) % 6
    rgb = np.stack([
        np.choose(i, [v, q, p, p, t, v]),
        np.choose(i, [t, v, v, q, p, p]),
        np.choose(i, [p, p, t, v, v, q])], axis=-1)
    return (rgb * hi).astype(orig.dtype)


def to_grayscale(img, num_output_channels=1):
    orig = _to_hwc_array(img)
    a = orig.astype(np.float32)
    gray = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    out = np.repeat(gray[..., None], num_output_channels, axis=-1)
    return out.astype(orig.dtype)


def erase(img, i, j, h, w, v, inplace=False):
    """paddle.vision.transforms.erase: fill region [i:i+h, j:j+w] with v.
    Tensor input stays CHW tensor (reference semantics); arrays are HWC."""
    from ..core.tensor import Tensor
    if isinstance(img, Tensor):
        data = img._data if inplace else img._data.clone()
        with torch.no_grad():
            data[:, i:i + h, j:j + w] = torch.as_tensor(
                np.asarray(v), dtype=data.dtype, device=data.device)
        if inplace:
            return img
        return Tensor(data)
    a = _to_hwc_array(img)
    out = a if inplace else a.copy()
    out[i:i + h, j:j + w] = np.broadcast_to(
        np.asarray(v, a.dtype), (h, w, a.shape[2]))
    return out


def affine(img, angle, translate, scale, shear, interpolation="nearest",
           fill=0, center=None):
    """Affine transform: rotate(angle) + translate + scale + shear, about
    the image center (inverse-map nearest resampling)."""
    orig = _to_hwc_array(img)
    a = orig.astype(np.float32)
    h, w = a.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else \
        (center[1], center[0])
    rad = np.deg2rad(angle)
    sx = np.deg2rad(shear[0] if isinstance(shear, (list, tuple)) else shear)
    sy = np.deg2rad(shear[1] if isinstance(shear, (list, tuple))
                    and len(shear) > 1 else 0.0)
    # forward matrix M = R(angle) @ Shear @ diag(scale); sample via M^-1
    m = np.array([
        [np.cos(rad + sy) / np.cos(sy),
         -np.cos(rad + sy) * np.tan(sx) / np.cos(sy) - np.sin(rad)],
        [np.sin(rad + sy) / np.cos(sy),
         -np.sin(rad + sy) * np.tan(sx) / np.cos(sy) + np.cos(rad)],
    ]) * scale
    minv = np.linalg.inv(m)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    dx = xx - cx - translate[0]
    dy = yy - cy - translate[1]
    xs = minv[0, 0] * dx + minv[0, 1] * dy + cx
    ys = minv[1, 0] * dx + minv[1, 1] * dy + cy
    xi, yi = np.round(xs).astype(np.int64), np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full_like(a, float(fill))
    out[valid] = a[yi[valid], xi[valid]]
    return out.astype(orig.dtype)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """Perspective transform mapping startpoints -> endpoints (4 corner
    pairs), inverse-map nearest resampling."""
    orig = _to_hwc_array(img)
    a = orig.astype(np.float32)
    h, w = a.shape[:2]
    # solve the 8-dof homography sending endpoints -> startpoints
    A, bvec = [], []
    for (ex, ey), (sx_, sy_) in zip(endpoints, startpoints):
        A.append([ex, ey, 1, 0, 0, 0, -sx_ * ex, -sx_ * ey])
        bvec.append(sx_)
        A.append([0, 0, 0, ex, ey, 1, -sy_ * ex, -sy_ * ey])
        bvec.append(sy_)
    coef = np.linalg.solve(np.asarray(A, np.float64),
                           np.asarray(bvec, np.float64))
    hm = np.append(coef, 1.0).reshape(3, 3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    den = hm[2, 0] * xx + hm[2, 1] * yy + hm[2, 2]
    xs = (hm[0, 0] * xx + hm[0, 1] * yy + hm[0, 2]) / den
    ys = (hm[1, 0] * xx + hm[1, 1] * yy + hm[1, 2]) / den
    xi, yi = np.round(xs).astype(np.int64), np.round(ys).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full_like(a, float(fill))
    out[valid] = a[yi[valid], xi[valid]]
    return out.astype(orig.dtype)


def adjust_saturation(img, saturation_factor):
    orig = _to_hwc_array(img)
    a = orig.astype(np.float32)
    gray = (0.299 * a[..., 0] + 0.587 * a[..., 1]
            + 0.114 * a[..., 2])[..., None]
    hi = 255.0 if np.issubdtype(orig.dtype, np.integer) else 1.0
    return np.clip(gray + saturation_factor * (a - gray), 0, hi).astype(
        orig.dtype)


# ---------------------------------------------------------------------------
# Round-3: transform classes over the functional surface
# (python/paddle/vision/transforms/transforms.py parity). House contract:
# implement _apply_image (BaseTransform.__call__ owns the HWC conversion)
# and draw randomness from pyrandom, like every other class here — one
# seedable RNG source for the whole pipeline.
# ---------------------------------------------------------------------------

class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if value < 0:
            raise ValueError(f"contrast value must be >= 0, got {value}")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        # reference clamps the low end at 0 — no contrast inversion
        f = pyrandom.uniform(max(0.0, 1.0 - self.value), 1.0 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if value < 0:
            raise ValueError(f"saturation value must be >= 0, got {value}")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = pyrandom.uniform(max(0.0, 1.0 - self.value), 1.0 + self.value)
        return adjust_saturation(img, f)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        if not 0 <= value <= 0.5:
            raise ValueError(
                f"hue value must be in [0, 0.5], got {value}")
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, pyrandom.uniform(-self.value, self.value))


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        if expand:
            raise NotImplementedError(
                "RandomRotation(expand=True): canvas growth is not "
                "implemented — rotate() keeps the input extent "
                "(paddle_tpu/vision/transforms.py)")
        self.degrees = (-degrees, degrees) if isinstance(
            degrees, numbers.Number) else tuple(degrees)
        self.center = center
        self.fill = fill

    def _apply_image(self, img):
        angle = pyrandom.uniform(*self.degrees)
        return rotate(img, angle, center=self.center, fill=self.fill)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        self.degrees = (-degrees, degrees) if isinstance(
            degrees, numbers.Number) else tuple(degrees)
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.fill = fill
        self.center = center

    def _apply_image(self, img):
        h, w = img.shape[:2]
        angle = pyrandom.uniform(*self.degrees)
        tx = ty = 0.0
        if self.translate is not None:
            tx = pyrandom.uniform(-self.translate[0], self.translate[0]) * w
            ty = pyrandom.uniform(-self.translate[1], self.translate[1]) * h
        sc = 1.0 if self.scale is None else pyrandom.uniform(*self.scale)
        if self.shear is None:
            sh = 0.0
        elif isinstance(self.shear, numbers.Number):
            sh = pyrandom.uniform(-self.shear, self.shear)
        elif len(self.shear) == 4:   # [min_x, max_x, min_y, max_y]
            sh = (pyrandom.uniform(self.shear[0], self.shear[1]),
                  pyrandom.uniform(self.shear[2], self.shear[3]))
        else:
            sh = pyrandom.uniform(*self.shear)
        return affine(img, angle, (tx, ty), sc, sh, fill=self.fill,
                      center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if pyrandom.random() >= self.prob:
            return img
        h, w = img.shape[:2]
        d = self.distortion_scale
        dx, dy = int(d * w / 2), int(d * h / 2)
        # reference semantics: corners displace strictly INTO the image
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        signs = [(1, 1), (-1, 1), (-1, -1), (1, -1)]
        end = [(x + sx * pyrandom.randint(0, max(dx, 0)),
                y + sy * pyrandom.randint(0, max(dy, 0)))
               for (x, y), (sx, sy) in zip(start, signs)]
        return perspective(img, start, end, fill=self.fill)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.inplace = inplace

    def __call__(self, img):
        # CHW Tensors keep their type — erase() has a dedicated Tensor
        # branch; everything else takes the HWC array path
        from ..core.tensor import Tensor
        if isinstance(img, Tensor):
            c, h, w = img.shape[-3], img.shape[-2], img.shape[-1]
            box = self._pick(h, w)
            if box is None:
                return img
            i, j, eh, ew = box
            v = self._fill_value((c, eh, ew), img.numpy().dtype)
            return erase(img, i, j, eh, ew, v, inplace=self.inplace)
        return super().__call__(img)

    def _fill_value(self, shape, dtype):
        if isinstance(self.value, str):
            if self.value != "random":
                raise ValueError(f"RandomErasing value {self.value!r}: "
                                 "'random' or a number/sequence")
            if np.issubdtype(np.dtype(dtype), np.integer):
                return np.random.randint(0, 256, shape).astype(dtype)
            return np.random.standard_normal(shape).astype(dtype)
        return self.value

    def _pick(self, h, w):
        if pyrandom.random() >= self.prob:
            return None
        area = h * w
        for _ in range(10):
            target = pyrandom.uniform(*self.scale) * area
            log_lo, log_hi = np.log(self.ratio[0]), np.log(self.ratio[1])
            ar = np.exp(pyrandom.uniform(log_lo, log_hi))
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if 0 < eh < h and 0 < ew < w:
                # INCLUSIVE bounds: edge-flush placements are reachable
                return (pyrandom.randint(0, h - eh),
                        pyrandom.randint(0, w - ew), eh, ew)
        return None

    def _apply_image(self, img):
        box = self._pick(img.shape[0], img.shape[1])
        if box is None:
            return img
        i, j, eh, ew = box
        v = self._fill_value((eh, ew, img.shape[2]), img.dtype)
        return erase(img, i, j, eh, ew, v, inplace=self.inplace)
