"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``).

A transform takes an HWC image: a numpy array, which is what the
datasets and the ``DataLoader``'s workers hold, or an NDArray (its
``forward`` then sees the tensor, as every port block's does).  On a
numpy input every transform computes in numpy and cv2 and returns numpy,
with the reference's arithmetic, and runs no torch operation (so a
forked worker may run it); on an NDArray it computes on the array's
device and returns an NDArray.  Random transforms draw from Python's
``random`` (and ``RandomLighting`` from numpy's global state), as the
reference's do, so seeded generators give the reference's crops, flips
and jitters."""
from __future__ import annotations

import math
import numbers
import random as _pyrandom

import numpy as _onp
import torch

from ....ndarray.ndarray import to_torch_dtype
from ...block import Block, HybridBlock
from ...nn import HybridSequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomCrop",
           "RandomFlipLeftRight", "RandomFlipTopBottom", "RandomBrightness",
           "RandomContrast", "RandomSaturation", "RandomColorJitter",
           "RandomLighting"]


def _host(x):
    return not isinstance(x, torch.Tensor)


def _like(arr, ref):
    """numpy ``arr`` in the array world of ``ref``: numpy for numpy, a
    tensor on ``ref``'s device for a tensor."""
    if _host(ref):
        return arr
    return torch.from_numpy(_onp.ascontiguousarray(arr)).to(ref.device)


def _cast(x, dtype):
    if _host(x):
        return x.astype(dtype)
    return x.to(to_torch_dtype(dtype) if isinstance(dtype, str) else dtype)


def _clip(x, lo, hi):
    return x.clip(lo, hi) if _host(x) else x.clamp(lo, hi)


def _mean(x, axis=None, keepdims=False):
    if _host(x):
        return x.mean(axis=axis, keepdims=keepdims)
    return x.mean() if axis is None else x.mean(dim=axis, keepdim=keepdims)


def _flip(x, axis):
    if _host(x):
        return _onp.flip(x, axis=axis)
    return torch.flip(x, dims=(axis,))


class Compose(HybridSequential):
    """The transforms in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _cast(x, self._dtype)


class ToTensor(HybridBlock):
    """HWC (or NHWC) uint8 in [0, 255] -> CHW (NCHW) float32 in [0, 1]."""

    def forward(self, x):
        perm = (2, 0, 1) if x.ndim == 3 else (0, 3, 1, 2)
        if _host(x):
            # the reference's float32 division, in one pass that writes
            # the (N)CHW layout contiguously
            return _onp.divide(x.transpose(*perm), _onp.float32(255.0),
                               dtype=_onp.float32, order="C")
        return (_cast(x, "float32") / 255.0).permute(*perm)


class Normalize(HybridBlock):
    """``(x - mean) / std`` over a CHW image, per channel for sequences."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean
        self._std = std

    def forward(self, x):
        mean, std = self._mean, self._std
        if not isinstance(mean, numbers.Number):
            mean = _like(_onp.array(mean, dtype="float32").reshape(-1, 1, 1),
                         x)
        if not isinstance(std, numbers.Number):
            std = _like(_onp.array(std, dtype="float32").reshape(-1, 1, 1),
                        x)
        return (x - mean) / std


def _resize_np(img, size, interp=1):
    """``img`` resized by cv2 to ``size`` ((w, h), or the short side for
    an int), in ``img``'s array world; interpolation codes as the
    reference's (0 nearest, 1 bilinear, 2 bicubic, 3 area, 4 lanczos)."""
    import cv2
    if isinstance(size, int):
        h, w = img.shape[:2]
        if h < w:
            new_h, new_w = size, int(w * size / h)
        else:
            new_h, new_w = int(h * size / w), size
    else:
        new_w, new_h = size
    arr = _onp.asarray(img) if _host(img) else img.cpu().numpy()
    inter = {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR,
             2: cv2.INTER_CUBIC, 3: cv2.INTER_AREA,
             4: cv2.INTER_LANCZOS4}.get(interp, cv2.INTER_LINEAR)
    out = cv2.resize(arr, (new_w, new_h), interpolation=inter)
    if out.ndim == 2:
        out = out[:, :, None]
    return _like(out, img)


class Resize(Block):
    """Resize to ``size`` ((w, h), or an int: a square, or the short side
    with ``keep_ratio``)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        size = self._size
        if isinstance(size, int) and not self._keep:
            size = (size, size)
        return _resize_np(x, size, self._interpolation)


class CenterCrop(Block):
    """The central (w, h) crop, the image first enlarged if smaller."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._interpolation = interpolation

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        if H < h or W < w:
            x = _resize_np(x, (max(w, W), max(h, H)), self._interpolation)
            H, W = x.shape[0], x.shape[1]
        y0 = (H - h) // 2
        x0 = (W - w) // 2
        return x[y0:y0 + h, x0:x0 + w]


class RandomResizedCrop(Block):
    """A random crop of ``scale`` of the area and ``ratio`` aspect,
    resized to ``size`` (ten tries, then the central crop)."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = _pyrandom.uniform(*self._scale) * area
            log_ratio = (math.log(self._ratio[0]), math.log(self._ratio[1]))
            aspect = math.exp(_pyrandom.uniform(*log_ratio))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = _pyrandom.randint(0, W - w)
                y0 = _pyrandom.randint(0, H - h)
                crop = x[y0:y0 + h, x0:x0 + w]
                return _resize_np(crop, self._size, self._interpolation)
        return CenterCrop(self._size)(x)


class RandomCrop(Block):
    """A random (w, h) crop, after zero padding by ``pad``."""

    def __init__(self, size, pad=None, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._pad = pad

    def forward(self, x):
        if self._pad:
            p = self._pad
            if _host(x):
                x = _onp.pad(x, ((p, p), (p, p), (0, 0)))
            else:
                x = torch.nn.functional.pad(x, (0, 0, p, p, p, p))
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        y0 = _pyrandom.randint(0, max(H - h, 0))
        x0 = _pyrandom.randint(0, max(W - w, 0))
        return x[y0:y0 + h, x0:x0 + w]


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if _pyrandom.random() < 0.5:
            return _flip(x, 1)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if _pyrandom.random() < 0.5:
            return _flip(x, 0)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._brightness = brightness

    def forward(self, x):
        alpha = 1.0 + _pyrandom.uniform(-self._brightness, self._brightness)
        return _cast(_clip(_cast(x, "float32") * alpha, 0, 255), x.dtype)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._contrast = contrast

    def forward(self, x):
        alpha = 1.0 + _pyrandom.uniform(-self._contrast, self._contrast)
        xf = _cast(x, "float32")
        gray = _mean(xf)
        return _cast(_clip((xf - gray) * alpha + gray, 0, 255), x.dtype)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._saturation = saturation

    def forward(self, x):
        alpha = 1.0 + _pyrandom.uniform(-self._saturation, self._saturation)
        xf = _cast(x, "float32")
        gray = _mean(xf, axis=-1, keepdims=True)
        return _cast(_clip(xf * alpha + gray * (1 - alpha), 0, 255), x.dtype)


class RandomColorJitter(Block):
    """Brightness, contrast and saturation jitters in a random order
    (``hue`` is accepted, as the reference's is, and not applied)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))

    def forward(self, x):
        ts = list(self._ts)
        _pyrandom.shuffle(ts)
        for t in ts:
            x = t(x)
        return x


class RandomLighting(Block):
    """AlexNet's PCA lighting noise, drawn from numpy's global state."""

    _eigval = _onp.array([55.46, 4.794, 1.148])
    _eigvec = _onp.array([[-0.5675, 0.7192, 0.4009],
                          [-0.5808, -0.0045, -0.8140],
                          [-0.5836, -0.6948, 0.4203]])

    def __init__(self, alpha):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = _onp.random.normal(0, self._alpha, 3)
        rgb = (self._eigvec * a * self._eigval).sum(axis=1)
        rgb = _like(rgb.astype("float32"), x)
        return _cast(_clip(_cast(x, "float32") + rgb, 0, 255), x.dtype)
