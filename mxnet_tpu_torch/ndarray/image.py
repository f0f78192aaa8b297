"""``mx.nd.image``: image ops on HWC / NHWC NDArrays, on their device.

Counterpart of ``mxnet_tpu/ndarray/image.py`` (the reference's
``src/operator/image/``: ``to_tensor``, ``normalize``, ``crop``,
``resize``, the flips, the random color augmentations,
``adjust_lighting``).  ``resize`` computes as the reference's
``jax.image.resize`` does (:func:`.legacy_ops.resize_like_jax`:
half-pixel centres; ``"linear"`` antialiased when it shrinks), in
float32, and goes back to the input's dtype by ``astype``, which
truncates.  The random ops draw their factors and positions from
``mx.np.random``'s host generator (the reference's from Python's
``random`` and numpy's global state), so a seed makes them reproducible
but they cannot match the reference's draws.
"""
from __future__ import annotations

import math

import numpy as _onp
import torch

from ..numpy import random as _random
from .legacy_ops import resize_like_jax
from .ndarray import NDArray, apply_op, as_tensor

__all__ = ["to_tensor", "normalize", "resize", "crop", "random_crop",
           "random_resized_crop", "flip_left_right", "flip_top_bottom",
           "random_flip_left_right", "random_flip_top_bottom",
           "random_brightness", "random_contrast", "random_saturation",
           "random_hue", "random_color_jitter", "adjust_lighting",
           "random_lighting"]


def _gen():
    return _random.generator(torch.device("cpu"))


def _uniform(lo, hi):
    return lo + (hi - lo) * torch.rand((), dtype=torch.float64,
                                       generator=_gen()).item()


def _randint(lo, hi):
    """An integer in [lo, hi], both ends included (``random.randint``)."""
    return int(torch.randint(lo, hi + 1, (), generator=_gen()))


def _hwc_axes(x):
    """(h_axis, w_axis, c_axis) of an HWC or NHWC array."""
    if x.ndim == 3:
        return 0, 1, 2
    if x.ndim == 4:
        return 1, 2, 3
    raise ValueError("image ops expect HWC or NHWC, got ndim=%d" % x.ndim)


def _nd(data):
    return data if isinstance(data, NDArray) else NDArray(data)


def to_tensor(data):
    """HWC [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW)."""
    def g(x):
        # a divisor on the device: ATen's CUDA division by a Python
        # scalar multiplies by its reciprocal, one rounding off x / 255
        x = x.to(torch.float32) / torch.tensor(255.0, device=x.device)
        return x.permute(2, 0, 1) if x.dim() == 3 else x.permute(0, 3, 1, 2)
    return apply_op(g, [data], "to_tensor")


def normalize(data, mean=0.0, std=1.0):
    """(x - mean) / std by channel, of CHW / NCHW float input."""
    def g(x):
        shape = (-1, 1, 1) if x.dim() == 3 else (1, -1, 1, 1)
        m = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
        s = torch.as_tensor(std, dtype=torch.float32, device=x.device)
        m = m.reshape(shape) if m.dim() else m
        s = s.reshape(shape) if s.dim() else s
        return (x - m) / s
    return apply_op(g, [data], "normalize")


def resize(data, size=-1, keep_ratio=False, interp=1):
    """HWC / NHWC resized to ``size``: an int (the square side, or with
    ``keep_ratio`` the short side) or (w, h)."""
    method = "nearest" if interp == 0 else "linear"

    def g(x):
        ha, wa, _ = _hwc_axes(x)
        H, W = x.shape[ha], x.shape[wa]
        if isinstance(size, int):
            if size <= 0:
                raise ValueError("resize: size must be positive")
            if keep_ratio:
                nh, nw = (size, max(1, int(W * size / H))) if H < W else \
                    (max(1, int(H * size / W)), size)
            else:
                nh = nw = size
        else:
            nw, nh = size
        nchw = x.permute(2, 0, 1)[None] if x.dim() == 3 else \
            x.permute(0, 3, 1, 2)
        out = resize_like_jax(nchw.float(), (nh, nw), method).to(x.dtype)
        return out[0].permute(1, 2, 0) if x.dim() == 3 else \
            out.permute(0, 2, 3, 1)
    return apply_op(g, [data], "image_resize")


def crop(data, x, y, width, height):
    """The (width, height) window at (x, y)."""
    def g(a):
        if a.dim() == 3:
            return a[y:y + height, x:x + width]
        return a[:, y:y + height, x:x + width]
    return apply_op(g, [data], "image_crop")


def random_crop(data, width, height, xrange=(0.0, 1.0), yrange=(0.0, 1.0),
                interp=1):
    """A crop at a random position within the relative ranges, resized to
    (width, height) when the image is smaller."""
    x = _nd(data)
    ha, wa, _ = _hwc_axes(x)
    H, W = x.shape[ha], x.shape[wa]
    cw, ch = min(width, W), min(height, H)
    x0 = int(_uniform(*xrange) * (W - cw))
    y0 = int(_uniform(*yrange) * (H - ch))
    out = crop(x, x0, y0, cw, ch)
    if (cw, ch) != (width, height):
        out = resize(out, (width, height), interp=interp)
    return out


def random_resized_crop(data, width, height, area=(0.08, 1.0),
                        ratio=(3 / 4.0, 4 / 3.0), interp=1, max_trial=10):
    """Inception-style crop of random area and aspect, resized to (width,
    height); the center crop after ``max_trial`` misses."""
    x = _nd(data)
    ha, wa, _ = _hwc_axes(x)
    H, W = x.shape[ha], x.shape[wa]
    for _ in range(max_trial):
        target = _uniform(*area) * H * W
        aspect = math.exp(_uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target * aspect)))
        ch = int(round(math.sqrt(target / aspect)))
        if cw <= W and ch <= H:
            out = crop(x, _randint(0, W - cw), _randint(0, H - ch), cw, ch)
            return resize(out, (width, height), interp=interp)
    cw, ch = min(width, W), min(height, H)
    out = crop(x, (W - cw) // 2, (H - ch) // 2, cw, ch)
    return resize(out, (width, height), interp=interp)


def flip_left_right(data):
    return apply_op(lambda x: x.flip(_hwc_axes(x)[1]), [data],
                    "flip_left_right")


def flip_top_bottom(data):
    return apply_op(lambda x: x.flip(_hwc_axes(x)[0]), [data],
                    "flip_top_bottom")


def random_flip_left_right(data, p=0.5):
    return flip_left_right(data) if _uniform(0.0, 1.0) < p else data


def random_flip_top_bottom(data, p=0.5):
    return flip_top_bottom(data) if _uniform(0.0, 1.0) < p else data


def _clip_cast(out, dtype):
    """Integer images clipped to [0, 255] before the cast."""
    if not dtype.is_floating_point:
        out = out.clamp(0, 255)
    return out.to(dtype)


_GRAY = (0.299, 0.587, 0.114)


def random_brightness(data, min_factor, max_factor):
    alpha = _uniform(min_factor, max_factor)
    return apply_op(lambda x: _clip_cast(x.float() * alpha, x.dtype), [data],
                    "random_brightness")


def _gray(xf):
    return (xf * torch.tensor(_GRAY, device=xf.device)).sum(-1, keepdim=True)


def random_contrast(data, min_factor, max_factor):
    alpha = _uniform(min_factor, max_factor)

    def g(x):
        xf = x.float()
        return _clip_cast(xf * alpha + _gray(xf).mean() * (1 - alpha),
                          x.dtype)
    return apply_op(g, [data], "random_contrast")


def random_saturation(data, min_factor, max_factor):
    alpha = _uniform(min_factor, max_factor)

    def g(x):
        xf = x.float()
        return _clip_cast(xf * alpha + _gray(xf) * (1 - alpha), x.dtype)
    return apply_op(g, [data], "random_saturation")


def random_hue(data, min_factor, max_factor):
    """Hue rotation through YIQ space (``image_random.cc`` RandomHue)."""
    alpha = _uniform(min_factor, max_factor)
    u, w = math.cos(alpha * math.pi), math.sin(alpha * math.pi)
    t_yiq = _onp.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.321],
                        [0.211, -0.523, 0.311]], "float32")
    t_rgb = _onp.array([[1.0, 0.956, 0.621], [1.0, -0.272, -0.647],
                        [1.0, -1.107, 1.705]], "float32")
    rot = _onp.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]], "float32")
    m = t_rgb @ rot @ t_yiq

    def g(x):
        mt = torch.from_numpy(_onp.ascontiguousarray(m.T)).to(x.device)
        return _clip_cast(x.float() @ mt, x.dtype)
    return apply_op(g, [data], "random_hue")


def random_color_jitter(data, brightness=0.0, contrast=0.0, saturation=0.0,
                        hue=0.0):
    """The asked-for color augmentations, in a random order."""
    ops = []
    if brightness > 0:
        ops.append(lambda d: random_brightness(d, 1 - brightness,
                                               1 + brightness))
    if contrast > 0:
        ops.append(lambda d: random_contrast(d, 1 - contrast, 1 + contrast))
    if saturation > 0:
        ops.append(lambda d: random_saturation(d, 1 - saturation,
                                               1 + saturation))
    if hue > 0:
        ops.append(lambda d: random_hue(d, -hue, hue))
    for i in torch.randperm(len(ops), generator=_gen()).tolist():
        data = ops[i](data)
    return data


_EIGVAL = _onp.array([55.46, 4.794, 1.148], "float32")
_EIGVEC = _onp.array([[-0.5675, 0.7192, 0.4009],
                      [-0.5808, -0.0045, -0.8140],
                      [-0.5836, -0.6948, 0.4203]], "float32")


def adjust_lighting(data, alpha):
    """AlexNet's PCA lighting with the given alpha per component."""
    a = _onp.asarray(alpha, "float32")
    rgb = (_EIGVEC * a * _EIGVAL).sum(axis=1)

    def g(x):
        return _clip_cast(x.float() + as_tensor(rgb, device=x.device),
                          x.dtype)
    return apply_op(g, [data], "adjust_lighting")


def random_lighting(data, alpha_std=0.05):
    alpha = (torch.randn(3, dtype=torch.float64, generator=_gen())
             * alpha_std).numpy()
    return adjust_lighting(data, alpha)
