"""Legacy image reading and augmentation (counterpart of
``mxnet_tpu/image/image.py``): ``imread`` / ``imdecode`` / ``imresize``,
the crops, the augmenters with ``CreateAugmenter``, the detection
augmenters with ``CreateDetAugmenter``, ``ImageIter`` and
``ImageDetIter``.

Decoding and geometry run on the host through cv2, as in the reference.
``imread`` / ``imdecode`` return HWC uint8 NDArrays on the current
context.  The other functions and the augmenters keep their input's
array world: a numpy image gives numpy (so a ``DataLoader`` worker may
run them with no torch operation), an NDArray an NDArray on its device;
the values are the reference's either way.  Random augmenters draw from
Python's ``random`` (``LightingAug`` from numpy's global state), as the
reference's do.  The iterators batch on the host and copy each batch to
the current context's device once.
"""
from __future__ import annotations

import os
import random as _pyrandom

import numpy as _onp
import torch

from .. import numpy as mnp
from ..ndarray.ndarray import NDArray

__all__ = ["imread", "imdecode", "imresize", "resize_short", "scale_down",
           "fixed_crop", "random_crop", "center_crop", "random_size_crop",
           "color_normalize", "Augmenter", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "RandomSizedCropAug", "CenterCropAug",
           "HorizontalFlipAug", "CastAug", "ColorNormalizeAug",
           "ColorJitterAug", "CreateAugmenter", "ImageIter",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "LightingAug", "RandomGrayAug", "RandomOrderAug",
           "SequentialAug", "DetAugmenter", "DetBorrowAug",
           "DetRandomSelectAug", "DetHorizontalFlipAug", "DetRandomCropAug",
           "DetRandomPadAug", "CreateDetAugmenter", "ImageDetIter"]


def _np(x):
    """The host numpy array of an NDArray, tensor or array."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return _onp.asarray(x)


def _out(arr, like):
    """numpy ``arr`` in ``like``'s array world: numpy for a numpy image,
    an NDArray on its device (dtype kept) for an NDArray."""
    if isinstance(like, NDArray):
        return NDArray(torch.from_numpy(_onp.ascontiguousarray(arr))
                       .to(like._data.device))
    return arr


def _const(value, like):
    """A mean / std / offset operand beside ``like``: float32 numpy (an
    NDArray as it is)."""
    if isinstance(value, NDArray):
        return value
    arr = _onp.asarray(value)
    if arr.dtype == _onp.float64:
        arr = arr.astype(_onp.float32)
    return _out(arr, like)


def _cv2():
    import cv2
    return cv2


def imread(filename, flag=1, to_rgb=True):
    cv2 = _cv2()
    img = cv2.imread(filename, cv2.IMREAD_COLOR if flag
                     else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError("cannot read image %s" % filename)
    if flag and to_rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = img[:, :, None]
    return mnp.array(img, dtype="uint8")


def imdecode(buf, flag=1, to_rgb=True):
    cv2 = _cv2()
    if isinstance(buf, NDArray):
        buf = buf.asnumpy()
    arr = _onp.frombuffer(bytes(buf) if not isinstance(buf, _onp.ndarray)
                          else buf, dtype=_onp.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR if flag
                       else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise ValueError("cannot decode image buffer")
    if flag and to_rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = img[:, :, None]
    return mnp.array(img, dtype="uint8")


def imresize(src, w, h, interp=1):
    """``src`` resized to (w, h) by cv2: bilinear for ``interp`` 1, else
    nearest (the reference's mapping)."""
    cv2 = _cv2()
    out = cv2.resize(_np(src), (w, h), interpolation=cv2.INTER_LINEAR
                     if interp == 1 else cv2.INTER_NEAREST)
    if out.ndim == 2:
        out = out[:, :, None]
    return _out(out, src)


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def scale_down(src_size, size):
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    import math
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _pyrandom.uniform(*area) * src_area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(_pyrandom.uniform(*log_ratio))
        new_w = int(round(math.sqrt(target_area * aspect)))
        new_h = int(round(math.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            x0 = _pyrandom.randint(0, w - new_w)
            y0 = _pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    """``(src - mean) / std`` in float32."""
    src = src.astype("float32")
    if mean is not None:
        src = src - _const(mean, src)
    if std is not None:
        src = src / _const(std, src)
    return src


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = (size, size) if isinstance(size, int) else size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size)
        self.size = (size, size) if isinstance(size, int) else size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = (size, size) if isinstance(size, int) else size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return mnp.flip(src, axis=1) if isinstance(src, NDArray) \
                else _onp.flip(src, axis=1)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class ColorJitterAug(Augmenter):
    def __init__(self, brightness=0, contrast=0, saturation=0):
        super().__init__()
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation

    def __call__(self, src):
        src = src.astype("float32")
        if self.brightness:
            alpha = 1.0 + _pyrandom.uniform(-self.brightness,
                                            self.brightness)
            src = src * alpha
        if self.contrast:
            alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
            gray = src.mean()
            src = (src - gray) * alpha + gray
        if self.saturation:
            alpha = 1.0 + _pyrandom.uniform(-self.saturation,
                                            self.saturation)
            gray = src.mean(axis=-1, keepdims=True)
            src = src * alpha + gray * (1 - alpha)
        return src.clip(0, 255)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, rand_gray=0,
                    inter_method=2):
    """The standard augmenter list (the reference's
    ``CreateAugmenter``)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Batches of images from a ``.rec`` file or a ``.lst`` with an image
    tree, through ``aug_list`` (default ``CreateAugmenter(data_shape)``),
    shuffled by Python's ``random``; the last batch wraps around to the
    start."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, aug_list=None, **kwargs):
        self.batch_size = batch_size
        self.data_shape = data_shape
        self._aug_list = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        self._items = []
        if path_imgrec is not None:
            from ..gluon.data.vision import ImageRecordDataset
            self._dataset = ImageRecordDataset(path_imgrec)
            self._items = list(range(len(self._dataset)))
            self._mode = "rec"
        elif path_imglist is not None:
            self._mode = "list"
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = float(parts[1])
                    fname = parts[-1]
                    self._items.append((os.path.join(path_root or "", fname),
                                        label))
        else:
            raise ValueError("path_imgrec or path_imglist required")
        self._shuffle = shuffle
        self._order = list(range(len(self._items)))
        self.reset()

    def reset(self):
        if self._shuffle:
            _pyrandom.shuffle(self._order)
        self._cursor = 0

    def _read(self, i):
        if self._mode == "rec":
            img, label = self._dataset[self._items[i]]
        else:
            fname, label = self._items[i]
            img = imread(fname)
        for aug in self._aug_list:
            img = aug(img)
        return img.transpose(2, 0, 1), label

    def next(self):
        from ..io import DataBatch
        if self._cursor >= len(self._order):
            raise StopIteration
        imgs, labels = [], []
        while len(imgs) < self.batch_size:
            idx = self._order[self._cursor % len(self._order)]
            self._cursor += 1
            img, label = self._read(idx)
            imgs.append(img)
            labels.append(label)
            if self._cursor >= len(self._order) and len(imgs) < \
                    self.batch_size:
                continue  # pad by wrapping
        data = mnp.stack(imgs) if isinstance(imgs[0], NDArray) else \
            mnp.array(_onp.stack(imgs))
        label = mnp.array(_onp.asarray(labels, dtype="float32"))
        return DataBatch(data=[data], label=[label], pad=0)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()


# -- the single-property jitters ---------------------------------------
class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__()
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return (src.astype("float32") * alpha).clip(0, 255)


_LUMA = _onp.array([0.299, 0.587, 0.114], "float32")  # ITU-R BT.601


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__()
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        arr = _np(src).astype("float32")
        # the pivot is the mean luma (BT.601), not the channel mean
        gray = float((arr * _LUMA).sum(axis=-1).mean())
        return _out(((arr - gray) * alpha + gray).clip(0, 255), src)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__()
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        arr = _np(src).astype("float32")
        gray = (arr * _LUMA).sum(axis=-1, keepdims=True)
        return _out((arr * alpha + gray * (1 - alpha)).clip(0, 255), src)


class HueJitterAug(Augmenter):
    """Hue rotation in YIQ space."""

    def __init__(self, hue):
        super().__init__()
        self.hue = hue
        self._t_yiq = _onp.array([[0.299, 0.587, 0.114],
                                  [0.596, -0.274, -0.321],
                                  [0.211, -0.523, 0.311]], "float32")
        self._t_rgb = _onp.linalg.inv(self._t_yiq).astype("float32")

    def __call__(self, src):
        alpha = _pyrandom.uniform(-self.hue, self.hue)
        theta = alpha * _onp.pi
        u, w = _onp.cos(theta), _onp.sin(theta)
        rot = _onp.array([[1, 0, 0], [0, u, -w], [0, w, u]], "float32")
        t = self._t_rgb @ rot @ self._t_yiq
        out = _np(src).astype("float32") @ t.T
        return _out(out.clip(0, 255), src)


class LightingAug(Augmenter):
    """AlexNet's PCA lighting noise, drawn from numpy's global state."""

    def __init__(self, alphastd, eigval=None, eigvec=None):
        super().__init__()
        self.alphastd = alphastd
        self.eigval = _onp.asarray(
            eigval if eigval is not None else [55.46, 4.794, 1.148],
            "float32")
        self.eigvec = _onp.asarray(
            eigvec if eigvec is not None else
            [[-0.5675, 0.7192, 0.4009],
             [-0.5808, -0.0045, -0.8140],
             [-0.5836, -0.6948, 0.4203]], "float32")

    def __call__(self, src):
        alpha = _onp.random.normal(0, self.alphastd, 3).astype("float32")
        rgb = (self.eigvec * alpha) @ self.eigval
        return (src.astype("float32") + _const(rgb, src)).clip(0, 255)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        super().__init__()
        self.p = p
        self._coef = _onp.array([0.299, 0.587, 0.114], "float32")

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            arr = _np(src)
            gray = (arr.astype("float32") * self._coef).sum(
                axis=-1, keepdims=True)
            src = _out(_onp.broadcast_to(gray, arr.shape).astype("float32"),
                       src)
        return src


class RandomOrderAug(Augmenter):
    """The child augmenters in a random order."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        order = list(range(len(self.ts)))
        _pyrandom.shuffle(order)
        for i in order:
            src = self.ts[i](src)
        return src


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


# -- detection augmenters (MXNet's image/detection.py) -------------------
class DetAugmenter:
    """Joint (image, label) augmenter; label rows are
    ``[cls, x0, y0, x1, y1, ...]`` with coordinates normalized to [0, 1]
    (MXNet's detection label layout)."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """One child augmenter chosen at random, or none with
    ``skip_prob``."""

    def __init__(self, aug_list, skip_prob=0.0):
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _pyrandom.random() >= self.skip_prob and self.aug_list:
            return _pyrandom.choice(self.aug_list)(src, label)
        return src, label


class DetHorizontalFlipAug(DetAugmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        if _pyrandom.random() < self.p:
            src = _out(_onp.ascontiguousarray(_np(src)[:, ::-1]), src)
            label = _onp.array(label, copy=True)
            x0 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x0
        return src, label


class DetRandomCropAug(DetAugmenter):
    """A random crop that keeps ``min_object_covered`` of some object
    (``area_range``, ``aspect_ratio_range``, ``max_attempts``)."""

    def __init__(self, min_object_covered=0.1, area_range=(0.05, 1.0),
                 aspect_ratio_range=(0.75, 1.33), max_attempts=50):
        self.min_object_covered = min_object_covered
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        label = _onp.asarray(label, "float32")
        for _ in range(self.max_attempts):
            area = _pyrandom.uniform(*self.area_range)
            ratio = _pyrandom.uniform(*self.aspect_ratio_range)
            w = min(1.0, (area * ratio) ** 0.5)
            h = min(1.0, (area / ratio) ** 0.5)
            x0 = _pyrandom.uniform(0, 1 - w)
            y0 = _pyrandom.uniform(0, 1 - h)
            x1, y1 = x0 + w, y0 + h
            ix0 = _onp.maximum(label[:, 1], x0)
            iy0 = _onp.maximum(label[:, 2], y0)
            ix1 = _onp.minimum(label[:, 3], x1)
            iy1 = _onp.minimum(label[:, 4], y1)
            inter = (_onp.clip(ix1 - ix0, 0, 1)
                     * _onp.clip(iy1 - iy0, 0, 1))
            box_area = ((label[:, 3] - label[:, 1])
                        * (label[:, 4] - label[:, 2]))
            cover = _onp.where(box_area > 0, inter / (box_area + 1e-12), 0)
            keep = cover >= self.min_object_covered
            if not keep.any():
                continue
            arr = _np(src)
            H, W = arr.shape[0], arr.shape[1]
            px0, py0 = int(x0 * W), int(y0 * H)
            px1, py1 = max(px0 + 1, int(x1 * W)), max(py0 + 1, int(y1 * H))
            crop = arr[py0:py1, px0:px1]
            new = label[keep].copy()
            new[:, 1] = _onp.clip((new[:, 1] - x0) / w, 0, 1)
            new[:, 2] = _onp.clip((new[:, 2] - y0) / h, 0, 1)
            new[:, 3] = _onp.clip((new[:, 3] - x0) / w, 0, 1)
            new[:, 4] = _onp.clip((new[:, 4] - y0) / h, 0, 1)
            return _out(_onp.ascontiguousarray(crop), src), new
        return src, label


class DetRandomPadAug(DetAugmenter):
    """A random expansion of the canvas, padded with ``pad_val``."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        label = _onp.asarray(label, "float32")
        arr = _np(src)
        H, W = arr.shape[0], arr.shape[1]
        for _ in range(self.max_attempts):
            area = _pyrandom.uniform(*self.area_range)
            ratio = _pyrandom.uniform(*self.aspect_ratio_range)
            nw = (area * ratio) ** 0.5
            nh = (area / ratio) ** 0.5
            if nw < 1 or nh < 1:
                continue
            NW, NH = int(nw * W), int(nh * H)
            ox = _pyrandom.randint(0, NW - W)
            oy = _pyrandom.randint(0, NH - H)
            canvas = _onp.empty((NH, NW) + arr.shape[2:], arr.dtype)
            canvas[...] = _onp.asarray(self.pad_val, arr.dtype)
            canvas[oy:oy + H, ox:ox + W] = arr
            new = label.copy()
            new[:, 1] = (new[:, 1] * W + ox) / NW
            new[:, 2] = (new[:, 2] * H + oy) / NH
            new[:, 3] = (new[:, 3] * W + ox) / NW
            new[:, 4] = (new[:, 4] * H + oy) / NH
            return _out(canvas, src), new
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       pad_val=(127, 127, 127)):
    """The standard detection augmenter list (MXNet's
    ``image/detection.py`` ``CreateDetAugmenter``)."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered,
                                (area_range[0], min(1.0, area_range[1])),
                                aspect_ratio_range, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (1.0, max(1.0, area_range[1])),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    auglist.append(DetBorrowAug(ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(CastAug()))
    color = []
    if brightness:
        color.append(BrightnessJitterAug(brightness))
    if contrast:
        color.append(ContrastJitterAug(contrast))
    if saturation:
        color.append(SaturationJitterAug(saturation))
    if color:
        auglist.append(DetBorrowAug(RandomOrderAug(color)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        auglist.append(DetBorrowAug(LightingAug(pca_noise)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is not None or std is not None:
        if mean is True or mean is None:
            mean = _onp.array([123.68, 116.28, 103.53])
        if std is True or std is None:
            std = _onp.array([58.395, 57.12, 57.375])
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter:
    """Detection batches (MXNet's ``image/detection.py`` ``ImageDetIter``):
    ``.rec`` records with packed detection labels
    ``[header_len, label_width, ...header, (cls x0 y0 x1 y1 ...)*N]`` ->
    (B, C, H, W) images + (B, max_objs, label_width) labels, -1-padded."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 shuffle=False, aug_list=None, coord_normalized=True,
                 **kwargs):
        from ..gluon.data.vision import ImageRecordDataset
        self.batch_size = batch_size
        self.data_shape = data_shape
        self._aug_list = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **kwargs)
        if path_imgrec is None:
            raise ValueError("path_imgrec required")
        self._dataset = ImageRecordDataset(path_imgrec)
        if len(self._dataset) == 0:
            raise ValueError(
                "ImageDetIter: record file %r contains no images"
                % path_imgrec)
        self._order = list(range(len(self._dataset)))
        self._shuffle = shuffle
        # False: the records' labels are pixel coordinates, converted at
        # read time to the normalized [0, 1] form of the Det* augmenters
        self._coord_normalized = coord_normalized
        self.reset()

    def reset(self):
        if self._shuffle:
            _pyrandom.shuffle(self._order)
        self._cursor = 0

    @staticmethod
    def _unpack(label):
        label = _onp.asarray(
            label.asnumpy() if hasattr(label, "asnumpy") else label,
            "float32").ravel()
        header_len = int(label[0])
        width = int(label[1])
        body = label[header_len:].reshape(-1, width)
        # recordio det rows are (cls, x0, y0, x1, y1, ...)
        return body

    def _read(self, i):
        img, label = self._dataset[i]
        label = self._unpack(label)
        if not self._coord_normalized:
            H, W = img.shape[0], img.shape[1]
            label = _onp.array(label, copy=True)
            label[:, (1, 3)] /= float(W)
            label[:, (2, 4)] /= float(H)
        for aug in self._aug_list:
            img, label = aug(img, label)
        return _np(img).transpose(2, 0, 1), _onp.asarray(label, "float32")

    def next(self):
        from ..io import DataBatch
        if self._cursor >= len(self._order):
            raise StopIteration
        imgs, labels = [], []
        pad = 0
        while len(imgs) < self.batch_size:
            if self._cursor >= len(self._order):
                pad += 1  # wrap-pad from the start; reported in batch.pad
            idx = self._order[self._cursor % len(self._order)]
            self._cursor += 1
            img, label = self._read(idx)
            imgs.append(img)
            labels.append(label)
        width = max(l.shape[1] for l in labels)
        max_obj = max(l.shape[0] for l in labels)
        # missing object rows are -1 (the ignore marker); the extra columns
        # of a real row of a narrower label are 0, so a real object never
        # looks like an ignore row
        out = _onp.full((len(labels), max_obj, width), -1.0, "float32")
        for r, l in enumerate(labels):
            out[r, :l.shape[0], :l.shape[1]] = l
            out[r, :l.shape[0], l.shape[1]:] = 0.0
        data = mnp.array(_onp.stack(imgs))
        return DataBatch(data=[data], label=[mnp.array(out)], pad=pad)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()
