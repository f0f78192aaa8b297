"""``mx.io`` and ``mx.image`` of the port against the JAX package on the
same files and seeds: ``ImageRecordIter`` (0 and 2 workers),
``NDArrayIter`` under each last-batch handling, ``CSVIter``,
``ResizeIter``, ``PrefetchingIter``, ``LibSVMIter`` (CSR batches).  ``mx.image``: decode, resize and crops, every augmenter
(the random ones seeded), ``CreateAugmenter`` / ``CreateDetAugmenter``
lists, ``ImageIter`` and ``ImageDetIter``.
"""
import random

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu import image as jimage
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import io as tio

cv2 = pytest.importorskip("cv2")


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _same(got, want, tol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if tol:
        onp.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        onp.testing.assert_array_equal(got, want)


def _batches(it, n=None):
    out = []
    for b in it:
        out.append(([_np(d) for d in b.data],
                    [_np(v) for v in (b.label or [])], b.pad))
        if n is not None and len(out) == n:
            break
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp and len(gd) == len(wd) and len(gl) == len(wl)
        for a, b in zip(gd + gl, wd + wl):
            _same(a, b)


def _rec(tmp_path, n=10, det=False, seed=0):
    path = str(tmp_path / ("det" if det else "img"))
    rec = jrec.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    rng = onp.random.RandomState(seed)
    for i in range(n):
        img = rng.randint(0, 256, (int(rng.randint(24, 40)),
                                   int(rng.randint(24, 40)), 3)).astype(
            "uint8")
        if det:
            k = int(rng.randint(1, 4))
            x0 = rng.uniform(0, 0.5, k)
            y0 = rng.uniform(0, 0.5, k)
            boxes = onp.stack([rng.randint(0, 3, k), x0, y0,
                               x0 + rng.uniform(0.1, 0.5, k),
                               y0 + rng.uniform(0.1, 0.5, k)], 1)
            label = onp.concatenate([[2, 5], boxes.ravel()]).astype(
                "float32")
        else:
            label = float(i % 4)
        rec.write_idx(i, jrec.pack_img((0, label, i, 0), img, quality=90))
    rec.close()
    return path + ".rec"


@pytest.mark.parametrize("workers", [0, 2])
def test_image_record_iter_matches(tmp_path, workers):
    rec = _rec(tmp_path)
    kw = dict(path_imgrec=rec, data_shape=(3, 20, 18), batch_size=4,
              resize=22, mean_r=120.0, mean_g=110.0, mean_b=100.0,
              std_r=60.0, std_g=55.0, std_b=50.0)
    with mx.cpu():
        jit = jio.ImageRecordIter(preprocess_threads=0, **kw)
        want = _batches(jit) + _batches(jit)
    with mt.cpu():
        tit = tio.ImageRecordIter(preprocess_threads=workers,
                                  prefetch_buffer=2, **kw)
        got = _batches(tit) + _batches(tit)
        tit._loader.close()
    _same_batches(got, want)
    assert got[0][0][0].shape == (4, 3, 20, 18)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches(handle, shuffle):
    rng = onp.random.RandomState(1)
    data = {"a": rng.normal(0, 1, (10, 3)).astype("float32"),
            "b": rng.randint(0, 9, (10, 2)).astype("int32")}
    label = rng.randint(0, 3, 10).astype("float32")

    def run(io, np_seed):
        onp.random.seed(np_seed)
        it = io.NDArrayIter(data, label, batch_size=4, shuffle=shuffle,
                            last_batch_handle=handle)
        out = _batches(it)
        it.reset()
        out += _batches(it)
        return out, [(d.name, d.shape) for d in it.provide_data]
    with mx.cpu():
        want, wdesc = run(jio, 3)
    with mt.cpu():
        got, gdesc = run(tio, 3)
    _same_batches(got, want)
    assert gdesc == wdesc


def test_csv_resize_and_prefetching_iters_match(tmp_path):
    rng = onp.random.RandomState(2)
    onp.savetxt(tmp_path / "d.csv", rng.normal(0, 1, (7, 6)),
                delimiter=",")
    onp.savetxt(tmp_path / "l.csv", rng.randint(0, 3, 7), delimiter=",")

    def run(io):
        csv = io.CSVIter(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
                         label_csv=str(tmp_path / "l.csv"), batch_size=3)
        out = _batches(csv)
        out += _batches(io.ResizeIter(csv, 5))
        out += _batches(io.PrefetchingIter(io.NDArrayIter(
            onp.arange(12, dtype="float32").reshape(6, 2), batch_size=4)))
        return out
    with mx.cpu():
        want = run(jio)
    with mt.cpu():
        got = run(tio)
    _same_batches(got, want)


def test_libsvm_iter_refuses(tmp_path):
    # ported with sparse arrays: the reference's CSR batches
    (tmp_path / "x.libsvm").write_text("1 0:1.5 3:2\n0 1:1\n")
    with mx.cpu():
        want = jio.LibSVMIter(str(tmp_path / "x.libsvm"), (4,)).next()
    with mt.cpu():
        got = tio.LibSVMIter(str(tmp_path / "x.libsvm"), (4,)).next()
    assert got.data[0].stype == want.data[0].stype == "csr"
    onp.testing.assert_array_equal(got.data[0].asnumpy(),
                                   want.data[0].asnumpy())
    onp.testing.assert_array_equal(got.label[0].asnumpy(),
                                   want.label[0].asnumpy())


# ----------------------------------------------------------------------
# mx.image
# ----------------------------------------------------------------------
def _img(seed=0, h=30, w=40):
    return onp.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        "uint8")


def test_decode_read_and_resize_match(tmp_path):
    img = _img()
    ok, buf = cv2.imencode(".png", img)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    for flag in (0, 1):
        with mx.cpu():
            want = [jimage.imdecode(buf.tobytes(), flag),
                    jimage.imread(str(tmp_path / "a.png"), flag)]
        with mt.cpu():
            got = [timage.imdecode(buf.tobytes(), flag),
                   timage.imread(str(tmp_path / "a.png"), flag)]
        for g, w in zip(got, want):
            assert isinstance(g, mt.nd.NDArray)
            _same(g, w)
    for interp in (1, 2):
        with mx.cpu():
            want = [jimage.imresize(img, 17, 11, interp),
                    jimage.resize_short(img, 16, interp)]
        got = [timage.imresize(img, 17, 11, interp),
               timage.resize_short(img, 16, interp)]
        for g, w in zip(got, want):
            _same(g, w)
    assert timage.scale_down((40, 30), (50, 20)) == \
        jimage.scale_down((40, 30), (50, 20))


@pytest.mark.parametrize("fn", ["fixed_crop", "center_crop", "random_crop",
                                "random_size_crop", "color_normalize"])
def test_crops_and_normalize_match(fn):
    img = _img(1)

    def run(image):
        random.seed(3)
        if fn == "fixed_crop":
            return [image.fixed_crop(img, 3, 4, 20, 15, (10, 8))]
        if fn == "center_crop":
            return list(image.center_crop(img, (16, 12))[:1]) + \
                [image.center_crop(img, (50, 12))[1]]
        if fn == "random_crop":
            return [image.random_crop(img, (16, 12))[0] for _ in range(3)]
        if fn == "random_size_crop":
            return [image.random_size_crop(img, (10, 10), (0.1, 0.8),
                                           (0.7, 1.4))[0] for _ in range(3)]
        return [image.color_normalize(img, [120.0, 110, 100],
                                      [60.0, 50, 40])]
    with mx.cpu():
        want = run(jimage)
    got = run(timage)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g == w
        else:
            _same(g, w, 1e-6 if fn == "color_normalize" else 0.0)


_AUGS = {
    "ResizeAug": lambda I: I.ResizeAug(18),
    "ForceResizeAug": lambda I: I.ForceResizeAug((14, 9)),
    "RandomCropAug": lambda I: I.RandomCropAug((15, 11)),
    "RandomSizedCropAug": lambda I: I.RandomSizedCropAug(12, (0.2, 0.9),
                                                         (0.75, 1.33)),
    "CenterCropAug": lambda I: I.CenterCropAug(14),
    "HorizontalFlipAug": lambda I: I.HorizontalFlipAug(0.5),
    "CastAug": lambda I: I.CastAug(),
    "ColorNormalizeAug": lambda I: I.ColorNormalizeAug([100.0, 110, 120],
                                                       [50.0, 60, 70]),
    "ColorJitterAug": lambda I: I.ColorJitterAug(0.3, 0.3, 0.3),
    "BrightnessJitterAug": lambda I: I.BrightnessJitterAug(0.4),
    "ContrastJitterAug": lambda I: I.ContrastJitterAug(0.4),
    "SaturationJitterAug": lambda I: I.SaturationJitterAug(0.4),
    "HueJitterAug": lambda I: I.HueJitterAug(0.3),
    "LightingAug": lambda I: I.LightingAug(0.5),
    "RandomGrayAug": lambda I: I.RandomGrayAug(0.5),
    "RandomOrderAug": lambda I: I.RandomOrderAug(
        [I.BrightnessJitterAug(0.2), I.ContrastJitterAug(0.2)]),
    "SequentialAug": lambda I: I.SequentialAug([I.CastAug(),
                                                I.HorizontalFlipAug(1.0)]),
}


@pytest.mark.parametrize("name", sorted(_AUGS))
def test_augmenters_match(name):
    img = _img(2)

    def run(image):
        random.seed(5)
        onp.random.seed(5)
        aug = _AUGS[name](image)
        return [_np(aug(img)) for _ in range(4)]
    with mx.cpu():
        want = run(jimage)
    got = run(timage)
    for g, w in zip(got, want):
        _same(g, w.astype(g.dtype) if g.dtype != w.dtype and
              name == "CastAug" else w, 1e-6)


def test_create_augmenter_lists_match():
    img = _img(3)
    for kw in ({}, {"resize": 20, "rand_crop": True, "rand_mirror": True,
                    "mean": onp.array([1.0, 2, 3]), "std": onp.array(
                        [2.0, 2, 2]), "brightness": 0.2},
               {"rand_resize": True}):
        shape = (3, 12, 14)

        def run(image):
            random.seed(8)
            out = img
            for aug in image.CreateAugmenter(shape, **kw):
                out = aug(out)
            return _np(out)
        with mx.cpu():
            want = run(jimage)
        _same(run(timage), want, 1e-5)


def _det_label(seed, k=3):
    rng = onp.random.RandomState(seed)
    x0, y0 = rng.uniform(0, 0.5, k), rng.uniform(0, 0.5, k)
    return onp.stack([rng.randint(0, 3, k), x0, y0, x0 + 0.3,
                      y0 + 0.4], 1).astype("float32")


@pytest.mark.parametrize("name", ["flip", "crop", "pad", "select", "borrow",
                                  "create"])
def test_det_augmenters_match(name):
    img, label = _img(4), _det_label(4)

    def make(I):
        return {"flip": lambda: [I.DetHorizontalFlipAug(1.0)],
                "crop": lambda: [I.DetRandomCropAug(0.3)],
                "pad": lambda: [I.DetRandomPadAug()],
                "select": lambda: [I.DetRandomSelectAug(
                    [I.DetRandomCropAug(), I.DetHorizontalFlipAug(1.0)],
                    0.3)],
                "borrow": lambda: [I.DetBorrowAug(I.CastAug())],
                "create": lambda: I.CreateDetAugmenter(
                    (3, 16, 16), rand_crop=0.5, rand_pad=0.5,
                    rand_mirror=True, brightness=0.2, hue=0.1,
                    mean=True, std=True)}[name]()

    def run(image):
        random.seed(9)
        onp.random.seed(9)
        augs = make(image)
        out = []
        for _ in range(3):
            a, b = img, label
            for aug in augs:
                a, b = aug(a, b)
            out.append((_np(a), onp.asarray(b)))
        return out
    with mx.cpu():
        want = run(jimage)
    got = run(timage)
    for (ga, gb), (wa, wb) in zip(got, want):
        _same(ga, wa, 1e-5)
        _same(gb, wb, 1e-6)


def test_image_iter_and_image_det_iter_match(tmp_path):
    rec = _rec(tmp_path, n=6)
    drec = _rec(tmp_path, n=5, det=True, seed=1)

    def run(image):
        random.seed(2)
        it = image.ImageIter(4, (3, 16, 16), path_imgrec=rec, shuffle=True)
        out = _batches(it)
        det = image.ImageDetIter(2, (3, 16, 16), path_imgrec=drec,
                                 rand_mirror=True)
        return out + _batches(det)
    with mx.cpu():
        want = run(jimage)
    with mt.cpu():
        got = run(timage)
    _same_batches(got, want)
