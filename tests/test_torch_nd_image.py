"""``mx.nd.image`` of the port against the JAX package's, on the same
numpy images (the port under ``with mx.cpu():``).

Tolerances: crops, flips and ``to_tensor`` exactly; ``normalize`` and
the color ops in float32 at rtol 1e-5 / atol 1e-6 (of 1, the range of
``to_tensor``'s output); ``resize`` -- the reference's
``jax.image.resize``, which samples at half-pixel centres and
antialiases when it shrinks -- within 1e-5 of max|x| in float32 and
one step in uint8 (the cast back truncates, and a value a rounding away
from an integer may land on either side).  The random ops draw from the
port's generator and cannot match the reference's draws: they are held
to their properties, and a seed reproduces them.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

rng = onp.random.RandomState(0)
U8 = rng.randint(0, 256, (2, 12, 16, 3)).astype(onp.uint8)
F32 = (rng.rand(2, 12, 16, 3) * 255).astype(onp.float32)
HWC = U8[0]
CHW = rng.rand(3, 6, 5).astype(onp.float32)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _both(fn):
    with jmx.cpu():
        want = fn(jmx.nd)
    with tmx.cpu():
        got = fn(tmx.nd)
    return got, want


def _arr(nd, x):
    return nd.array(x, dtype=x.dtype)


EXACT = {
    "crop_hwc": lambda nd: nd.image.crop(_arr(nd, HWC), 2, 3, 5, 4),
    "crop_nhwc": lambda nd: nd.image.crop(_arr(nd, U8), 0, 1, 16, 7),
    "flip_left_right": lambda nd: nd.image.flip_left_right(_arr(nd, U8)),
    "flip_top_bottom": lambda nd: nd.image.flip_top_bottom(_arr(nd, HWC)),
    "to_tensor_hwc": lambda nd: nd.image.to_tensor(_arr(nd, HWC)),
    "to_tensor_nhwc": lambda nd: nd.image.to_tensor(_arr(nd, U8)),
}


@pytest.mark.parametrize("case", sorted(EXACT))
def test_exact_ops(case):
    got, want = _both(EXACT[case])
    assert got.dtype == want.dtype and got.shape == want.shape
    onp.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


CLOSE = {
    "normalize": lambda nd: nd.image.normalize(_arr(nd, CHW), MEAN, STD),
    "normalize_batch": lambda nd: nd.image.normalize(
        nd.image.to_tensor(_arr(nd, U8)), MEAN, STD),
    "normalize_scalar": lambda nd: nd.image.normalize(_arr(nd, CHW), 0.5,
                                                      0.25),
    "adjust_lighting_u8": lambda nd: nd.image.adjust_lighting(
        _arr(nd, U8), [0.1, -0.2, 0.05]),
    "adjust_lighting_f32": lambda nd: nd.image.adjust_lighting(
        _arr(nd, F32), [0.3, 0.0, -0.1]),
}


@pytest.mark.parametrize("case", sorted(CLOSE))
def test_float_ops(case):
    got, want = _both(CLOSE[case])
    assert got.dtype == want.dtype and got.shape == want.shape
    onp.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-5,
                                atol=1e-6 * max(1.0, float(
                                    onp.abs(want.asnumpy()).max())))


RESIZES = [("short_up", 20, True, 1), ("short_down", 8, True, 1),
           ("square", 10, False, 1), ("wh", (24, 6), False, 1),
           ("wh_mixed", (9, 20), False, 1), ("nearest", 7, False, 0),
           ("nearest_up", (33, 25), False, 0), ("same", (16, 12), False, 1)]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("name,size,keep,interp", RESIZES,
                         ids=[r[0] for r in RESIZES])
def test_resize_matches_jax_image_resize(name, size, keep, interp, dtype):
    x = F32 if dtype == "float32" else U8
    got, want = _both(lambda nd: nd.image.resize(_arr(nd, x), size,
                                                 keep_ratio=keep,
                                                 interp=interp))
    g, w = got.asnumpy(), want.asnumpy()
    assert g.shape == w.shape and g.dtype == w.dtype
    if dtype == "uint8":
        assert onp.abs(g.astype(int) - w.astype(int)).max() <= 1
    else:
        onp.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * 255)
    g3, w3 = _both(lambda nd: nd.image.resize(_arr(nd, x[0]), size,
                                              keep_ratio=keep,
                                              interp=interp))
    assert g3.shape == w3.shape


RANDOM = {
    "random_crop": lambda nd: nd.image.random_crop(_arr(nd, HWC), 6, 5),
    "random_crop_upsized": lambda nd: nd.image.random_crop(_arr(nd, HWC),
                                                           20, 14),
    "random_resized_crop": lambda nd: nd.image.random_resized_crop(
        _arr(nd, F32[0]), 8, 6),
    "random_flip_left_right": lambda nd: nd.image.random_flip_left_right(
        _arr(nd, U8)),
    "random_flip_top_bottom": lambda nd: nd.image.random_flip_top_bottom(
        _arr(nd, U8)),
    "random_brightness": lambda nd: nd.image.random_brightness(
        _arr(nd, U8), 0.5, 1.5),
    "random_contrast": lambda nd: nd.image.random_contrast(_arr(nd, U8),
                                                           0.5, 1.5),
    "random_saturation": lambda nd: nd.image.random_saturation(
        _arr(nd, F32), 0.5, 1.5),
    "random_hue": lambda nd: nd.image.random_hue(_arr(nd, U8), -0.3, 0.3),
    "random_color_jitter": lambda nd: nd.image.random_color_jitter(
        _arr(nd, U8), 0.2, 0.2, 0.2, 0.1),
    "random_lighting": lambda nd: nd.image.random_lighting(_arr(nd, U8),
                                                           0.1),
}


@pytest.mark.parametrize("case", sorted(RANDOM))
def test_random_ops_properties(case):
    got, want = _both(RANDOM[case])
    assert got.shape == want.shape and got.dtype == want.dtype
    g = got.asnumpy()
    if g.dtype == onp.uint8:
        assert g.min() >= 0 and g.max() <= 255
    with tmx.cpu():
        tmx.np.random.seed(3)
        a = RANDOM[case](tmx.nd).asnumpy()
        tmx.np.random.seed(3)
        b = RANDOM[case](tmx.nd).asnumpy()
    onp.testing.assert_array_equal(a, b)


def test_random_flip_flips_or_not():
    with tmx.cpu():
        tmx.np.random.seed(0)
        outs = [tmx.nd.image.random_flip_left_right(
            tmx.nd.array(HWC, dtype="uint8")).asnumpy() for _ in range(20)]
    flipped = sum(onp.array_equal(o, HWC[:, ::-1]) for o in outs)
    kept = sum(onp.array_equal(o, HWC) for o in outs)
    assert flipped + kept == 20 and 0 < flipped < 20


def test_brightness_factor_range():
    with tmx.cpu():
        out = tmx.nd.image.random_brightness(tmx.nd.array(F32), 0.5,
                                             0.5).asnumpy()
    onp.testing.assert_allclose(out, F32 * 0.5, rtol=1e-6)
