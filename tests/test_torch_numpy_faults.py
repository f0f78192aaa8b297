"""``mx.np`` of the port against the JAX package's at the faults F8-F11
(ROADMAP section 3): the inputs where the port raised, binned, typed or
accepted differently from the reference.

Each case runs the same numpy inputs through ``mxnet_tpu.np`` and, under
``with mx.cpu():``, through ``mxnet_tpu_torch.np``: a computed case must
give the reference's values (exactly for integers and bools, float32
rounding otherwise: rtol 1e-6) and its dtype; a refused one must raise
``ValueError`` in both.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

A = onp.array([[1.5, -2.25], [0.5, 3.0]], onp.float32)
I = onp.array([[1, -2, 3], [0, 5, -7]], onp.int32)
B = onp.array([[True, False, True], [False, False, True]])
R = onp.arange(12, dtype=onp.float32).reshape(3, 4)
X = onp.array([0.5, 1.0, 2.5, 3.0, 4.0, 4.5], onp.float32)

#: F8 (the reference computes), F9 (decreasing bins), F10 (dtypes)
COMPUTED = {
    "imag_real": lambda np: np.imag(np.array(A)),
    "imag_int": lambda np: np.imag(np.array(I)),
    "abs_bool": lambda np: np.abs(np.array(B)),
    "absolute_bool": lambda np: np.absolute(np.array(B)),
    "positive_bool": lambda np: np.positive(np.array(B)),
    "argmax_bool": lambda np: np.argmax(np.array(B)),
    "argmax_bool_axis1": lambda np: np.argmax(np.array(B), axis=1),
    "argmin_bool": lambda np: np.argmin(np.array(B)),
    "argmin_bool_axis1": lambda np: np.argmin(np.array(B), axis=1),
    "nanmax_int": lambda np: np.nanmax(np.array(I)),
    "nanmax_int_axis0": lambda np: np.nanmax(np.array(I), axis=0),
    "nanmin_int": lambda np: np.nanmin(np.array(I)),
    "nanmin_int_axis0": lambda np: np.nanmin(np.array(I), axis=0),
    "nanmax_float_nan": lambda np: np.nanmax(
        np.array(onp.array([[1.0, onp.nan], [-3.0, 2.0]], onp.float32)),
        axis=1),
    "allclose_scalar": lambda np: np.allclose(np.array(A), 2.0),
    "allclose_scalar_true": lambda np: np.allclose(np.ones((2, 3)), 1.0),
    "gradient_scalar_2d": lambda np: np.gradient(np.array(R * R), 2.0),
    "gradient_ones_2d": lambda np: np.gradient(np.ones((3, 4)), 2.0),
    "gradient_scalar_1d": lambda np: np.gradient(np.array(X), 0.5),
    "mod_int_by_zero": lambda np: np.mod(
        np.array(I), np.array(onp.array([[0, 3, 0], [2, 0, -4]], onp.int32))),
    "remainder_int_by_zero": lambda np: np.remainder(
        np.array(I), np.array(onp.zeros_like(I))),
    "roll_tuple_flat": lambda np: np.roll(np.array(R), (1, 2)),
    "roll_tuple_axes": lambda np: np.roll(np.array(R), (1, 2), axis=(0, 1)),
    "bfloat16_scalar": lambda np: np.bfloat16(1.5),
    "digitize_decreasing": lambda np: np.digitize(
        np.array([0.5, 2.5, 4.5]), np.array([4.0, 3.0, 1.0])),
    "digitize_decreasing_ties": lambda np: np.digitize(
        np.array(X), np.array([4.0, 3.0, 1.0])),
    "digitize_decreasing_right": lambda np: np.digitize(
        np.array(X), np.array([4.0, 3.0, 1.0]), right=True),
    "digitize_increasing_ties": lambda np: np.digitize(
        np.array(X), np.array([1.0, 3.0, 4.0])),
    "digitize_increasing_right": lambda np: np.digitize(
        np.array(X), np.array([1.0, 3.0, 4.0]), right=True),
    **{"%s_%s" % (name, kind): (lambda np, name=name, v=v: getattr(
        np, name)(np.array(v)))
       for name in ("floor", "ceil", "trunc", "fix", "nan_to_num")
       for kind, v in (("int", I), ("bool", B))},
    "trace_int": lambda np: np.trace(np.array(I)),
    "square_bool": lambda np: np.square(np.array(B)),
    "shape_array": lambda np: jmx.npx.shape_array(np.array(R))
    if np is jmx.np else tmx.npx.shape_array(np.array(R)),
    "prod_negative_axis": lambda np: np.prod(
        np.arange(1, 13).reshape(3, 4), axis=(-1,)),
    "squeeze_size_one": lambda np: np.squeeze(np.ones((3, 1)), axis=1),
    "rollaxis_in_range": lambda np: np.rollaxis(np.array(R), 1),
    "rollaxis_start_ndim": lambda np: np.rollaxis(np.ones((3, 4, 5)), 0, 3),
}

#: F11: the reference raises ValueError
REFUSED = {
    "prod_axes_out_of_range": lambda np: np.prod(
        np.arange(1, 13).reshape(3, 4), axis=(4, 3)),
    "prod_axis_2": lambda np: np.prod(np.arange(1, 13).reshape(3, 4),
                                      axis=2),
    "nanprod_axes_out_of_range": lambda np: np.nanprod(
        np.arange(1, 13).reshape(3, 4), axis=(4, 3)),
    "squeeze_size_four": lambda np: np.squeeze(np.ones((3, 4)), axis=1),
    "rollaxis_axis_2_of_2d": lambda np: np.rollaxis(np.ones((3, 4)), 2),
    "rollaxis_start_past_ndim": lambda np: np.rollaxis(np.ones((3, 4, 5)),
                                                       0, 4),
    "resize_negative": lambda np: np.resize(np.ones((3, 4)), -1),
    "split_negative": lambda np: np.split(np.ones(4), -1),
    "select_three_conditions_two_choices": lambda np: np.select(
        [np.array(B)] * 3, [np.ones((2, 3))] * 2),
}


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    if hasattr(x, "dtype") and _dtype_name(x) == "bfloat16":
        # numpy has no bfloat16: the name, and the values in float32
        return ("bfloat16", x.astype("float32").asnumpy()
                if hasattr(x, "asnumpy")
                else onp.asarray(x).astype(onp.float32))
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _same(got, want):
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, tuple):                  # a bfloat16 result
        assert isinstance(got, tuple) and got[0] == want[0]
        got, want = got[1], want[1]
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        onp.testing.assert_array_equal(got, want)
    else:
        onp.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", sorted(COMPUTED))
def test_port_computes_what_the_reference_computes(name):
    fn = COMPUTED[name]
    want = _host(fn(jmx.np))
    with tmx.cpu():
        got = _host(fn(tmx.np))
    _same(got, want)


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_port_refuses_what_the_reference_refuses(name):
    fn = REFUSED[name]
    with pytest.raises(ValueError):
        fn(jmx.np)
    with tmx.cpu(), pytest.raises(ValueError):
        fn(tmx.np)


def test_bfloat16_is_a_dtype_and_a_scalar_type():
    with tmx.cpu():
        z = tmx.np.zeros((2, 3), dtype=tmx.np.bfloat16)
        s = tmx.np.bfloat16(1.5)
        assert z.dtype == tmx.np.bfloat16 and s.dtype == tmx.np.bfloat16
        assert s.shape == () and float(s) == 1.5
        assert tmx.np.ones(2).astype(tmx.np.bfloat16).dtype == \
            tmx.np.bfloat16
