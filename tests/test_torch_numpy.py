"""``mx.np`` of the port against the JAX package's.

The same seeded numpy inputs go through ``mxnet_tpu.np`` and, under
``with mx.cpu():``, through ``mxnet_tpu_torch.np``; each function is a
case of a few parametrised tests.  Both packages run float32 (64-bit
types off), so results agree to float32 rounding: rtol 1e-5, atol 1e-6
(1e-4 / 1e-5 where a function sums many terms in another order:
reductions of 60 values, products, linear algebra); integer and bool
results exactly; dtypes equal.  ``mx.np.random`` draws differ between
torch generators and JAX keys, so its tests hold the port to seed
reproducibility, shapes, dtypes and moments.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5


def _rand(seed, *shape, lo=-1.0, hi=1.0):
    return onp.random.RandomState(seed).uniform(lo, hi, shape).astype(
        onp.float32)


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _both(fn, *arrays):
    """(port result, JAX result) of ``fn(np, *arrays)`` as numpy."""
    with tmx.cpu():
        got = _host(fn(tmx.np, *[tmx.np.array(a) for a in arrays]))
    want = _host(fn(jmx.np, *[jmx.np.array(a) for a in arrays]))
    return got, want


def _close(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    got, want = onp.asarray(got), onp.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        onp.testing.assert_array_equal(got, want)
    else:
        onp.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


A = _rand(0, 3, 4)
P = _rand(1, 3, 4, lo=0.1, hi=0.9)          # inside every unary domain
B = _rand(2, 3, 4)
I = onp.random.RandomState(3).randint(1, 9, (3, 4)).astype(onp.int32)

UNARY = ["negative", "positive", "absolute", "abs", "fabs", "sign", "rint",
         "ceil", "floor", "trunc", "fix", "sqrt", "cbrt", "square",
         "reciprocal", "exp", "expm1", "exp2", "log", "log2", "log10",
         "log1p", "sin", "cos", "tan", "arcsin", "arccos", "arctan", "sinh",
         "cosh", "tanh", "arcsinh", "arctanh", "degrees", "radians",
         "deg2rad", "rad2deg", "isnan", "isinf", "isfinite", "isposinf",
         "isneginf", "logical_not", "sinc", "nan_to_num"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_matches_jax(name):
    _close(*_both(lambda np, x: getattr(np, name)(x), P))


def test_unary_integer_and_domain_edges():
    _close(*_both(lambda np, x: np.arccosh(x + 1.5), P))
    for name in ("invert", "bitwise_not", "negative", "square", "abs"):
        _close(*_both(lambda np, x: getattr(np, name)(x), I))
    _close(*_both(lambda np, x: np.sqrt(x), I))        # int -> float32


BINARY = ["add", "subtract", "multiply", "divide", "true_divide",
          "floor_divide", "mod", "remainder", "fmod", "power", "arctan2",
          "hypot", "maximum", "minimum", "fmax", "fmin", "copysign",
          "logaddexp", "logaddexp2", "heaviside", "equal", "not_equal",
          "less", "less_equal", "greater", "greater_equal", "logical_and",
          "logical_or", "logical_xor"]


@pytest.mark.parametrize("name", BINARY)
def test_binary_matches_jax(name):
    _close(*_both(lambda np, x, y: getattr(np, name)(x, y + 1.5), P, B))


@pytest.mark.parametrize("name", ["add", "multiply", "floor_divide", "mod",
                                  "bitwise_and", "bitwise_or", "bitwise_xor",
                                  "left_shift", "right_shift", "gcd", "lcm",
                                  "maximum", "power", "true_divide"])
def test_binary_integer_matches_jax(name):
    _close(*_both(lambda np, x, y: getattr(np, name)(x, y % 3 + 1), I, I))


def test_binary_scalar_promotion_matches_jax():
    for fn in (lambda np, x: np.add(x, 2), lambda np, x: np.multiply(3.5, x),
               lambda np, x: x * 2.5, lambda np, x: 1 - x,
               lambda np, x: x / 2, lambda np, x: 2 ** x):
        _close(*_both(fn, I))
        _close(*_both(fn, A))


REDUCE = [("sum", {}), ("sum", {"axis": 1}), ("sum", {"axis": (0, 1),
                                                     "keepdims": True}),
          ("prod", {"axis": 0}), ("mean", {}), ("mean", {"axis": -1}),
          ("std", {"axis": 0}), ("var", {"axis": 1, "ddof": 1}),
          ("max", {"axis": 1}), ("min", {}), ("amax", {"axis": 0}),
          ("amin", {"axis": 1, "keepdims": True}), ("all", {"axis": 1}),
          ("any", {}), ("median", {"axis": 1}), ("ptp", {"axis": 0}),
          ("cumsum", {"axis": 1}), ("cumprod", {"axis": 0}),
          ("cumsum", {}), ("argmax", {"axis": 1}), ("argmin", {}),
          ("count_nonzero", {"axis": 0}), ("nansum", {"axis": 1}),
          ("nanmean", {"axis": 0}), ("nanmax", {}), ("nanstd", {"axis": 1}),
          ("nanvar", {}), ("nanprod", {"axis": 1}), ("nanmin", {"axis": 0})]


# F7 (ROADMAP section 3): numpy's initial= on the reductions that take it
REDUCE += [("sum", {"initial": 5.0}), ("max", {"axis": 1, "initial": 20.0}),
           ("min", {"axis": 0, "initial": -3.0}), ("prod", {"initial": 2.0}),
           ("amax", {"initial": 0.5, "keepdims": True}),
           ("nansum", {"axis": 1, "initial": 1.5})]


@pytest.mark.parametrize("name,kw", REDUCE,
                         ids=["%s%s" % (n, sorted(k.items()))
                              for n, k in REDUCE])
def test_reduction_matches_jax(name, kw):
    x = _rand(5, 4, 5, 3)[..., 0] * 2
    x[1, 2] = onp.nan if name.startswith("nan") else x[1, 2]
    _close(*_both(lambda np, a: getattr(np, name)(a, **kw), x), SUM_RTOL,
           SUM_ATOL)


def test_integer_reductions_keep_int32():
    for name in ("sum", "cumsum", "max", "prod"):
        _close(*_both(lambda np, a: getattr(np, name)(a, axis=0), I))


X3 = _rand(6, 2, 3, 4)
SHAPE = {
    "reshape": lambda np, a: np.reshape(a, (4, 6)),
    "ravel": lambda np, a: np.ravel(a),
    "transpose": lambda np, a: np.transpose(a, (2, 0, 1)),
    "transpose_default": lambda np, a: np.transpose(a),
    "swapaxes": lambda np, a: np.swapaxes(a, 0, 2),
    "moveaxis": lambda np, a: np.moveaxis(a, 0, -1),
    "rollaxis": lambda np, a: np.rollaxis(a, 2, 0),
    "expand_dims": lambda np, a: np.expand_dims(a, 1),
    "squeeze": lambda np, a: np.squeeze(np.expand_dims(a, 0), 0),
    "broadcast_to": lambda np, a: np.broadcast_to(a[:1], (5, 3, 4)),
    "concatenate": lambda np, a: np.concatenate([a, a], axis=1),
    "concatenate_none": lambda np, a: np.concatenate([a, a], axis=None),
    "stack": lambda np, a: np.stack([a, a], axis=-1),
    "vstack": lambda np, a: np.vstack([a[0], a[1]]),
    "hstack": lambda np, a: np.hstack([a[0], a[1]]),
    "dstack": lambda np, a: np.dstack([a[0], a[1]]),
    "column_stack": lambda np, a: np.column_stack([a[0, 0], a[1, 0]]),
    "split": lambda np, a: np.split(a, 2, axis=2),
    "split_points": lambda np, a: np.split(a, [1, 3], axis=2),
    "array_split": lambda np, a: np.array_split(a, 3, axis=2),
    "hsplit": lambda np, a: np.hsplit(a, 3),
    "tile": lambda np, a: np.tile(a, (1, 2, 1)),
    "repeat": lambda np, a: np.repeat(a, 2, axis=1),
    "repeat_flat": lambda np, a: np.repeat(a, 2),
    "flip": lambda np, a: np.flip(a, 1),
    "flip_all": lambda np, a: np.flip(a),
    "fliplr": lambda np, a: np.fliplr(a[0]),
    "flipud": lambda np, a: np.flipud(a[0]),
    "roll": lambda np, a: np.roll(a, 2, axis=2),
    "rot90": lambda np, a: np.rot90(a[0], 1),
    "pad_constant": lambda np, a: np.pad(a, ((0, 0), (1, 2), (2, 1))),
    "pad_edge": lambda np, a: np.pad(a, ((0, 1), (1, 0), (2, 2)),
                                     mode="edge"),
    "pad_reflect": lambda np, a: np.pad(a, ((0, 0), (2, 2), (3, 1)),
                                        mode="reflect"),
    "pad_wrap": lambda np, a: np.pad(a, ((1, 1), (0, 0), (2, 3)),
                                     mode="wrap"),
    "atleast_3d": lambda np, a: np.atleast_3d(a[0, 0]),
    "append": lambda np, a: np.append(a, a, axis=0),
    "diagonal": lambda np, a: np.diagonal(a, 0, 1, 2),
    "tril": lambda np, a: np.tril(a[0], -1),
    "triu": lambda np, a: np.triu(a[0], 1),
    "trace": lambda np, a: np.trace(a[0]),
    "diag": lambda np, a: np.diag(a[0, 0]),
    "diagflat": lambda np, a: np.diagflat(a[0, 0]),
    "sort": lambda np, a: np.sort(a, axis=1),
    "argsort": lambda np, a: np.argsort(a, axis=-1),
    "msort": lambda np, a: np.msort(a),
    "clip": lambda np, a: np.clip(a, -0.3, 0.4),
    "round": lambda np, a: np.round(a, 2),
    "where": lambda np, a: np.where(a > 0, a, -a),
    "take": lambda np, a: np.take(a, np.array([2, 0, 1]), axis=2),
    "take_flat": lambda np, a: np.take(a, np.array([5, 0, 23])),
    "take_along_axis": lambda np, a: np.take_along_axis(
        a, np.argsort(a, axis=1), axis=1),
    "diff": lambda np, a: np.diff(a, axis=2),
    "ediff1d": lambda np, a: np.ediff1d(a[0, 0]),
    "einsum": lambda np, a: np.einsum("abc,adc->abd", a, a),
    "tensordot": lambda np, a: np.tensordot(a, a, axes=([1, 2], [1, 2])),
    "dot": lambda np, a: np.dot(a[0], a[1].T),
    "dot_nd": lambda np, a: np.dot(a, a[0].T),
    "matmul": lambda np, a: np.matmul(a, np.swapaxes(a, 1, 2)),
    "vdot": lambda np, a: np.vdot(a[0], a[1]),
    "inner": lambda np, a: np.inner(a[0], a[1]),
    "outer": lambda np, a: np.outer(a[0, 0], a[1, 0]),
    "kron": lambda np, a: np.kron(a[0], a[1]),
    "cross": lambda np, a: np.cross(a[0, :, :3], a[1, :, :3]),
    "quantile": lambda np, a: np.quantile(a, 0.3, axis=1),
    "percentile": lambda np, a: np.percentile(a, 75),
    "cov": lambda np, a: np.cov(a[0]),
    "corrcoef": lambda np, a: np.corrcoef(a[0]),
    "isclose": lambda np, a: np.isclose(a, a + 1e-7),
    "searchsorted": lambda np, a: np.searchsorted(
        np.sort(np.ravel(a)), np.array([-0.5, 0.0, 0.5])),
    "digitize": lambda np, a: np.digitize(np.ravel(a),
                                          np.array([-0.5, 0.0, 0.5])),
    "polyval": lambda np, a: np.polyval(np.array([1.0, -2.0, 0.5]), a),
    "isin": lambda np, a: np.isin(np.round(a * 3), np.array([0.0, 1.0])),
    "average": lambda np, a: np.average(a, axis=2,
                                        weights=np.array([1.0, 2, 3, 4])),
    "unique": lambda np, a: np.unique(np.round(a * 2)),
    "nonzero": lambda np, a: np.nonzero(a[0] > 0),
    "argwhere": lambda np, a: np.argwhere(a[0] > 0),
    "select": lambda np, a: np.select([a < -0.3, a > 0.3], [a * 2, a * 3],
                                      0.5),
    "interp": lambda np, a: np.interp(np.ravel(a), np.array([-1.0, 0, 1]),
                                      np.array([0.0, 2.0, 1.0])),
    "interp_edges": lambda np, a: np.interp(np.ravel(a) * 3,
                                            np.array([-1.0, 0, 2]),
                                            np.array([0.0, 2.0, 1.0]),
                                            left=-5.0),
    "convolve": lambda np, a: np.convolve(a[0, 0], a[1, 1]),
    "convolve_same": lambda np, a: np.convolve(np.ravel(a)[:7], a[0, 0],
                                               mode="same"),
    "convolve_valid": lambda np, a: np.convolve(a[0, 0][:3],
                                                np.ravel(a)[:8], "valid"),
    "correlate": lambda np, a: np.correlate(np.ravel(a)[:9], a[0, 0]),
    "correlate_full": lambda np, a: np.correlate(a[0, 0][:3],
                                                 np.ravel(a)[:6], "full"),
    "correlate_same": lambda np, a: np.correlate(np.ravel(a)[:6],
                                                 a[1, 2], "same"),
}


@pytest.mark.parametrize("name", sorted(SHAPE))
def test_shape_and_misc_match_jax(name):
    _close(*_both(SHAPE[name], X3), SUM_RTOL, SUM_ATOL)


CREATE = {
    "zeros": lambda np: np.zeros((2, 3)),
    "ones_int": lambda np: np.ones((2,), dtype="int32"),
    "full": lambda np: np.full((2, 2), 7),
    "full_float": lambda np: np.full((3,), 0.5),
    "arange": lambda np: np.arange(5),
    "arange_float": lambda np: np.arange(0.5, 3.0, 0.5),
    "arange_dtype": lambda np: np.arange(2, 9, 3, dtype="float32"),
    "linspace": lambda np: np.linspace(0, 1, 7),
    "linspace_open": lambda np: np.linspace(-1, 1, 4, endpoint=False),
    "logspace": lambda np: np.logspace(0, 2, 5),
    "eye": lambda np: np.eye(3, 4, 1),
    "identity": lambda np: np.identity(3),
    "tri": lambda np: np.tri(3, 4, 0),
    "indices": lambda np: np.indices((2, 3)),
    "meshgrid": lambda np: np.meshgrid(np.arange(3), np.arange(2.0)),
    "array_int": lambda np: np.array([[1, 2], [3, 4]]),
    "array_float64_data": lambda np: np.array(onp.ones(3, onp.float64)),
    "array_bool": lambda np: np.array([True, False]),
    "zeros_like": lambda np: np.zeros_like(np.ones((2, 2), dtype="int32")),
    "full_like": lambda np: np.full_like(np.ones((2,)), 3.0),
    "tril_indices": lambda np: np.tril_indices(3),
    "triu_indices": lambda np: np.triu_indices(3, 1),
    "hanning": lambda np: np.hanning(5),
}


@pytest.mark.parametrize("name", sorted(CREATE))
def test_creation_matches_jax(name):
    _close(*_both(CREATE[name]))


def test_creation_lands_on_the_current_context():
    with tmx.cpu():
        a = tmx.np.zeros((2,))
        assert a.context == tmx.cpu() and a._data.device.type == "cpu"
    assert tmx.current_context() == tmx.gpu(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmx.np.zeros((2,))                   # gpu(0) without a card
    with pytest.raises(ValueError, match="GPU"):
        tmx.tpu()


def test_convolve_and_interp_record_gradients_like_jax():
    """``convolve``, ``correlate`` and ``interp`` are recorded by
    autograd, as the JAX package's ``jnp`` functions are."""
    def run(mx):
        a, v = mx.np.array(_rand(7, 6)), mx.np.array(_rand(8, 3))
        x = mx.np.array(_rand(9, 5) * 0.9)
        for t in (a, v, x):
            t.attach_grad()
        with mx.autograd.record():
            y = (mx.np.convolve(a, v) ** 2).sum() + \
                (mx.np.correlate(a, v, "same") * 3).sum() + \
                (mx.np.interp(x, mx.np.array([-1.0, 0.0, 1.0]),
                              mx.np.array([0.0, 2.0, 1.0])) ** 2).sum()
        y.backward()
        return [t.grad.asnumpy() for t in (a, v, x)]
    with tmx.cpu():
        got = run(tmx)
    _close(got, run(jmx))


def test_fill_diagonal_and_put_along_axis_write_in_place():
    x = onp.zeros((3, 3), onp.float32)
    idx = onp.array([[0], [2], [1]], onp.int32)
    with tmx.cpu():
        t = tmx.np.array(x)
        tmx.np.fill_diagonal(t, 5.0)
        tmx.np.put_along_axis(t, tmx.np.array(idx), 9.0, axis=1)
    want = x.copy()
    onp.fill_diagonal(want, 5.0)
    onp.put_along_axis(want, idx, 9.0, axis=1)
    onp.testing.assert_array_equal(t.asnumpy(), want)


# ----------------------------------------------------------------------
# mx.np.random
# ----------------------------------------------------------------------
SAMPLERS = {
    "uniform": (lambda r: r.uniform(-2, 4, size=(4000,)), "float32",
                1.0, 3.0),
    "normal": (lambda r: r.normal(1.0, 2.0, size=(4000,)), "float32",
               1.0, 4.0),
    "randn": (lambda r: r.randn(4000), "float32", 0.0, 1.0),
    "randint": (lambda r: r.randint(0, 10, size=(4000,)), "int32", 4.5,
                8.25),
    "exponential": (lambda r: r.exponential(2.0, size=(4000,)), "float32",
                    2.0, 4.0),
    "gamma": (lambda r: r.gamma(3.0, 2.0, size=(4000,)), "float32", 6.0,
              12.0),
    "beta": (lambda r: r.beta(2.0, 3.0, size=(4000,)), "float32", 0.4,
             0.04),
    "poisson": (lambda r: r.poisson(3.0, size=(4000,)), "int32", 3.0, 3.0),
    "binomial": (lambda r: r.binomial(10, 0.3, size=(4000,)), "int32", 3.0,
                 2.1),
    "laplace": (lambda r: r.laplace(1.0, 2.0, size=(4000,)), "float32",
                1.0, 8.0),
    "logistic": (lambda r: r.logistic(0.0, 1.0, size=(4000,)), "float32",
                 0.0, onp.pi ** 2 / 3),
    "gumbel": (lambda r: r.gumbel(0.0, 1.0, size=(4000,)), "float32",
               onp.euler_gamma, onp.pi ** 2 / 6),
    "lognormal": (lambda r: r.lognormal(0.0, 0.5, size=(4000,)), "float32",
                  onp.exp(0.125), (onp.exp(0.25) - 1) * onp.exp(0.25)),
    "rayleigh": (lambda r: r.rayleigh(1.0, size=(4000,)), "float32",
                 onp.sqrt(onp.pi / 2), (4 - onp.pi) / 2),
    "weibull": (lambda r: r.weibull(1.0, size=(4000,)), "float32", 1.0,
                1.0),
    "pareto": (lambda r: r.pareto(5.0, size=(4000,)), "float32", 0.25,
               5 / (16 * 3)),
    "power": (lambda r: r.power(2.0, size=(4000,)), "float32", 2 / 3,
              1 / 18),
    "chisquare": (lambda r: r.chisquare(4.0, size=(4000,)), "float32", 4.0,
                  8.0),
    "bernoulli": (lambda r: r.bernoulli(0.3, size=(4000,)), "float32", 0.3,
                  0.21),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_random_sampler_seed_shape_dtype_moments(name):
    """Same seed, same draws; the JAX package's shape and dtype; mean and
    variance of 4000 draws within 5 standard errors of the
    distribution's."""
    draw, dtype, mean, var = SAMPLERS[name]
    with tmx.cpu():
        tmx.np.random.seed(7)
        a = draw(tmx.np.random).asnumpy()
        tmx.np.random.seed(7)
        b = draw(tmx.np.random).asnumpy()
        c = draw(tmx.np.random).asnumpy()
    jmx.np.random.seed(7)
    j = draw(jmx.np.random).asnumpy()
    onp.testing.assert_array_equal(a, b)
    assert not onp.array_equal(b, c)
    assert a.shape == j.shape and a.dtype == j.dtype == onp.dtype(dtype)
    n = a.size
    assert abs(a.mean() - mean) <= 5 * onp.sqrt(var / n), (a.mean(), mean)
    assert abs(a.var() - var) <= 5 * var * onp.sqrt(2.0 / n) + 1e-6 \
        or name in ("pareto", "laplace", "lognormal"), (a.var(), var)


def test_random_choice_permutation_shuffle_multinomial():
    with tmx.cpu():
        tmx.np.random.seed(3)
        c = tmx.np.random.choice(5, size=(200,)).asnumpy()
        perm = tmx.np.random.permutation(10).asnumpy()
        x = tmx.np.arange(10)
        tmx.np.random.shuffle(x)
        m = tmx.np.random.multinomial(20, [0.2, 0.3, 0.5], size=(4,))
        mvn = tmx.np.random.multivariate_normal(
            onp.zeros(2, onp.float32), onp.eye(2, dtype=onp.float32),
            size=(3,))
        nc = tmx.np.random.choice(6, size=(6,), replace=False).asnumpy()
    assert set(c.tolist()) <= set(range(5)) and c.dtype == onp.int32
    assert sorted(perm.tolist()) == list(range(10))
    assert sorted(x.asnumpy().tolist()) == list(range(10))
    assert m.shape == (4, 3) and (m.asnumpy().sum(-1) == 20).all()
    assert mvn.shape == (3, 2)
    assert sorted(nc.tolist()) == list(range(6))


def test_random_normal_reaches_its_parameters_with_gradients():
    with tmx.cpu():
        loc = tmx.np.array([1.0, 2.0])
        scale = tmx.np.array([0.5, 3.0])
        loc.attach_grad()
        scale.attach_grad()
        with tmx.autograd.record():
            s = tmx.np.random.normal(loc, scale)
        s.backward()
    onp.testing.assert_array_equal(loc.grad.asnumpy(), [1.0, 1.0])
    z = (s.asnumpy() - [1.0, 2.0]) / [0.5, 3.0]
    onp.testing.assert_allclose(scale.grad.asnumpy(), z, rtol=1e-6)


# partition / argpartition follow jnp (two top-k's), not numpy: the kth
# + 1 smallest ascending, then the largest descending; argpartition's
# tail is the remaining indices in ascending order.  TIES rounds values
# to a few levels so that equal values meet the kth boundary.
TIES = onp.round(_rand(10, 3, 5, 6) * 2)
DISTINCT = _rand(11, 3, 5, 6)
PARTITION_CASES = [(kth, axis) for axis in (-1, 0, 1)
                   for kth in (0, 2, -1, -3)]


@pytest.mark.parametrize("data", [TIES, DISTINCT], ids=["ties", "distinct"])
@pytest.mark.parametrize("kth,axis", PARTITION_CASES)
def test_partition_and_argpartition_match_jax(data, kth, axis):
    _close(*_both(lambda np, a: np.partition(a, kth, axis=axis), data))
    _close(*_both(lambda np, a: np.argpartition(a, kth, axis=axis), data))


@pytest.mark.parametrize("data", [TIES, DISTINCT], ids=["ties", "distinct"])
def test_partition_gradient_matches_jax_grad(data):
    """``partition`` is recorded, and its gradient reaches each value's
    index as ``jax.grad`` of ``jnp.partition`` routes it (ties
    included)."""
    import jax
    import jax.numpy as jnp
    w = _rand(12, 3, 5, 6)
    with tmx.cpu():
        a = tmx.np.array(data)
        a.attach_grad()
        with tmx.autograd.record():
            y = (tmx.np.partition(a, 2, axis=1) * tmx.np.array(w)).sum()
        y.backward()
        got = a.grad.asnumpy()
    want = jax.grad(lambda x: (jnp.partition(x, 2, axis=1) * w).sum())(
        jnp.asarray(data))
    _close(got, onp.asarray(want))


HIST_CASES = {
    "bins": lambda np, a: np.histogram(a, bins=7),
    "range": lambda np, a: np.histogram(a, bins=4, range=(-0.5, 0.5)),
    "edges": lambda np, a: np.histogram(a, bins=np.array([-1.0, -0.2, 0.1,
                                                          0.9])),
    "weights_density": lambda np, a: np.histogram(
        a, bins=5, weights=a * a, density=True),
    "int_input": lambda np, a: np.histogram(np.round(a * 4).astype("int32"),
                                            bins=3),
}


@pytest.mark.parametrize("name", sorted(HIST_CASES))
def test_histogram_counts_and_edges_match_jax(name):
    """Counts in the reference's float dtype (float32, not int), edges
    to float32 rounding."""
    _close(*_both(HIST_CASES[name], DISTINCT))


# F5 and F6 (ROADMAP section 3): np.pad's modes as jnp.pad computes them,
# and meshgrid's sparse= / indexing=
PAD_ARG = onp.arange(12.0, dtype=onp.float32).reshape(3, 4)
PAD = {
    "reflect_odd": (1, dict(mode="reflect", reflect_type="odd")),
    "reflect_odd_wide": (((5, 2), (7, 1)),
                         dict(mode="reflect", reflect_type="odd")),
    "symmetric": (1, dict(mode="symmetric")),
    "symmetric_odd_wide": (6, dict(mode="symmetric", reflect_type="odd")),
    "maximum": (1, dict(mode="maximum")),
    "minimum": (((1, 2), (0, 3)), dict(mode="minimum")),
    "mean": (2, dict(mode="mean")),
    "mean_stat_length": (2, dict(mode="mean", stat_length=((1, 2), (3, 1)))),
    "median": (1, dict(mode="median")),
    "linear_ramp": (((2, 3), (1, 4)), dict(mode="linear_ramp")),
    "linear_ramp_end_values": (2, dict(mode="linear_ramp",
                                       end_values=((1, 2), (3, 4)))),
    "constant_pairs": (1, dict(constant_values=((1, 2), (3, 4)))),
    "constant_one_pair": (((2, 1), (1, 2)), dict(constant_values=(7, 8))),
    "wrap_wide": (5, dict(mode="wrap")),
}


@pytest.mark.parametrize("name", sorted(PAD))
def test_pad_modes_match_jax(name):
    width, kw = PAD[name]
    _close(*_both(lambda np, a: np.pad(a, width, **kw), PAD_ARG), SUM_RTOL,
           SUM_ATOL)


def test_pad_empty_matches_jax_in_shape_and_dtype():
    got, want = _both(lambda np, a: np.pad(a, ((1, 2), (3, 0)),
                                           mode="empty"), PAD_ARG)
    assert got.shape == want.shape and got.dtype == want.dtype
    onp.testing.assert_array_equal(got[1:4, 3:], PAD_ARG)


MESHGRID = {
    "sparse_xy": dict(sparse=True),
    "sparse_ij": dict(sparse=True, indexing="ij"),
    "dense_ij": dict(indexing="ij"),
    "dense_xy": dict(),
}


@pytest.mark.parametrize("name", sorted(MESHGRID))
def test_meshgrid_sparse_and_indexing_match_jax(name):
    kw = MESHGRID[name]
    for arrays in ((onp.arange(3.0, dtype=onp.float32),
                    onp.arange(2, dtype=onp.int32)),
                   (onp.arange(3.0, dtype=onp.float32),
                    onp.arange(2.0, dtype=onp.float32),
                    onp.arange(4.0, dtype=onp.float32))):
        got, want = _both(lambda np, *a: np.meshgrid(*a, **kw), *arrays)
        _close(got, want)
