"""``mx.np.random`` -- samplers over one ``torch.Generator`` per device.

Counterpart of ``mxnet_tpu/numpy/random.py``.  MXNet's random state is
stateful and per device: :func:`seed` (``mx.np.random.seed(n)``, :65)
seeds every device's generator (``ctx="all"``) or one context's, after
which the samplers are deterministic; ``Block.initialize`` and
``npx.dropout`` draw from the same generators.  Every sampler takes
``ctx`` / ``device`` (default: the current context) and returns an
NDArray; samples are float32 unless ``dtype`` says otherwise, integer
ones int32.  Where ``loc`` / ``scale`` (or ``low`` / ``high``) are
NDArrays the sample is ``loc + scale * standard sample``, so gradients
reach them under ``autograd.record()``.

JAX keys and torch generators give different numbers from one seed, so
the two packages agree on distributions, shapes and dtypes, not draws.
Samplers torch has no generator-taking operator for (gamma and the ones
built on it) draw in a forked RNG state seeded from the device's
generator, which keeps them deterministic under :func:`seed`.
"""
from __future__ import annotations

import builtins
import math

import torch

from ..context import Context, resolve_device
from ..ndarray.ndarray import NDArray, apply_op, as_tensor, to_torch_dtype

__all__ = ["seed", "generator", "uniform", "normal", "randn", "rand",
           "standard_normal", "randint", "choice", "permutation", "shuffle",
           "beta", "gamma", "exponential", "poisson", "multinomial",
           "multivariate_normal", "bernoulli", "laplace", "logistic",
           "gumbel", "lognormal", "rayleigh", "weibull", "pareto", "power",
           "chisquare", "f", "binomial", "negative_binomial"]

_GENERATORS = {}


def generator(device=None):
    """The module's ``torch.Generator`` of ``device`` (default: the
    current context's), made on first use from torch's default seed."""
    dev = resolve_device(device)
    key = (dev.type, dev.index or 0) if dev.type == "cuda" else ("cpu", 0)
    g = _GENERATORS.get(key)
    if g is None:
        g = _GENERATORS[key] = torch.Generator(device=dev)
        g.seed()
    return g


def seed(seed_state=None, ctx="all"):
    """Seed the generator of every device (``ctx="all"``) or of one
    context; ``None`` draws a fresh seed."""
    if ctx == "all":
        devices = ["cpu"] + ["cuda:%d" % i
                             for i in builtins.range(torch.cuda.device_count())]
    else:
        devices = [ctx.torch_device if isinstance(ctx, Context) else ctx]
    for dev in devices:
        g = generator(dev)
        if seed_state is None:
            g.seed()
        else:
            g.manual_seed(int(seed_state))


def _shape(size):
    if size is None:
        return ()
    return (size,) if isinstance(size, int) else tuple(size)


def _dev(ctx, device, *params):
    for p in params:
        if isinstance(p, NDArray):
            return p._data.device
    return resolve_device(ctx if ctx is not None else device)


def _dt(dtype, default=torch.float32):
    return to_torch_dtype(dtype) if dtype is not None else default


def _out(r, out):
    if out is None:
        return r
    out[...] = r
    return out


def _param(x, dev, dtype=torch.float32):
    return x._data if isinstance(x, NDArray) else torch.as_tensor(
        x, dtype=dtype, device=dev)


def _bshape(shape, *params):
    return shape or torch.broadcast_shapes(*(p.shape for p in params))


def _affine(sampler, a, b, shape, dtype, dev, name, out, combine):
    """``combine(a, b, standard sample)``, recorded when a or b is an
    NDArray."""
    gen = generator(dev)
    if isinstance(a, NDArray) or isinstance(b, NDArray):
        def g(x, y):
            z = sampler(_bshape(shape, x, y), gen, dev, x.dtype)
            return combine(x, y, z)
        return _out(apply_op(g, [_param(a, dev), _param(b, dev)], name), out)
    z = sampler(shape, gen, dev, dtype)
    return _out(NDArray(combine(a, b, z).to(dtype)), out)


def _std_uniform(shape, gen, dev, dtype):
    return torch.rand(shape, generator=gen, device=dev, dtype=dtype)


def _std_normal(shape, gen, dev, dtype):
    return torch.randn(shape, generator=gen, device=dev, dtype=dtype)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, device=None,
            out=None):
    dev = _dev(ctx, device, low, high)
    return _affine(_std_uniform, low, high, _shape(size), _dt(dtype), dev,
                   "uniform", out, lambda lo, hi, u: lo + u * (hi - lo))


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, device=None,
           out=None):
    dev = _dev(ctx, device, loc, scale)
    return _affine(_std_normal, loc, scale, _shape(size), _dt(dtype), dev,
                   "normal", out, lambda mu, sig, z: mu + sig * z)


def randn(*size, dtype=None, ctx=None, device=None):
    return normal(0.0, 1.0, size=size or None, dtype=dtype, ctx=ctx,
                  device=device)


def rand(*size, ctx=None, device=None):
    return uniform(0.0, 1.0, size=size or None, ctx=ctx, device=device)


def standard_normal(size=None, dtype=None, ctx=None, device=None):
    return normal(0.0, 1.0, size=size, dtype=dtype, ctx=ctx, device=device)


def randint(low, high=None, size=None, dtype=None, ctx=None, device=None,
            out=None):
    if high is None:
        low, high = 0, low
    dev = _dev(ctx, device)
    r = torch.randint(int(low), int(high), _shape(size), generator=generator(
        dev), device=dev, dtype=torch.int64).to(_dt(dtype, torch.int32))
    return _out(NDArray(r), out)


def choice(a, size=None, replace=True, p=None, ctx=None, device=None,
           out=None):
    dev = _dev(ctx, device, a, p)
    pool = torch.arange(a, device=dev, dtype=torch.int32) \
        if isinstance(a, int) else as_tensor(a, device=dev)
    shape = _shape(size)
    n = math.prod(shape) if shape else 1
    w = torch.ones(pool.shape[0], device=dev) if p is None \
        else _param(p, dev).float()
    idx = torch.multinomial(w, n, replacement=replace,
                            generator=generator(dev))
    r = pool[idx].reshape(shape) if shape else pool[idx[0]]
    return _out(NDArray(r), out)


def permutation(x, ctx=None, device=None):
    dev = _dev(ctx, device, x)
    if isinstance(x, int):
        return NDArray(torch.randperm(x, generator=generator(dev),
                                      device=dev).to(torch.int32))
    t = as_tensor(x, device=dev)
    return NDArray(t[torch.randperm(t.shape[0], generator=generator(dev),
                                    device=dev)])


def shuffle(x):
    """Shuffle ``x`` along its first axis, in place."""
    dev = x._data.device
    x[...] = NDArray(x._data[torch.randperm(x.shape[0], device=dev,
                                            generator=generator(dev))])


def _forked(dev, fn):
    """``fn()`` with torch's default RNG of ``dev`` seeded from the
    module's generator of ``dev`` (for samplers that take no generator),
    the default state restored after."""
    s = int(torch.randint(0, 2 ** 62, (1,), generator=generator(dev),
                          device=dev).item())
    devices = [dev.index or 0] if dev.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        if dev.type == "cuda":
            torch.cuda.manual_seed(s)
        else:
            torch.manual_seed(s)
        return fn()


def _gamma_t(shape_param, size, dev):
    a = _param(shape_param, dev)
    a = torch.broadcast_to(a, _bshape(size, a)) if size else a
    return _forked(dev, lambda: torch._standard_gamma(a.float().contiguous()))


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None, device=None,
          out=None):
    dev = _dev(ctx, device, shape, scale)
    r = _gamma_t(shape, _shape(size), dev) * _param(scale, dev)
    return _out(NDArray(r.to(_dt(dtype))), out)


def beta(a, b, size=None, dtype=None, ctx=None, device=None):
    dev = _dev(ctx, device, a, b)
    x = _gamma_t(a, _shape(size), dev)
    y = _gamma_t(b, _shape(size), dev)
    return NDArray((x / (x + y)).to(_dt(dtype)))


def chisquare(df, size=None, dtype=None, ctx=None, device=None):
    dev = _dev(ctx, device, df)
    return NDArray((2 * _gamma_t(_param(df, dev) / 2, _shape(size), dev))
                   .to(_dt(dtype)))


def f(dfnum, dfden, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, dfnum, dfden)
    num = chisquare(dfnum, size, device=dev)._data / _param(dfnum, dev)
    den = chisquare(dfden, size, device=dev)._data / _param(dfden, dev)
    return NDArray(num / den)


def exponential(scale=1.0, size=None, ctx=None, device=None, out=None):
    dev = _dev(ctx, device, scale)
    sc = _param(scale, dev)
    shape = _bshape(_shape(size), sc)
    e = torch.empty(shape, device=dev).exponential_(generator=generator(dev))
    return _out(NDArray(e * sc), out)


def poisson(lam=1.0, size=None, ctx=None, device=None, out=None):
    dev = _dev(ctx, device, lam)
    lv = _param(lam, dev)
    rates = torch.broadcast_to(lv, _bshape(_shape(size), lv)).float()
    r = torch.poisson(rates.contiguous(), generator=generator(dev))
    return _out(NDArray(r.to(torch.int32)), out)


def binomial(n, p, size=None, dtype=None, ctx=None, device=None):
    dev = _dev(ctx, device, n, p)
    nv, pv = _param(n, dev), _param(p, dev)
    shape = _bshape(_shape(size), nv, pv)
    r = torch.binomial(torch.broadcast_to(nv, shape).float().contiguous(),
                       torch.broadcast_to(pv, shape).float().contiguous(),
                       generator=generator(dev))
    return NDArray(r.to(_dt(dtype, torch.int32)))


def negative_binomial(n, p, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, n, p)
    pv = _param(p, dev)
    lam = _gamma_t(n, _shape(size), dev) * (1 - pv) / pv
    r = torch.poisson(lam.float().contiguous(), generator=generator(dev))
    return NDArray(r.to(torch.int32))


def multinomial(n, pvals, size=None, ctx=None, device=None):
    dev = _dev(ctx, device, pvals)
    pv = _param(pvals, dev).float()
    batch = _shape(size)
    flat = pv.reshape(-1, pv.shape[-1]).repeat(max(1, math.prod(batch)), 1)
    idx = torch.multinomial(flat, int(n), replacement=True,
                            generator=generator(dev))
    counts = torch.zeros_like(flat, dtype=torch.int32).scatter_add_(
        1, idx, torch.ones_like(idx, dtype=torch.int32))
    return NDArray(counts.reshape(batch + tuple(pv.shape)))


def multivariate_normal(mean, cov, size=None, check_valid=None, tol=None,
                        ctx=None, device=None):
    dev = _dev(ctx, device, mean, cov)
    mv, cv = _param(mean, dev), _param(cov, dev)
    L = torch.linalg.cholesky(cv.double())
    z = torch.randn(_shape(size) + (mv.shape[-1],), generator=generator(dev),
                    device=dev, dtype=torch.float64)
    return NDArray((mv.double() + z @ L.T).to(torch.float32))


def bernoulli(prob=None, logit=None, size=None, dtype=None, ctx=None,
              device=None, out=None):
    if (prob is None) == (logit is None):
        raise ValueError("pass exactly one of prob or logit")
    dev = _dev(ctx, device, prob if prob is not None else logit)
    p = _param(prob, dev) if prob is not None \
        else torch.sigmoid(_param(logit, dev))
    u = torch.rand(_bshape(_shape(size), p), generator=generator(dev),
                   device=dev)
    return _out(NDArray((u < p).to(_dt(dtype))), out)


def _transform(name, fn, nparams=2):
    """A sampler ``fn(params..., u)`` of one standard uniform draw."""
    def sampler(*params, size=None, ctx=None, device=None, out=None):
        dev = _dev(ctx, device, *params)
        ps = [_param(x, dev) for x in params]
        u = torch.rand(_bshape(_shape(size), *ps), generator=generator(dev),
                       device=dev)
        return _out(NDArray(fn(*ps, u).float()), out)
    sampler.__name__ = name
    return sampler


_laplace = _transform("laplace", lambda loc, sc, u: loc - sc * torch.sign(
    u - 0.5) * torch.log1p(-2 * torch.abs(u - 0.5)))
_logistic = _transform("logistic", lambda loc, sc, u: loc + sc * (
    torch.log(u) - torch.log1p(-u)))
_gumbel = _transform("gumbel", lambda loc, sc, u: loc - sc * torch.log(
    -torch.log(u)))
_rayleigh = _transform("rayleigh", lambda sc, u: sc * torch.sqrt(
    -2 * torch.log1p(-u)))
_weibull = _transform("weibull", lambda a, u: torch.pow(-torch.log1p(-u),
                                                        1.0 / a))
_pareto = _transform("pareto", lambda a, u: torch.pow(1 - u, -1.0 / a) - 1)
_power = _transform("power", lambda a, u: torch.pow(u, 1.0 / a))


def laplace(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None,
            device=None, out=None):
    return _laplace(loc, scale, size=size, ctx=ctx, device=device, out=out)


def logistic(loc=0.0, scale=1.0, size=None, ctx=None, device=None,
             out=None):
    return _logistic(loc, scale, size=size, ctx=ctx, device=device, out=out)


def gumbel(loc=0.0, scale=1.0, size=None, ctx=None, device=None, out=None):
    return _gumbel(loc, scale, size=size, ctx=ctx, device=device, out=out)


def rayleigh(scale=1.0, size=None, ctx=None, device=None, out=None):
    return _rayleigh(scale, size=size, ctx=ctx, device=device, out=out)


def weibull(a, size=None, ctx=None, device=None, out=None):
    return _weibull(a, size=size, ctx=ctx, device=device, out=out)


def pareto(a, size=None, ctx=None, device=None, out=None):
    return _pareto(a, size=size, ctx=ctx, device=device, out=out)


def power(a, size=None, ctx=None, device=None, out=None):
    return _power(a, size=size, ctx=ctx, device=device, out=out)


def lognormal(mean=0.0, sigma=1.0, size=None, ctx=None, device=None,
              out=None):
    n = normal(mean, sigma, size=size, ctx=ctx, device=device)
    return _out(apply_op(torch.exp, [n], "lognormal"), out)
