"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: ``Initializer`` with the
name-suffix dispatch of :42-90 (``bias`` -> 0, ``gamma`` -> 1, ``beta``
-> 0, ``running_mean`` / ``moving_mean`` -> 0, ``running_var`` /
``moving_var`` -> 1, everything else ``_init_weight``), ``Zero``,
``One``, ``Constant``, ``Uniform`` (MXNet's default, scale 0.07),
``Normal``, ``Orthogonal``, ``Xavier``, ``MSRAPrelu`` and ``Mixed``.

An initializer fills a tensor in place: ``init(desc, tensor,
generator)``.  Random values are drawn in float32 from the explicit
``torch.Generator`` on that generator's device (the tensor's device
when it is None, from the device's default generator) and then copied
into the tensor in its own dtype, as the JAX package draws in float32
and casts.  JAX keys and torch generators give different numbers from
one seed, so the two packages agree on the rules, not the draws.

``Bilinear`` and ``LSTMBias`` wait for ROADMAP queue 5 and raise
``NotImplementedError``.
"""
from __future__ import annotations

import math
import re

import torch

__all__ = ["InitDesc", "Initializer", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear",
           "LSTMBias", "Mixed", "create", "register"]

_registry = {}


def register(klass=None, name=None):
    """Register an initializer class under its lowercase name (and
    ``name``); usable as ``@register`` or ``@register(name=...)``."""
    def add(k):
        _registry[(name or k.__name__).lower()] = k
        return k
    return add if klass is None else add(klass)


def create(init, **kwargs):
    """An ``Initializer`` instance from itself or a registered name."""
    if isinstance(init, Initializer):
        return init
    try:
        return _registry[init.lower()](**kwargs)
    except KeyError:
        raise ValueError("Cannot find initializer %r (have %s)"
                         % (init, sorted(_registry))) from None


class InitDesc(str):
    """A parameter's name with attributes: ``attrs["__init__"]`` names an
    initializer that overrides the suffix dispatch (the parameter's own
    ``init``, e.g. a layer's ``bias_initializer``)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def _random(arr, generator):
    """An empty float32 tensor of ``arr``'s shape on the generator's
    device, for an in-place draw from it."""
    dev = generator.device if generator is not None else arr.device
    return torch.empty(arr.shape, dtype=torch.float32, device=dev)


class Initializer:
    """Base initializer: ``init(desc, tensor, generator=None)`` fills
    ``tensor`` in place by the rule its name calls for."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    @torch.no_grad()
    def __call__(self, desc, arr, generator=None):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string InitDesc")
        explicit = getattr(desc, "attrs", {}).get("__init__")
        if explicit is not None:
            create(explicit)._init_weight(desc, arr, generator)
        elif desc.endswith("bias") or desc.endswith("beta") \
                or desc.endswith("running_mean") \
                or desc.endswith("moving_mean"):
            arr.zero_()
        elif desc.endswith("gamma") or desc.endswith("running_var") \
                or desc.endswith("moving_var"):
            arr.fill_(1.0)
        else:
            self._init_weight(desc, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._kwargs)


@register(name="zeros")
@register
class Zero(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.zero_()


@register(name="ones")
@register
class One(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.fill_(1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr, generator):
        arr.copy_(torch.as_tensor(self.value).expand(arr.shape))


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        arr.copy_(_random(arr, generator).uniform_(-self.scale, self.scale,
                                                   generator=generator))


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr, generator):
        arr.copy_(_random(arr, generator).normal_(0.0, self.sigma,
                                                  generator=generator))


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of a random (out, in)
    matrix (uniform in [-1, 1] or normal)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        dev = generator.device if generator is not None else arr.device
        tmp = torch.empty((nout, nin), dtype=torch.float32, device=dev)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr.copy_(self.scale * q.reshape(arr.shape))


@register
class Xavier(Initializer):
    """Glorot: scale = sqrt(magnitude / factor), factor the fan in, the
    fan out or their mean, where fan in = shape[1] * prod(shape[2:]) and
    fan out = shape[0] * prod(shape[2:]); U(-scale, scale) or
    N(0, scale^2)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires >=2D weight, got %s for %s"
                             % (tuple(shape), name))
        hw_scale = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        w = _random(arr, generator)
        if self.rnd_type == "uniform":
            w.uniform_(-scale, scale, generator=generator)
        elif self.rnd_type == "gaussian":
            w.normal_(0.0, scale, generator=generator)
        else:
            raise ValueError("Unknown random type")
        arr.copy_(w)


@register
class MSRAPrelu(Xavier):
    """He/MSRA: gaussian Xavier with magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    def _init_weight(self, name, arr, generator):
        raise NotImplementedError("mxnet_tpu_torch: the Bilinear "
                                  "initializer is not ported yet (ROADMAP "
                                  "queue 5)")


@register
class LSTMBias(Initializer):
    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError("mxnet_tpu_torch: the LSTMBias "
                                  "initializer is not ported yet (ROADMAP "
                                  "queue 5)")


class Mixed:
    """The first initializer whose pattern matches the parameter's full
    name (``re.match``) fills it."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers length mismatch")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr, generator=None):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr, generator)
                return
        raise ValueError("Parameter name %s did not match any pattern" % name)
