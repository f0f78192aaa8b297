"""Plain PyTorch counterparts of the ``mxnet_tpu/ops/nn.py`` functions:
``fully_connected`` :27, ``dense`` :38, ``convolution`` :81,
``deconvolution`` :107, ``pooling`` :149, ``adaptive_avg_pool2d`` :193,
``batch_norm_train`` :223, ``batch_norm_inference`` :245, ``layer_norm``
:253, ``rms_norm`` :262, ``group_norm`` :270, ``instance_norm`` :283,
``log_softmax`` :322, ``leaky_relu`` :338, ``activation`` :359,
``dropout`` :383, ``embedding`` :399, ``pick`` :409 and
``dot_product_attention`` :469.

Convolutions, pooling and batch norm are ``torch.nn.functional`` /
native calls (cuDNN on the card), as the JAX package leaves them to XLA
outside any Pallas kernel.  A channels-last layout (``NWC``, ``NHWC``,
``NDHWC``) is carried by views: an (N, *spatial, C) tensor moved to
(N, C, *spatial) and an O*kI weight moved to OI*k are the channels-last
memory format, which cuDNN reads without a copy.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["fully_connected", "dense", "channels_last", "convolution",
           "deconvolution", "pooling", "adaptive_avg_pool2d",
           "batch_norm_train", "batch_norm_inference", "layer_norm",
           "rms_norm", "group_norm", "instance_norm", "log_softmax",
           "leaky_relu", "activation", "dropout", "embedding", "pick",
           "dot_product_attention"]


# ----------------------------------------------------------------------
# dense
# ----------------------------------------------------------------------
def fully_connected(x, weight, bias=None, flatten=True):
    """MXNet FullyConnected: ``y = x @ W.T + b``; ``flatten`` collapses
    every axis after the first."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    return F.linear(x, weight, bias)


def dense(x, weight, bias=None):
    """Gluon Dense on the trailing dim: ``y = x @ W.T + b`` with W shaped
    (out, in) as in MXNet."""
    return F.linear(x, weight, bias)


# ----------------------------------------------------------------------
# convolution and pooling
# ----------------------------------------------------------------------
def channels_last(layout):
    """True for NWC / NHWC / NDHWC."""
    return layout in ("NWC", "NHWC", "NDHWC")


def _first(x, last):
    """(N, *sp, C) -> (N, C, *sp) as a view when ``last``."""
    return x.movedim(-1, 1) if last else x


def _back(y, last):
    return y.movedim(1, -1) if last else y


def _tuple(v, n, default):
    return tuple(v) if v else (default,) * n


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def convolution(x, weight, bias=None, stride=None, pad=None, dilate=None,
                num_group=1, layout=None):
    """Grouped, strided, dilated 1-3D convolution.  NC+spatial layouts
    take OI+kernel weights; channels-last layouts take O+kernel+I weights
    (the JAX package's OHWI), both as views."""
    nsp = x.dim() - 2
    last = channels_last(layout)
    y = _CONV[nsp](_first(x, last), _first(weight, last), bias,
                   _tuple(stride, nsp, 1), _tuple(pad, nsp, 0),
                   _tuple(dilate, nsp, 1), num_group)
    return _back(y, last)


def deconvolution(x, weight, bias=None, stride=None, pad=None, dilate=None,
                  num_group=1, adj=None):
    """Transposed convolution, NC+spatial only; the weight is (in,
    out / groups, *kernel) as in MXNet."""
    nsp = x.dim() - 2
    return _CONV_T[nsp](x, weight, bias, _tuple(stride, nsp, 1),
                        _tuple(pad, nsp, 0), _tuple(adj, nsp, 0), num_group,
                        _tuple(dilate, nsp, 1))


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def pooling(x, kernel=(1, 1), pool_type="max", stride=None, pad=None,
            global_pool=False, count_include_pad=True, layout=None,
            ceil_mode=False):
    """Max / avg / sum / lp (p=2) pooling with the "valid" convention, or
    for max and avg with ``ceil_mode`` MXNet's "full" one: ``ceil((size
    + 2 pad - kernel) / stride) + 1`` windows an axis, the last clipped
    to the padded input (an avg window divided by its clipped size), as
    torch's ``ceil_mode`` computes it; torch drops a last window that
    would start in the right padding, which MXNet keeps.
    ``count_include_pad=False`` divides each window by its elements that
    are not padding."""
    nsp = x.dim() - 2
    last = channels_last(layout)
    x = _first(x, last)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError("unknown pool_type %r" % pool_type)
    if global_pool:
        dims = tuple(range(2, x.dim()))
        if pool_type == "max":
            y = x.amax(dim=dims, keepdim=True)
        elif pool_type == "avg":
            y = x.mean(dim=dims, keepdim=True)
        elif pool_type == "sum":
            y = x.sum(dim=dims, keepdim=True)
        else:
            y = x.abs().square().sum(dim=dims, keepdim=True).sqrt()
        return _back(y, last)
    kernel = tuple(kernel)
    stride = tuple(stride or kernel)
    pad = _tuple(pad, nsp, 0)
    if ceil_mode and pool_type not in ("max", "avg"):
        raise ValueError("ceil_mode takes max and avg pooling, not %r"
                         % pool_type)
    if pool_type == "max":
        y = _MAX_POOL[nsp](x, kernel, stride, pad, ceil_mode=ceil_mode)
    elif pool_type == "avg":
        y = _AVG_POOL[nsp](x, kernel, stride, pad, ceil_mode=ceil_mode,
                           count_include_pad=count_include_pad)
    else:
        src = x if pool_type == "sum" else x.abs().square()
        y = _AVG_POOL[nsp](src, kernel, stride, pad,
                           count_include_pad=True) * math.prod(kernel)
        if pool_type == "lp":
            y = y.sqrt()
    return _back(y, last)


def adaptive_avg_pool2d(x, output_size):
    """NCHW adaptive average.  Window i spans ``[floor(i h / oh),
    floor((i + 1) h / oh))``, the JAX function's bins (torch's
    ``adaptive_avg_pool2d`` rounds the end up instead)."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    n, c, h, w = x.shape
    oh, ow = output_size
    if h % oh == 0 and w % ow == 0:
        return x.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    ys = torch.linspace(0, h, oh + 1).long().to(x.device)
    xs = torch.linspace(0, w, ow + 1).long().to(x.device)
    cum = F.pad(x.cumsum(2).cumsum(3), (1, 0, 1, 0))

    def at(r, col):
        return cum[:, :, r][:, :, :, col]
    out = at(ys[1:], xs[1:]) - at(ys[:-1], xs[1:]) - at(ys[1:], xs[:-1]) \
        + at(ys[:-1], xs[:-1])
    area = (ys[1:] - ys[:-1])[:, None] * (xs[1:] - xs[:-1])[None, :]
    return out / area


# ----------------------------------------------------------------------
# normalization
# ----------------------------------------------------------------------
def batch_norm_train(x, gamma, beta, eps=1e-5, axis=1):
    """Training-mode batch norm over ``axis``: (out, batch mean, biased
    batch variance).  The statistics are float32 whatever x's dtype (the
    native kernel accumulates in float32, as the JAX function does), the
    output is in x's dtype.  ``gamma`` None means a gain of one.  Any
    ``axis`` is a view: channels-last inputs stay channels-last."""
    axis = axis % x.dim()
    xc = x.movedim(axis, 1)
    out, mean, rstd = torch.native_batch_norm(xc, gamma, beta, None, None,
                                              True, 0.0, eps)
    var = rstd.detach().double().pow(-2).sub(eps).to(mean.dtype)
    return out.movedim(1, axis), mean.detach(), var


def batch_norm_inference(x, gamma, beta, moving_mean, moving_var, eps=1e-5,
                         axis=1):
    """``(x - mean) * rsqrt(var + eps) * gamma + beta`` over ``axis``
    with the running statistics."""
    axis = axis % x.dim()
    out = F.batch_norm(x.movedim(axis, 1), moving_mean, moving_var, gamma,
                       beta, training=False, eps=eps)
    return out.movedim(1, axis)


def layer_norm(x, gamma, beta, axis=-1, eps=1e-5):
    """Layer norm over ``axis`` in the promoted dtype of x and gamma: a
    bf16 input with float32 gains gives float32, as in the JAX package."""
    dt = torch.promote_types(x.dtype, gamma.dtype)
    xm = x.to(dt).movedim(axis, -1)
    out = F.layer_norm(xm, (xm.shape[-1],), gamma.to(dt), beta.to(dt), eps)
    return out.movedim(-1, axis)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """``x * rsqrt(mean(x_f32^2) + eps).to(x.dtype) * gamma`` -- the JAX
    rounding order: the statistic in float32, the scaling in x's dtype."""
    var = x.float().square().mean(dim=axis, keepdim=True)
    out = x * torch.rsqrt(var + eps).to(x.dtype)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return out * gamma.reshape(shape)


def _normalize(x, dims, eps):
    var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def group_norm(x, gamma, beta, num_groups, eps=1e-5):
    """Group norm over channel axis 1 in groups of C / num_groups."""
    n, c = x.shape[:2]
    xr = x.reshape((n, num_groups, c // num_groups) + x.shape[2:])
    out = _normalize(xr, tuple(range(2, xr.dim())), eps).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


def instance_norm(x, gamma, beta, eps=1e-5):
    """Instance norm over the spatial axes of an NC+spatial input."""
    out = _normalize(x, tuple(range(2, x.dim())), eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


# ----------------------------------------------------------------------
# softmax family / activations
# ----------------------------------------------------------------------
def log_softmax(x, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return F.log_softmax(x, dim=axis)


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def leaky_relu(x, act_type="leaky", slope=0.25, gamma=None,
               lower_bound=0.125, upper_bound=0.334):
    """MXNet LeakyReLU.  ``prelu`` multiplies negatives by ``gamma``
    broadcast against x's trailing axes (the JAX function's numpy
    broadcast); ``rrelu`` uses the mean of its slope bounds, its
    inference form (the training form's random slopes are not ported:
    no layer of the port uses it)."""
    if act_type == "leaky":
        return F.leaky_relu(x, slope)
    if act_type == "prelu":
        return torch.where(x >= 0, x, gamma * x)
    if act_type == "elu":
        return torch.where(x >= 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(x >= 0, x,
                                         _SELU_ALPHA * torch.expm1(x))
    if act_type == "gelu":
        return F.gelu(x)
    if act_type == "rrelu":
        return torch.where(x >= 0, x, (lower_bound + upper_bound) / 2 * x)
    raise ValueError("unknown leaky_relu act_type %r" % act_type)


_ACTIVATIONS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "log_sigmoid": F.logsigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
    "mish": F.mish,
    "silu": F.silu,
    "swish": F.silu,
    "gelu": F.gelu,                                   # erf, MXNet's default
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def activation(x, act_type):
    """MXNet Activation: relu, sigmoid, log_sigmoid, tanh, softrelu,
    softsign, mish, silu / swish, gelu (erf) and gelu_tanh."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise ValueError("unknown activation %r" % act_type)
    return fn(x)


def dropout(x, p=0.5, generator=None, axes=None):
    """Training-mode dropout with inverted scaling: each element is kept
    with probability 1 - p and scaled by 1 / (1 - p).  With ``axes`` the
    mask varies only along those axes and is shared along the others
    (the JAX function's rule).  The mask is drawn on x's device from
    ``generator`` (the device's default generator when None)."""
    if p <= 0.0:
        return x
    shape = list(x.shape)
    if axes:
        shape = [d if ax in axes else 1 for ax, d in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


# ----------------------------------------------------------------------
# embedding / indexing / attention
# ----------------------------------------------------------------------
def embedding(indices, weight):
    return weight[indices.long()]


def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """``x`` at ``index`` along ``axis``; an index out of range is
    clipped (``mode="clip"``) or wrapped (``"wrap"``)."""
    n = x.shape[axis]
    index = index.long()
    index = index.clamp(0, n - 1) if mode == "clip" else index % n
    picked = torch.gather(x, axis, index.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)


def dot_product_attention(q, k, v, mask=None, scale=None, causal=False):
    """(B, H, T, D) attention with a float32 softmax; the causal mask is
    aligned to the last key (``tril(k=Tk-Tq)``) as in the JAX function;
    ``mask`` (broadcast against the (B, H, Tq, Tk) scores) keeps the
    pairs where it is nonzero."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = q.shape[-2], k.shape[-2]
        cmask = torch.ones(Tq, Tk, dtype=torch.bool,
                           device=q.device).tril(Tk - Tq)
        scores = scores.masked_fill(~cmask, float("-inf"))
    if mask is not None:
        scores = scores.masked_fill(~mask.bool(), float("-inf"))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)
