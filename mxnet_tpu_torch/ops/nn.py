"""Plain PyTorch counterparts of the ``mxnet_tpu/ops/nn.py`` functions
the Llama serving and training paths call (``dense`` :38, ``rms_norm``
:262, ``log_softmax`` :322, ``activation`` :374, ``embedding`` :399,
``pick`` :409, ``dot_product_attention`` :467).  The model's
projections, FFN and logits stay library matmuls, as the JAX package
leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["dense", "rms_norm", "log_softmax", "activation", "embedding",
           "pick", "dot_product_attention"]


def dense(x, weight, bias=None):
    """Gluon Dense on the trailing dim: ``y = x @ W.T + b`` with W shaped
    (out, in) as in MXNet."""
    return F.linear(x, weight, bias)


def rms_norm(x, gamma, axis=-1, eps=1e-6):
    """``x * rsqrt(mean(x_f32^2) + eps).to(x.dtype) * gamma`` -- the JAX
    rounding order: the statistic in float32, the scaling in x's dtype."""
    var = x.float().square().mean(dim=axis, keepdim=True)
    out = x * torch.rsqrt(var + eps).to(x.dtype)
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return out * gamma.reshape(shape)


def log_softmax(x, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return F.log_softmax(x, dim=axis)


def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """``x`` at ``index`` along ``axis``; an index out of range is
    clipped (``mode="clip"``) or wrapped (``"wrap"``)."""
    n = x.shape[axis]
    index = index.long()
    index = index.clamp(0, n - 1) if mode == "clip" else index % n
    picked = torch.gather(x, axis, index.unsqueeze(axis))
    return picked if keepdims else picked.squeeze(axis)


def activation(x, act_type):
    """The activations the Llama blocks use (``silu``, alias ``swish``)."""
    if act_type in ("silu", "swish"):
        return F.silu(x)
    raise ValueError("unknown activation %r" % act_type)


def embedding(indices, weight):
    return weight[indices.long()]


def dot_product_attention(q, k, v, scale=None, causal=False):
    """(B, H, T, D) attention with a float32 softmax; the causal mask is
    aligned to the last key (``tril(k=Tk-Tq)``) as in the JAX function."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = q.shape[-2], k.shape[-2]
        cmask = torch.ones(Tq, Tk, dtype=torch.bool,
                           device=q.device).tril(Tk - Tq)
        scores = scores.masked_fill(~cmask, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)
