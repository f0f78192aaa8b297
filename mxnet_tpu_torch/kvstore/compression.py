"""Gradient compression: 2-bit / 1-bit quantization with error feedback.

Counterpart of ``mxnet_tpu/kvstore/compression.py`` (the reference's
``gradient_compression.cc:85-127``), bit for bit: the residual
accumulates the gradient in float32; 2-bit emits ``+threshold`` (code
3) where it reaches ``threshold``, ``-threshold`` (code 2) where it
reaches ``-threshold``, else 0, and keeps the rest (error feedback),
four codes a byte, most significant first; 1-bit emits +1 where the
residual reaches ``threshold`` and -1 elsewhere, eight bits a byte.
Plain tensor ops, on the gradient's device.
"""
from __future__ import annotations

import torch

__all__ = ["GradientCompression"]

_W2 = (64, 16, 4, 1)
_W1 = (128, 64, 32, 16, 8, 4, 2, 1)


def _pack(codes, weights):
    """Codes (uint8, flat) packed ``len(weights)`` a byte."""
    per = len(weights)
    pad = (-codes.numel()) % per
    codes = torch.cat([codes, codes.new_zeros(pad)]).reshape(-1, per)
    w = torch.tensor(weights, dtype=torch.uint8, device=codes.device)
    return (codes * w).sum(1, dtype=torch.uint8)


def _unpack(packed, bits, size):
    """The codes of ``bits`` bits packed by :func:`_pack`, the first
    ``size`` of them."""
    shifts = torch.tensor(list(range(8 - bits, -1, -bits)),
                          dtype=torch.uint8, device=packed.device)
    codes = (packed[:, None] >> shifts[None, :]) & ((1 << bits) - 1)
    return codes.reshape(-1)[:size]


def _quantize_2bit(grad, residual, threshold):
    r = residual + grad.to(torch.float32)
    pos = r >= threshold
    neg = r <= -threshold
    new_res = r - threshold * pos.to(torch.float32) \
        + threshold * neg.to(torch.float32)
    code = torch.where(pos, 3, torch.where(neg, 2, 0)).to(torch.uint8)
    return _pack(code.reshape(-1), _W2), new_res


def _dequantize_2bit(packed, threshold, size):
    codes = _unpack(packed, 2, size)
    return torch.where(codes == 3, threshold,
                       torch.where(codes == 2, -threshold, 0.0)) \
        .to(torch.float32)


def _quantize_1bit(grad, residual, threshold):
    r = residual + grad.to(torch.float32)
    pos = r >= threshold
    q = torch.where(pos, 1.0, -1.0)
    new_res = r - q
    return _pack(pos.to(torch.uint8).reshape(-1), _W1), new_res


def _dequantize_1bit(packed, size):
    bits = _unpack(packed, 1, size)
    return torch.where(bits == 1, 1.0, -1.0).to(torch.float32)


class GradientCompression:
    """Per-key error-feedback state and the quantize / dequantize
    pair."""

    def __init__(self, params):
        params = dict(params or {})
        self.type = params.get("type", "2bit")
        if self.type not in ("2bit", "1bit"):
            raise ValueError("compression type must be '1bit' or '2bit', "
                             "got %r" % self.type)
        self.threshold = float(params.get("threshold", 0.5))
        self._residuals = {}

    def get_compression_factor(self):
        return 16 if self.type == "2bit" else 32

    def compressed_nbytes(self, size):
        vals_per_byte = 4 if self.type == "2bit" else 8
        return (size + vals_per_byte - 1) // vals_per_byte

    def compress(self, key, grad):
        """grad -> packed uint8 codes; updates the key's residual."""
        res = self._residuals.get(key)
        if res is None or res.shape != grad.shape:
            res = torch.zeros(grad.shape, dtype=torch.float32,
                              device=grad.device)
        if self.type == "2bit":
            packed, new_res = _quantize_2bit(grad, res, self.threshold)
        else:
            packed, new_res = _quantize_1bit(grad, res, self.threshold)
        self._residuals[key] = new_res
        return packed

    def decompress(self, packed, shape):
        size = 1
        for s in shape:
            size *= int(s)
        if self.type == "2bit":
            flat = _dequantize_2bit(packed, self.threshold, size)
        else:
            flat = _dequantize_1bit(packed, size)
        return flat.reshape(tuple(shape))

    def roundtrip(self, key, grad):
        """What the server dequantizes after this worker's push."""
        return self.decompress(self.compress(key, grad), grad.shape)
