"""``mx.np.fft`` over ``torch.fft`` (cuFFT on the card).

Counterpart of ``mxnet_tpu/numpy/fft.py``, ``jnp.fft``'s signatures
(``axis`` / ``axes`` for torch's ``dim``).  With 64-bit types off, as in
the JAX package, a transform computes in complex64: float64 and integer
inputs go in as float32, complex128 as complex64.  ``fftfreq`` /
``rfftfreq`` are the bare ``jnp`` functions in the reference; here they
return an NDArray of the same float32 values on the current context.
"""
from __future__ import annotations

import torch

from ..context import resolve_device
from ..ndarray.ndarray import NDArray, apply_op, to_torch_dtype

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "rfft", "irfft",
           "rfft2", "irfft2", "rfftn", "irfftn", "hfft", "ihfft",
           "fftshift", "ifftshift", "fftfreq", "rfftfreq"]


def _narrow(x):
    if x.is_complex():
        return x.to(torch.complex64)
    return x.to(torch.float32)


def _one(tfn, name):
    def f(a, n=None, axis=-1, norm=None):
        return apply_op(lambda x: tfn(_narrow(x), n=n, dim=axis,
                                      norm=norm).resolve_conj(), [a], name)
    f.__name__ = name
    return f


def _many(tfn, name, default_axes):
    def f(a, s=None, axes=default_axes, norm=None):
        return apply_op(lambda x: tfn(_narrow(x), s=s, dim=axes, norm=norm),
                        [a], name)
    f.__name__ = name
    return f


fft = _one(torch.fft.fft, "fft")
ifft = _one(torch.fft.ifft, "ifft")
rfft = _one(torch.fft.rfft, "rfft")
irfft = _one(torch.fft.irfft, "irfft")
hfft = _one(torch.fft.hfft, "hfft")
ihfft = _one(torch.fft.ihfft, "ihfft")
fft2 = _many(torch.fft.fft2, "fft2", (-2, -1))
ifft2 = _many(torch.fft.ifft2, "ifft2", (-2, -1))
rfft2 = _many(torch.fft.rfft2, "rfft2", (-2, -1))
irfft2 = _many(torch.fft.irfft2, "irfft2", (-2, -1))
fftn = _many(torch.fft.fftn, "fftn", None)
ifftn = _many(torch.fft.ifftn, "ifftn", None)
rfftn = _many(torch.fft.rfftn, "rfftn", None)
irfftn = _many(torch.fft.irfftn, "irfftn", None)


def fftshift(x, axes=None):
    return apply_op(lambda a: torch.fft.fftshift(a, dim=axes), [x],
                    "fftshift")


def ifftshift(x, axes=None):
    return apply_op(lambda a: torch.fft.ifftshift(a, dim=axes), [x],
                    "ifftshift")


def _freq_dtype(dtype):
    return to_torch_dtype(dtype) or torch.float32


def fftfreq(n, d=1.0, dtype=None, device=None):
    """Sample frequencies of an ``n``-point transform (float32 unless
    ``dtype`` says otherwise), computed as ``jnp.fft.fftfreq`` does."""
    dt = _freq_dtype(dtype)
    dev = resolve_device(device)
    i = torch.arange(n, dtype=dt, device=dev)
    k = (i + n // 2).remainder(n) - n // 2
    return NDArray(k / torch.tensor(d * n, dtype=dt, device=dev))


def rfftfreq(n, d=1.0, dtype=None, device=None):
    dt = _freq_dtype(dtype)
    dev = resolve_device(device)
    k = torch.arange(0, n // 2 + 1, dtype=dt, device=dev)
    return NDArray(k / torch.tensor(d * n, dtype=dt, device=dev))
