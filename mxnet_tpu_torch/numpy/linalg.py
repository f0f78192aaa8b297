"""``mx.np.linalg`` over ``torch.linalg`` (cuSOLVER / cuBLAS on the card,
LAPACK on the CPU).

Counterpart of ``mxnet_tpu/numpy/linalg.py``: the same 19 functions,
with ``jnp.linalg``'s conventions where they differ from torch's:

* an integer or bool input computes in float32 (64-bit types off);
* ``eigh`` symmetrizes its input, ``(a + a^H) / 2``, and ignores
  ``UPLO`` (``jnp.linalg.eigh(symmetrize_input=True)``, reference
  :73-77); torch's reads one triangle;
* on CUDA, ``svd`` / ``lstsq`` / ``pinv`` ask cuSOLVER for ``gesvd``
  and float32 ``eigh`` of 32-512 rows computes in float64 (:func:`_svd`,
  :func:`_eigh`): torch's defaults there, the Jacobi solvers, stop at a
  tolerance far above float32's rounding;
* ``lstsq`` returns ``(x, resid, rank, s)`` from one SVD, as
  ``jnp.linalg.lstsq`` computes them (``rcond="warn"`` or None: eps
  times the larger dimension; ``resid`` always the column sums of the
  squared residual), since torch's CUDA driver (``gels``) returns no rank
  and no singular values;
* ``pinv``'s default cut-off is ``10 * max(M, N) * eps`` and
  ``matrix_rank``'s ``max(M, N) * eps``, relative to the largest
  singular value, as ``jnp``'s;
* ``eig`` / ``eigvals`` go through torch's ``linalg.eig``, which on CUDA
  synchronizes with the host (MAGMA / cuSOLVER ``geev``); a build
  without that backend raises, naming it.

Factors (``qr``, ``svd``, ``eigh``, ``eig``) may differ from XLA's in
the sign or phase of a column; their products do not.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import NDArray, apply_op  # noqa: F401

__all__ = ["norm", "inv", "pinv", "det", "cholesky", "matrix_rank",
           "eigvals", "eigvalsh", "slogdet", "svd", "eig", "eigh", "qr",
           "solve", "lstsq", "tensorinv", "tensorsolve", "matrix_power",
           "multi_dot", "cond"]


def _inexact(x):
    """Integer and bool tensors as float32 (``promote_dtypes_inexact``
    with 64-bit types off)."""
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _eps(x):
    return torch.finfo(x.real.dtype if x.is_complex() else x.dtype).eps


def _wrap1(fn, name):
    def f(a):
        return apply_op(lambda x: fn(_inexact(x)), [a], name)
    f.__name__ = name
    f.__doc__ = "mx.np.linalg.%s (``jnp.linalg.%s``)" % (name, name)
    return f


inv = _wrap1(torch.linalg.inv, "inv")
det = _wrap1(torch.linalg.det, "det")
cholesky = _wrap1(torch.linalg.cholesky, "cholesky")


def eigvalsh(a, UPLO="L"):
    return apply_op(lambda x: torch.linalg.eigvalsh(_sym(_inexact(x))), [a],
                    "eigvalsh")


def _geev(fn, x):
    """``torch.linalg.eig`` / ``eigvals``; a CUDA build without a
    ``geev`` backend raises, naming it."""
    try:
        return fn(_inexact(x))
    except RuntimeError as e:
        if x.device.type == "cuda":
            raise RuntimeError(
                "mx.np.linalg.eig on CUDA needs torch's MAGMA or cuSOLVER "
                "geev backend, which this build lacks: %s" % e) from e
        raise


def eigvals(a):
    return apply_op(lambda x: _geev(torch.linalg.eigvals, x), [a], "eigvals")


def eig(a):
    """(w, v): eigenvalues and right eigenvectors, complex."""
    return tuple(apply_op(lambda x: tuple(_geev(torch.linalg.eig, x)), [a],
                          "eig"))


def norm(x, ord=None, axis=None, keepdims=False):  # noqa: A002
    return apply_op(lambda a: torch.linalg.norm(_inexact(a), ord=ord,
                                                dim=axis, keepdim=keepdims),
                    [x], "norm")


def pinv(a, rtol=None, hermitian=False, rcond=None):
    """``jnp.linalg.pinv``'s algorithm: singular values at or under
    ``rtol`` (default ``10 * max(M, N) * eps``) times the largest are
    dropped; the SVD is :func:`_svd`'s (a Hermitian input's from
    ``eigh``)."""
    if rcond is not None:
        rtol = rcond

    def g(x):
        x = _inexact(x)
        tol = rtol if rtol is not None else \
            10.0 * max(x.shape[-2:]) * _eps(x)
        if hermitian:
            w, v = _eigh(x)
            s = w.abs()
            cut = tol * s.amax(-1, keepdim=True)
            inv = torch.where(s > cut, 1 / torch.where(s > cut, w,
                                                       torch.ones_like(w)),
                              torch.zeros_like(w))
            return (v * inv[..., None, :]) @ v.mH
        u, s, vh = _svd(x.conj())
        s = torch.where(s > tol * s[..., 0:1], s, torch.full_like(s, float(
            "inf"))).to(u.dtype)
        return vh.mT @ (u.mT / s[..., None])
    return apply_op(g, [a], "pinv")


def matrix_rank(M, rtol=None, tol=None):
    if tol is not None:
        rtol = tol

    def g(x):
        x = _inexact(x)
        if x.dim() < 2:
            return (x != 0).any().to(torch.int32)
        s = torch.linalg.svdvals(x)
        if rtol is None:      # jnp's default, relative to the largest
            cut = s.amax(-1, keepdim=True) * (max(x.shape[-2:]) * _eps(x))
        else:                 # jnp reads a given rtol as absolute
            cut = torch.as_tensor(rtol, dtype=s.dtype,
                                  device=s.device)[..., None]
        return (s > cut).sum(-1).to(torch.int32)
    return apply_op(g, [M], "matrix_rank")


def slogdet(a):
    return tuple(apply_op(lambda x: tuple(torch.linalg.slogdet(_inexact(x))),
                          [a], "slogdet"))


def _svd(x, full_matrices=False):
    """``torch.linalg.svd``; on CUDA through cuSOLVER's ``gesvd`` (QR
    iteration, converged to working precision): torch's default there,
    the Jacobi ``gesvdj``, stops at a tolerance that left ``U S V^H``
    1e-3 away from a 4096 x 4096 float32 input."""
    driver = "gesvd" if x.is_cuda else None
    return torch.linalg.svd(x, full_matrices=full_matrices, driver=driver)


def svd(a, full_matrices=False, compute_uv=True):
    """numpy's ``(u, s, vh)`` (the reference follows ``mx.np``, not
    ``_npi_svd``'s ``(UT, L, V)``)."""
    if not compute_uv:
        return apply_op(lambda x: torch.linalg.svdvals(_inexact(x)), [a],
                        "svd")
    return tuple(apply_op(lambda x: tuple(_svd(
        _inexact(x), full_matrices)), [a], "svd"))


def _sym(x):
    return (x + x.mH) / 2


def _eigh(x):
    """``torch.linalg.eigh`` of ``x``; a float32 matrix of 32 to 512 rows
    on CUDA goes through float64 and back: torch sends those to
    cuSOLVER's Jacobi ``syevj``, whose float32 eigenvectors of a 256 x
    256 SPD matrix reconstructed it only to 1.8e-4, where the
    divide-and-conquer ``syevd`` (float64 here, float32 above 512 rows)
    reaches ~1e-6."""
    if x.is_cuda and x.dtype == torch.float32 and 32 <= x.shape[-1] <= 512:
        w, v = torch.linalg.eigh(x.double())
        return w.float(), v.float()
    return torch.linalg.eigh(x)


def eigh(a, UPLO="L"):
    """(w, v) of the symmetrized input; ``UPLO`` is ignored, as in the
    reference."""
    return tuple(apply_op(lambda x: tuple(_eigh(_sym(_inexact(x)))), [a],
                          "eigh"))


def qr(a, mode="reduced"):
    """(q, r) for ``"reduced"`` / ``"complete"``; r alone for ``"r"``."""
    if mode == "r":
        return apply_op(lambda x: torch.linalg.qr(_inexact(x), mode="r")[1],
                        [a], "qr")
    return tuple(apply_op(lambda x: tuple(torch.linalg.qr(_inexact(x),
                                                          mode=mode)),
                          [a], "qr"))


def solve(a, b):
    def g(x, y):
        x, y = _inexact(x), _inexact(y)
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
        if y.dim() == 1:                  # "(m,m),(m)->(m)"
            return torch.linalg.solve(x, y[..., None])[..., 0]
        return torch.linalg.solve(x, y)
    return apply_op(g, [a, b], "solve")


def lstsq(a, b, rcond="warn"):
    """(x, resid, rank, s) by one SVD, as ``jnp.linalg.lstsq``: singular
    values under ``rcond * s[0]`` (default eps * max(M, N)) count as zero,
    and ``resid`` is ``|b - a x|^2`` by column (shape (K,), (1,) for a
    vector ``b``)."""
    rc = None if rcond == "warn" else rcond

    def g(x, y):
        x, y = _inexact(x), _inexact(y)
        dt = torch.promote_types(x.dtype, y.dtype)
        x, y = x.to(dt), y.to(dt)
        vec = y.dim() == 1
        if vec:
            y = y[:, None]
        m, n = x.shape
        cut = _eps(x) * max(m, n) if rc is None else \
            (_eps(x) if rc < 0 else rc)
        u, s, vh = _svd(x)
        mask = (s > 0) & (s >= cut * s[0])
        rank = mask.sum().to(torch.int32)
        s_inv = torch.where(mask, 1 / torch.where(mask, s, torch.ones_like(s)),
                            torch.zeros_like(s))[:, None]
        sol = vh.mH @ (s_inv * (u.mH @ y))
        resid = torch.linalg.vector_norm(y - x @ sol, dim=0) ** 2
        return (sol.reshape(-1) if vec else sol), resid, rank, s
    return tuple(apply_op(g, [a, b], "lstsq"))


def tensorinv(a, ind=2):
    return apply_op(lambda x: torch.linalg.tensorinv(_inexact(x), ind=ind),
                    [a], "tensorinv")


def tensorsolve(a, b, axes=None):
    return apply_op(lambda x, y: torch.linalg.tensorsolve(
        _inexact(x), _inexact(y), dims=axes), [a, b], "tensorsolve")


def matrix_power(a, n):
    return apply_op(lambda x: torch.linalg.matrix_power(x, n), [a],
                    "matrix_power")


def multi_dot(arrays):
    return apply_op(lambda *xs: torch.linalg.multi_dot(list(xs)),
                    list(arrays), "multi_dot")


def cond(x, p=None):
    return apply_op(lambda a: torch.linalg.cond(_inexact(a), p=p), [x],
                    "cond")
