"""``mx.nd.sparse``: the row_sparse and CSR storage types over dense
tensors.

Counterpart of ``mxnet_tpu/ndarray/sparse.py``, with its design (DELTAS.md
#2): a sparse array holds its dense values on the device, and its
structure (row ``indices``; CSR ``indices`` / ``indptr``) is derived from
them lazily, when first read, or kept from the constructor that was
given it.  The derivation runs on the array's device (``torch.nonzero``,
row-major, which is CSR order) and synchronizes with the host once, as
any data-dependent shape does; the reference scans on the host (scipy),
with the same result.  Compressed storage on the card is a later design
question (ROADMAP).

Arithmetic keeps the reference's storage rules (``_rewrap``): same-stype
add / sub / mul stay sparse (structure derived again), a sparse array
times or divided by a scalar keeps its stype and its structure (even
times 0), and anything with a dense array, or a scalar added, is dense.
A sparse array shares its tensor with the result of the op that made it,
so autograd flows through sparse math as through its dense twin.
``CSRNDArray.data`` reads the values through the stored structure, so an
explicit zero that a constructor was given stays an entry.
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..context import resolve_device
from .ndarray import NDArray, apply_op, as_tensor, to_torch_dtype

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "zeros", "array", "dot",
           "retain"]


def _t(x, device=None, dtype=None):
    if isinstance(x, NDArray):
        x = x._data
    return as_tensor(x, dtype, device)


def _host(t):
    return t.detach().cpu().numpy()


class BaseSparseNDArray(NDArray):
    __slots__ = ("_stype_name", "_aux")

    @property
    def stype(self):
        return self._stype_name

    def asdense(self):
        return NDArray(self._data)

    def tostype(self, stype):
        if stype == "default":
            return self.asdense()
        if stype == self._stype_name:
            return self
        return _from_dense(NDArray(self._data), stype)

    def copyto(self, other):
        out = NDArray.copyto(self, other)
        if isinstance(other, BaseSparseNDArray):
            other._aux = None        # the structure follows the new values
        return out

    def zeros_like(self):
        return zeros(self._stype_name, self.shape, ctx=self._data.device,
                     dtype=self.dtype)

    # the reference's FInferStorageType rules
    # (elemwise_binary_op_basic.cc): see the module docstring
    def _rewrap(self, other, result, op):
        if not isinstance(result, NDArray) or result.shape != self.shape:
            return result
        same = isinstance(other, BaseSparseNDArray) and \
            other._stype_name == self._stype_name
        scalar = not isinstance(other, NDArray) and (
            _onp.isscalar(other) or getattr(other, "ndim", None) == 0)
        if same and op in ("add", "sub", "mul"):
            return _wrap(result, self._stype_name)
        if scalar and op in ("mul", "div"):
            return _wrap(result, self._stype_name, aux=self._aux)
        return result

    def __add__(self, other):
        return self._rewrap(other, NDArray.__add__(self, other), "add")

    def __sub__(self, other):
        return self._rewrap(other, NDArray.__sub__(self, other), "sub")

    def __mul__(self, other):
        return self._rewrap(other, NDArray.__mul__(self, other), "mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._rewrap(other, NDArray.__truediv__(self, other), "div")

    def __neg__(self):
        return _wrap(NDArray.__neg__(self), self._stype_name, aux=self._aux)
    # reflected add / sub / div stay dense (the base class's): a scalar
    # added densifies, and scalar / sparse turns the zeros into inf


def _rows_of(dense):
    """The indices of the rows that hold a nonzero (NaN counts)."""
    flat = dense.reshape(dense.shape[0], -1) if dense.dim() else dense
    return torch.nonzero((flat != 0).any(1)).reshape(-1).to(torch.int32)


class RowSparseNDArray(BaseSparseNDArray):
    """A row_sparse view of dense values: ``indices`` are the rows that
    hold a nonzero, ``data`` those rows."""

    def __init__(self, data, indices=None, shape=None, ctx=None):
        if indices is None:                      # from dense, lazily
            NDArray.__init__(self, data if isinstance(data, NDArray)
                             else _t(data, ctx))
            self._aux = None
        else:
            dev = data._data.device if isinstance(data, NDArray) else \
                resolve_device(ctx)
            vals = _t(data, dev)
            idx = _t(indices, dev).long()
            full = tuple(shape) if shape is not None else \
                (int(idx.max()) + 1,) + tuple(vals.shape[1:])
            dense = torch.zeros(full, dtype=vals.dtype, device=dev)
            dense[idx] = vals
            NDArray.__init__(self, dense)
            self._aux = {"indices": idx.to(torch.int32)}
        self._stype_name = "row_sparse"

    def _ensure_aux(self):
        if self._aux is None:
            self._aux = {"indices": _rows_of(self._data.detach())}
        return self._aux

    @property
    def indices(self):
        return NDArray(self._ensure_aux()["indices"])

    @property
    def data(self):
        return NDArray(self._data[self._ensure_aux()["indices"].long()])

    def check_format(self, full_check=True):
        """Indices strictly ascending and inside the rows (reference
        ``CheckFormatWrapper``); raises ``ValueError``."""
        idx = _host(self._ensure_aux()["indices"])
        if idx.size:
            if idx.min() < 0 or idx.max() >= self.shape[0]:
                raise ValueError("row_sparse indices out of bounds")
            if not (_onp.diff(idx) > 0).all():
                raise ValueError("row_sparse indices must be sorted "
                                 "and unique")

    def retain(self, rows):
        """Only the given rows kept, the others zero (``sparse_retain``)."""
        idx = _t(rows, self._data.device).long()
        mask = torch.zeros(self.shape[0], dtype=torch.bool,
                           device=self._data.device)
        mask[idx] = True
        out = apply_op(lambda x: torch.where(
            mask.reshape((-1,) + (1,) * (x.dim() - 1)), x,
            torch.zeros((), dtype=x.dtype, device=x.device)), [self],
            "retain")
        return _wrap(out, "row_sparse", aux={"indices": idx.to(torch.int32)})


class CSRNDArray(BaseSparseNDArray):
    """A CSR view of dense (rows, cols) values."""

    def __init__(self, arg1, shape=None, ctx=None, dtype=None):
        if isinstance(arg1, tuple) and len(arg1) == 3:
            data, indices, indptr = arg1
            dev = resolve_device(ctx)
            vals = _t(data, dev, dtype)
            cols = _t(indices, dev).long()
            ptr = _t(indptr, dev).long()
            n_rows = ptr.numel() - 1
            n_cols = shape[1] if shape else int(cols.max()) + 1
            rows = torch.repeat_interleave(
                torch.arange(n_rows, device=dev), ptr.diff())
            dense = torch.zeros((n_rows, n_cols), dtype=vals.dtype,
                                device=dev)
            dense[rows, cols] = vals
            NDArray.__init__(self, dense)
            self._aux = {"indices": cols.to(torch.int32),
                         "indptr": ptr.to(torch.int32)}
        else:
            NDArray.__init__(self, arg1 if isinstance(arg1, NDArray)
                             else _t(arg1, ctx, dtype))
            self._aux = None
        self._stype_name = "csr"

    def _ensure_aux(self):
        if self._aux is None:
            nz = torch.nonzero(self._data.detach() != 0)   # row-major
            counts = torch.bincount(nz[:, 0], minlength=self.shape[0])
            indptr = torch.zeros(self.shape[0] + 1, dtype=torch.int32,
                                 device=self._data.device)
            indptr[1:] = counts.cumsum(0)
            self._aux = {"indices": nz[:, 1].to(torch.int32),
                         "indptr": indptr}
        return self._aux

    @property
    def indices(self):
        return NDArray(self._ensure_aux()["indices"])

    @property
    def indptr(self):
        return NDArray(self._ensure_aux()["indptr"])

    def _entry_rows(self):
        aux = self._ensure_aux()
        ptr = aux["indptr"].long()
        return torch.repeat_interleave(
            torch.arange(ptr.numel() - 1, device=ptr.device), ptr.diff())

    @property
    def data(self):
        """The values at the stored structure's entries (an explicit zero
        the constructor was given included)."""
        return NDArray(self._data[self._entry_rows(),
                                  self._ensure_aux()["indices"].long()])

    def asscipy(self):
        """A ``scipy.sparse.csr_matrix`` with this array's structure."""
        import scipy.sparse as sps
        aux = self._ensure_aux()
        return sps.csr_matrix((self.data.asnumpy(), _host(aux["indices"]),
                               _host(aux["indptr"])), shape=self.shape)

    def check_format(self, full_check=True):
        """indptr from 0 to nnz, never decreasing; indices inside the
        columns; with ``full_check`` also ascending without duplicates
        within each row.  Raises ``ValueError``."""
        aux = self._ensure_aux()
        indptr, indices = _host(aux["indptr"]), _host(aux["indices"])
        if indptr.size != self.shape[0] + 1 or indptr[0] != 0:
            raise ValueError("csr indptr must be (rows+1,) starting at 0")
        if (_onp.diff(indptr) < 0).any():
            raise ValueError("csr indptr must be non-decreasing")
        if indptr[-1] != indices.size:
            raise ValueError("csr indptr[-1] != nnz")
        if indices.size and (indices.min() < 0 or
                             indices.max() >= self.shape[1]):
            raise ValueError("csr indices out of bounds")
        if full_check and indices.size:
            d = _onp.diff(indices)
            boundary = _onp.zeros(len(indices) - 1, bool)
            inner = indptr[1:-1]
            boundary[inner[(inner > 0) & (inner < len(indices))] - 1] = True
            if (d[~boundary] <= 0).any():
                raise ValueError("csr indices must be sorted and unique "
                                 "within each row")

    def __getitem__(self, key):
        """A slice of rows (step 1) stays CSR; any other key indexes the
        dense values."""
        if isinstance(key, slice) and key.step in (None, 1):
            rows = range(*key.indices(self.shape[0]))
            start, stop = (rows.start, rows.stop) if len(rows) else (0, 0)
            return _wrap(NDArray(self._data[start:stop]), "csr")
        return NDArray.__getitem__(self, key)


def _wrap(nd, stype, aux=None):
    """``nd``'s tensor as a sparse view, its structure ``aux`` (None:
    derived when read)."""
    cls = RowSparseNDArray if stype == "row_sparse" else CSRNDArray
    out = cls.__new__(cls)
    NDArray.__init__(out, nd._data)
    out._stype_name = stype
    out._aux = aux
    return out


def _from_dense(nd, stype):
    if stype == "row_sparse":
        return RowSparseNDArray(nd)
    if stype == "csr":
        return CSRNDArray(nd)
    raise ValueError("unknown stype %s" % stype)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """From ``(data, indices)`` (rows of ``shape``) or dense values."""
    if isinstance(arg1, tuple) and len(arg1) == 2:
        return RowSparseNDArray(arg1[0], indices=arg1[1], shape=shape,
                                ctx=ctx)
    return RowSparseNDArray(NDArray(_t(arg1, ctx, dtype)))


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """From ``(data, indices, indptr)`` or dense values."""
    return CSRNDArray(arg1, shape=shape, ctx=ctx, dtype=dtype)


def zeros(stype, shape, ctx=None, dtype=None):
    dense = NDArray(torch.zeros(shape, dtype=to_torch_dtype(dtype or
                                                            "float32"),
                                device=resolve_device(ctx)))
    return dense if stype == "default" else _from_dense(dense, stype)


def array(source_array, ctx=None, dtype=None):
    """A sparse array as is, or a scipy sparse matrix as a CSRNDArray."""
    if isinstance(source_array, BaseSparseNDArray):
        return source_array
    import scipy.sparse as sps
    if sps.issparse(source_array):
        return CSRNDArray(NDArray(_t(source_array.toarray(), ctx, dtype)))
    raise ValueError("array expects a scipy sparse matrix or sparse NDArray")


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """The product of the dense values (``torch.matmul``; the reference's
    is ``jnp.matmul``)."""
    return apply_op(lambda a, b: torch.matmul(a.T if transpose_a else a,
                                              b.T if transpose_b else b),
                    [lhs, rhs], "sparse_dot")


def retain(data, indices):
    """The listed rows kept, the others zero, as a RowSparseNDArray
    (``sparse_retain.cc``)."""
    if hasattr(data, "retain"):
        return data.retain(indices)
    arr = data._data if isinstance(data, NDArray) else _t(data)
    idx = _t(indices, arr.device).long()
    mask = torch.zeros(arr.shape[0], dtype=arr.dtype, device=arr.device)
    mask[idx] = 1
    return RowSparseNDArray(NDArray(
        arr * mask.reshape((-1,) + (1,) * (arr.dim() - 1))))
