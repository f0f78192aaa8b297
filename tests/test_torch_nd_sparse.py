"""``mx.nd.sparse`` of the port against the JAX package's, and the sparse
seams: ``NDArray.tostype``, ``nd.cast_storage`` / ``sparse.retain``,
array files with ``row_sparse`` / ``csr`` / bf16 entries written by one
package and read by the other, ``io.LibSVMIter``'s batches and
``kvstore.row_sparse_pull`` by a CSR batch's indices.

Each case runs the same numpy inputs through both packages (the port
under ``with mx.cpu():``) and compares the dense values, the storage
type and the structure (``indices``, ``indptr``, ``data``): structure
and integer values exactly, float32 values at rtol 1e-5 / atol 1e-6.
"""
import numpy as onp
import pytest
import scipy.sparse as sps

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6


def _csr_parts(shape=(6, 9), density=0.3, seed=0):
    m = sps.random(*shape, density=density, format="csr",
                   random_state=onp.random.RandomState(seed),
                   dtype="float32")
    return m


def _csr(mx, m):
    return mx.nd.sparse.csr_matrix((m.data, m.indices, m.indptr),
                                   shape=m.shape)


RS_VALS = onp.random.RandomState(1).randn(3, 4).astype(onp.float32)
RS_ROWS = onp.array([0, 2, 5], onp.int32)
RS_VALS2 = onp.random.RandomState(2).randn(3, 4).astype(onp.float32)
RS_ROWS2 = onp.array([1, 2, 6], onp.int32)


def _rs(mx, vals=RS_VALS, rows=RS_ROWS):
    return mx.nd.sparse.row_sparse_array(
        (mx.nd.array(vals), mx.nd.array(rows)), shape=(7, 4))


def _tostype(mx, arr, stype):
    """``arr.tostype(stype)`` in the port; the reference's NDArray has no
    ``tostype``, its spelling is ``cast_storage``."""
    if mx is tmx:
        return arr.tostype(stype)
    return mx.nd.cast_storage(arr, stype)


def _both(fn):
    with jmx.cpu():
        want = fn(jmx)
    with tmx.cpu():
        got = fn(tmx)
    return got, want


def _check(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _check(g, w)
        return
    st = getattr(want, "stype", "default")
    assert getattr(got, "stype", "default") == st
    g, w = got.asnumpy(), want.asnumpy()
    assert g.shape == w.shape and str(g.dtype) == str(w.dtype)
    onp.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    if st == "csr":
        for part in ("indices", "indptr", "data"):
            onp.testing.assert_allclose(getattr(got, part).asnumpy(),
                                        getattr(want, part).asnumpy(),
                                        rtol=RTOL, atol=ATOL)
    elif st == "row_sparse":
        for part in ("indices", "data"):
            onp.testing.assert_allclose(getattr(got, part).asnumpy(),
                                        getattr(want, part).asnumpy(),
                                        rtol=RTOL, atol=ATOL)


A, B = _csr_parts(seed=2), _csr_parts(seed=3)
WITH_ZERO = sps.csr_matrix((onp.array([0.0, 2.0, 3.0], onp.float32),
                            onp.array([0, 2, 1]), onp.array([0, 2, 2, 3])),
                           shape=(3, 4))
DENSE = onp.random.RandomState(4).randn(5, 3).astype(onp.float32) * \
    (onp.arange(5) % 2)[:, None].astype(onp.float32)

CASES = {
    "csr_from_parts": lambda mx: _csr(mx, A),
    "csr_explicit_zero_kept": lambda mx: _csr(mx, WITH_ZERO),
    "csr_from_dense": lambda mx: mx.nd.sparse.csr_matrix(A.toarray()),
    "csr_from_scipy": lambda mx: mx.nd.sparse.array(A),
    "rs_from_parts": lambda mx: _rs(mx),
    "rs_from_dense": lambda mx: mx.nd.sparse.row_sparse_array(DENSE),
    "csr_add": lambda mx: _csr(mx, A) + _csr(mx, B),
    "csr_sub": lambda mx: _csr(mx, A) - _csr(mx, B),
    "csr_mul": lambda mx: _csr(mx, A) * _csr(mx, B),
    "rs_add": lambda mx: _rs(mx) + _rs(mx, RS_VALS2, RS_ROWS2),
    "rs_sub": lambda mx: _rs(mx) - _rs(mx, RS_VALS2, RS_ROWS2),
    "rs_mul": lambda mx: _rs(mx) * _rs(mx, RS_VALS2, RS_ROWS2),
    "csr_times_scalar": lambda mx: _csr(mx, A) * 3.0,
    "scalar_times_csr": lambda mx: 3.0 * _csr(mx, A),
    "csr_times_zero_keeps_structure": lambda mx: _csr(mx, A) * 0.0,
    "csr_div_scalar": lambda mx: _csr(mx, A) / 2.0,
    "csr_neg": lambda mx: -_csr(mx, A),
    "rs_times_scalar": lambda mx: _rs(mx) * 2,
    "csr_plus_scalar_densifies": lambda mx: _csr(mx, A) + 2.0,
    "scalar_plus_csr_densifies": lambda mx: 2.0 + _csr(mx, A),
    "csr_minus_scalar_densifies": lambda mx: _csr(mx, A) - 1.0,
    "scalar_div_csr_densifies": lambda mx: 2.0 / (_csr(mx, A) + 1.0),
    "csr_plus_dense_densifies": lambda mx: _csr(mx, A) + mx.nd.ones(A.shape),
    "csr_row_slice": lambda mx: _csr(mx, A)[2:5],
    "csr_empty_slice": lambda mx: _csr(mx, A)[4:4],
    "csr_row_index_dense": lambda mx: _csr(mx, A)[1],
    "tostype_csr": lambda mx: _tostype(mx, mx.nd.array(A.toarray()), "csr"),
    "tostype_rs": lambda mx: _tostype(mx, mx.nd.array(DENSE), "row_sparse"),
    "tostype_default": lambda mx: _csr(mx, A).tostype("default"),
    "tostype_csr_to_rs": lambda mx: _csr(mx, A).tostype("row_sparse"),
    "cast_storage_csr": lambda mx: mx.nd.cast_storage(
        mx.nd.array(A.toarray()), "csr"),
    "cast_storage_rs": lambda mx: mx.nd.cast_storage(mx.nd.array(DENSE),
                                                     "row_sparse"),
    "cast_storage_default": lambda mx: mx.nd.cast_storage(_rs(mx),
                                                          "default"),
    "zeros_csr": lambda mx: mx.nd.sparse.zeros("csr", (3, 4)),
    "zeros_rs": lambda mx: mx.nd.sparse.zeros("row_sparse", (3, 4),
                                              dtype="float16"),
    "zeros_like": lambda mx: _rs(mx).zeros_like(),
    "dot": lambda mx: mx.nd.sparse.dot(_csr(mx, A), mx.nd.array(
        onp.ones((9, 2), onp.float32))),
    "dot_transpose_a": lambda mx: mx.nd.sparse.dot(
        _csr(mx, A), mx.nd.array(onp.arange(12, dtype=onp.float32)
                                 .reshape(6, 2)), transpose_a=True),
    "retain": lambda mx: _rs(mx).retain(mx.nd.array([0, 5])),
    "retain_module": lambda mx: mx.nd.sparse.retain(_rs(mx),
                                                    mx.nd.array([2])),
    "retain_dense": lambda mx: mx.nd.sparse.retain(mx.nd.array(DENSE),
                                                   mx.nd.array([1, 3])),
    "asdense": lambda mx: _rs(mx).asdense(),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_case(case):
    got, want = _both(CASES[case])
    _check(got, want)


def test_asscipy_and_explicit_zeros():
    got, want = _both(lambda mx: _csr(mx, WITH_ZERO))
    g, w = got.asscipy(), want.asscipy()
    assert g.nnz == w.nnz == 3
    for part in ("data", "indices", "indptr"):
        onp.testing.assert_array_equal(getattr(g, part), getattr(w, part))


@pytest.mark.parametrize("full", [True, False])
def test_check_format(full):
    with tmx.cpu():
        _csr(tmx, A).check_format(full)
        _rs(tmx).check_format(full)
        bad = _rs(tmx)
        bad._aux["indices"] = bad._aux["indices"].flip(0)
        with pytest.raises(ValueError, match="sorted"):
            bad.check_format(full)
        c = _csr(tmx, A)
        c._aux["indices"] = c._aux["indices"] * 0 + 9
        with pytest.raises(ValueError, match="out of bounds"):
            c.check_format(full)
        dup = tmx.nd.sparse.csr_matrix(
            (onp.ones(2, onp.float32), onp.array([1, 1]),
             onp.array([0, 2, 2])), shape=(2, 3))
        if full:
            with pytest.raises(ValueError, match="unique"):
                dup.check_format(True)
        else:
            dup.check_format(False)


def test_sparse_arithmetic_keeps_autograd():
    res = {}
    for mx in (jmx, tmx):
        with mx.cpu():
            w = _rs(mx)
            w.attach_grad()
            with mx.autograd.record():
                loss = (w * 2.0 + w * w).asdense().sum()
            loss.backward()
            res[mx] = w.grad.asnumpy()
    onp.testing.assert_allclose(res[tmx], res[jmx], rtol=RTOL)


def test_copyto_sparse_destination_refreshes_structure():
    with tmx.cpu():
        dst = tmx.nd.sparse.row_sparse_array(onp.eye(7, 4, dtype=onp.float32))
        assert dst.indices.asnumpy().tolist() == [0, 1, 2, 3]
        _rs(tmx).copyto(dst)
        assert dst.indices.asnumpy().tolist() == [0, 2, 5]


# -- array files across the packages ---------------------------------------
BF16 = onp.random.RandomState(5).randn(3, 5).astype(onp.float32)


def _entries(mx):
    return {"csr": _csr(mx, A), "rs": _rs(mx),
            "bf16": mx.nd.array(BF16).astype("bfloat16"),
            "dense": mx.nd.array(DENSE),
            "ints": mx.nd.array(onp.arange(6, dtype=onp.int32))}


@pytest.mark.parametrize("writer,reader", [(jmx, tmx), (tmx, jmx),
                                           (tmx, tmx)],
                         ids=["jax_to_port", "port_to_jax", "port_to_port"])
@pytest.mark.parametrize("container", ["dict", "list"])
def test_save_load_crosses_packages(tmp_path, writer, reader, container):
    path = str(tmp_path / "arrays.params")
    with writer.cpu():
        src = _entries(writer)
        writer.nd.save(path, src if container == "dict"
                       else list(src.values()))
        want = {k: (getattr(v, "stype", "default"), v.asnumpy(),
                    str(v.dtype)) for k, v in src.items()}
    with reader.cpu():
        back = reader.nd.load(path)
    if container == "list":
        assert isinstance(back, list)
        back = dict(zip(want, back))
    assert set(back) == set(want)
    for k, (st, vals, dt) in want.items():
        assert getattr(back[k], "stype", "default") == st, k
        assert str(back[k].dtype).replace("torch.", "") == \
            dt.replace("torch.", ""), k
        onp.testing.assert_array_equal(back[k].asnumpy(), vals)
        if st == "csr":
            onp.testing.assert_array_equal(back[k].indptr.asnumpy(),
                                           A.indptr)


# -- LibSVMIter --------------------------------------------------------------
LIBSVM = ("1 0:1.5 3:2.0\n"
          "0 1:1.0\n"
          "1 2:0.5 3:-1.0 5:3.0\n"
          "0 0:2.0 5:1.0\n"
          "1 4:1.0\n")


@pytest.mark.parametrize("batch,round_batch", [(2, True), (2, False),
                                               (5, True), (3, True)])
def test_libsvm_iter_batches_as_the_reference(tmp_path, batch, round_batch):
    path = tmp_path / "x.libsvm"
    path.write_text(LIBSVM)

    def run(mx):
        it = mx.io.LibSVMIter(str(path), (6,), batch_size=batch,
                              round_batch=round_batch)
        out = []
        for _ in range(2):
            it.reset()
            out += [(b.data[0], b.label[0], b.pad) for b in it]
        return out
    got, want = _both(run)
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        _check(gd, wd)
        onp.testing.assert_array_equal(gl.asnumpy(), wl.asnumpy())


def test_libsvm_iter_label_file(tmp_path):
    (tmp_path / "d.libsvm").write_text("0:1 2:2\n1:3\n")
    (tmp_path / "l.txt").write_text("1 0\n0 1\n")

    def run(mx):
        it = mx.io.LibSVMIter(str(tmp_path / "d.libsvm"), (3,),
                              label_libsvm=str(tmp_path / "l.txt"),
                              label_shape=(2,), batch_size=2)
        b = it.next()
        return b.data[0], b.label[0]
    got, want = _both(run)
    _check(got[0], want[0])
    onp.testing.assert_array_equal(got[1].asnumpy(), want[1].asnumpy())


# -- kvstore row_sparse_pull -------------------------------------------
@pytest.mark.parametrize("ids", ["csr_indices", "row_sparse", "array"])
def test_row_sparse_pull_by_batch_indices(ids):
    w0 = onp.arange(24, dtype=onp.float32).reshape(6, 4)
    grad = onp.zeros((6, 4), onp.float32)
    grad[[1, 4]] = 1.0

    def run(mx):
        kv = mx.kv.create("local")
        kv.init("w", mx.nd.array(w0))
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                                          lazy_update=True))
        kv.push("w", _tostype(mx, mx.nd.array(grad), "row_sparse"))
        csr = mx.nd.sparse.csr_matrix(onp.array(
            [[0, 1, 0, 0, 1, 0], [0, 1, 0, 0, 0, 0]], onp.float32))
        row_ids = {"csr_indices": csr.indices,
                   "row_sparse": _tostype(mx, mx.nd.array(grad),
                                          "row_sparse"),
                   "array": mx.nd.array([1, 4])}[ids]
        if ids == "row_sparse" and mx is jmx:
            row_ids = row_ids.indices       # the reference reads ids
        out = mx.nd.zeros((6, 4))
        kv.row_sparse_pull("w", out=out, row_ids=row_ids)
        return out
    got, want = _both(run)
    _check(got, want)
    g = got.asnumpy()
    assert not g[[0, 2, 3, 5]].any() and g[[1, 4]].any()
