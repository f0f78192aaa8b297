"""``mx.np.linalg`` and ``mx.np.fft`` of the port against the JAX
package's, on the same numpy inputs (the port under ``with mx.cpu():``).

Tolerances: values that are not factors (``inv``, ``det``, ``solve``,
``lstsq``'s four outputs, norms, eigenvalues and singular values, ...)
at rtol 1e-4 / atol 1e-5 of the reference's; factors (``qr``, ``svd``,
``eigh``, ``eig``), whose columns LAPACK and XLA may sign or phase
differently, by their reconstruction and invariants, within 1e-4; the
FFTs, float32 elementwise, at rtol 1e-5 / atol 1e-5 of max|ref|; the
frequency grids exactly; dtypes equal.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-4, 1e-5
rng = onp.random.RandomState(0)
A = rng.randn(4, 4).astype(onp.float32)
S = (A @ A.T + 4 * onp.eye(4)).astype(onp.float32)
T = rng.randn(5, 3).astype(onp.float32)
BATCH = rng.randn(2, 3, 3).astype(onp.float32)
VEC = rng.randn(4).astype(onp.float32)
MAT = rng.randn(4, 2).astype(onp.float32)
RANKY = onp.array([[1, 2, 3], [2, 4, 6], [1, 0, 1]], onp.float32)
INTS = onp.array([[2, 1], [1, 3]], onp.int32)
T4 = rng.randn(2, 3, 6).astype(onp.float32)


def _both(fn):
    """fn(np) through both packages -> (port result, reference result)."""
    with jmx.cpu():
        want = fn(jmx.np)
    with tmx.cpu():
        got = fn(tmx.np)
    return got, want


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return onp.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _host(got), _host(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rtol, atol)
        return
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    onp.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


VALUES = {
    "inv": lambda np: np.linalg.inv(np.array(S)),
    "inv_batch": lambda np: np.linalg.inv(np.array(BATCH)),
    "inv_int": lambda np: np.linalg.inv(np.array(INTS)),
    "det": lambda np: np.linalg.det(np.array(A)),
    "det_batch": lambda np: np.linalg.det(np.array(BATCH)),
    "cholesky": lambda np: np.linalg.cholesky(np.array(S)),
    "pinv": lambda np: np.linalg.pinv(np.array(T)),
    "pinv_rank_deficient": lambda np: np.linalg.pinv(np.array(RANKY)),
    "pinv_hermitian": lambda np: np.linalg.pinv(np.array(S), hermitian=True),
    "matrix_rank": lambda np: np.linalg.matrix_rank(np.array(RANKY)),
    "matrix_rank_full": lambda np: np.linalg.matrix_rank(np.array(A)),
    "matrix_rank_tol": lambda np: np.linalg.matrix_rank(np.array(A),
                                                        tol=0.5),
    "matrix_rank_vector": lambda np: np.linalg.matrix_rank(np.array(VEC)),
    "slogdet": lambda np: np.linalg.slogdet(np.array(A)),
    "slogdet_batch": lambda np: np.linalg.slogdet(np.array(BATCH)),
    "solve_vector": lambda np: np.linalg.solve(np.array(S), np.array(VEC)),
    "solve_matrix": lambda np: np.linalg.solve(np.array(S), np.array(MAT)),
    "lstsq_vector": lambda np: np.linalg.lstsq(np.array(T),
                                               np.array(T[:, 0] + 1)),
    "lstsq_matrix": lambda np: np.linalg.lstsq(np.array(A), np.array(MAT)),
    "lstsq_rank_deficient": lambda np: np.linalg.lstsq(
        np.array(RANKY), np.array(onp.ones(3, onp.float32))),
    "lstsq_rcond": lambda np: np.linalg.lstsq(np.array(T),
                                              np.array(T[:, :2]), rcond=0.1),
    "eigvalsh": lambda np: np.linalg.eigvalsh(np.array(S)),
    "svd_values": lambda np: np.linalg.svd(np.array(T), compute_uv=False),
    "svd_values_batch": lambda np: np.linalg.svd(np.array(BATCH),
                                                 compute_uv=False),
    "tensorinv": lambda np: np.linalg.tensorinv(
        np.array((S @ S).reshape(4, 2, 2)), ind=1),
    "tensorsolve": lambda np: np.linalg.tensorsolve(
        np.array(S.reshape(2, 2, 4)), np.array(MAT.reshape(2, 4)[:, :2])),
    "matrix_power": lambda np: np.linalg.matrix_power(np.array(A), 3),
    "matrix_power_neg": lambda np: np.linalg.matrix_power(np.array(S), -2),
    "multi_dot": lambda np: np.linalg.multi_dot(
        [np.array(A), np.array(S), np.array(MAT)]),
    "multi_dot_vectors": lambda np: np.linalg.multi_dot(
        [np.array(VEC), np.array(S), np.array(VEC)]),
    "cond": lambda np: np.linalg.cond(np.array(S)),
    "cond_fro": lambda np: np.linalg.cond(np.array(S), p="fro"),
    "norm": lambda np: np.linalg.norm(np.array(A)),
    "norm_int": lambda np: np.linalg.norm(np.array(INTS)),
    "norm_fro": lambda np: np.linalg.norm(np.array(A), ord="fro"),
    "norm_nuc": lambda np: np.linalg.norm(np.array(A), ord="nuc"),
    "norm_2": lambda np: np.linalg.norm(np.array(A), ord=2),
    "norm_inf_axis": lambda np: np.linalg.norm(np.array(A), ord=onp.inf,
                                               axis=1),
    "norm_1_keepdims": lambda np: np.linalg.norm(np.array(T4), ord=1,
                                                 axis=-1, keepdims=True),
    "norm_axes_pair": lambda np: np.linalg.norm(np.array(T4), axis=(1, 2)),
}


@pytest.mark.parametrize("case", sorted(VALUES))
def test_linalg_values(case):
    got, want = _both(VALUES[case])
    _close(got, want)


def _recon(u, s, vh):
    return (u * s[..., None, :]) @ vh


def _orth(q):
    n = q.shape[-1]
    return onp.abs(onp.swapaxes(q, -1, -2).conj() @ q - onp.eye(n)).max()


@pytest.mark.parametrize("x", [A, T, BATCH], ids=["square", "tall",
                                                  "batch"])
@pytest.mark.parametrize("full", [False, True])
def test_svd_by_reconstruction(x, full):
    got, want = _both(lambda np: np.linalg.svd(np.array(x),
                                               full_matrices=full))
    u, s, vh = _host(got)
    _close(got[1], want[1])
    assert [a.shape for a in (u, s, vh)] == [w.shape for w in _host(want)]
    k = s.shape[-1]
    assert onp.abs(_recon(u[..., :k], s, vh[..., :k, :]) - x).max() < RTOL
    assert _orth(u) < RTOL and _orth(onp.swapaxes(vh, -1, -2)) < RTOL


@pytest.mark.parametrize("x", [A, T, onp.ascontiguousarray(T.T), BATCH],
                         ids=["square", "tall", "wide", "batch"])
@pytest.mark.parametrize("mode", ["reduced", "complete"])
def test_qr_by_reconstruction(x, mode):
    got, want = _both(lambda np: np.linalg.qr(np.array(x), mode=mode))
    q, r = _host(got)
    wq, wr = _host(want)
    assert q.shape == wq.shape and r.shape == wr.shape
    assert onp.abs(q @ r - x).max() < RTOL
    assert _orth(q) < RTOL
    assert onp.abs(onp.tril(r, -1)).max() == 0
    k = min(x.shape[-2:])
    onp.testing.assert_allclose(
        onp.abs(onp.diagonal(r, axis1=-2, axis2=-1))[..., :k],
        onp.abs(onp.diagonal(wr, axis1=-2, axis2=-1))[..., :k], rtol=RTOL,
        atol=ATOL)


def test_qr_r_mode():
    # the reference's mode="r" unpacks R's rows as outputs; the port
    # returns R, held against the reference's reduced R
    got, _ = _both(lambda np: np.linalg.qr(np.array(A), mode="r"))
    _, want = _both(lambda np: np.linalg.qr(np.array(A)))
    onp.testing.assert_allclose(onp.abs(_host(got)), onp.abs(_host(want[1])),
                                rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("x", [S, A, BATCH], ids=["spd", "nonsymmetric",
                                                 "batch"])
def test_eigh_symmetrizes_and_reconstructs(x):
    got, want = _both(lambda np: np.linalg.eigh(np.array(x), UPLO="U"))
    w, v = _host(got)
    _close(got[0], want[0])
    sym = (x + onp.swapaxes(x, -1, -2)) / 2
    assert onp.abs(sym @ v - v * w[..., None, :]).max() < RTOL * 10
    assert _orth(v) < RTOL


def test_eig_and_eigvals():
    got, want = _both(lambda np: np.linalg.eig(np.array(A)))
    w, v = _host(got)
    ww = _host(want)[0]
    assert w.dtype == ww.dtype == onp.complex64
    onp.testing.assert_allclose(onp.sort_complex(w), onp.sort_complex(ww),
                                rtol=RTOL, atol=ATOL)
    assert onp.abs(A @ v - v * w[None, :]).max() < RTOL * 10
    got, want = _both(lambda np: np.linalg.eigvals(np.array(A)))
    onp.testing.assert_allclose(onp.sort_complex(_host(got)),
                                onp.sort_complex(_host(want)), rtol=RTOL,
                                atol=ATOL)


# -- fft -----------------------------------------------------------------
X = rng.randn(3, 4, 8).astype(onp.float32)
XC = (rng.randn(4, 6) + 1j * rng.randn(4, 6)).astype(onp.complex64)
FFTS = {
    "fft": lambda np: np.fft.fft(np.array(X)),
    "fft_n_axis": lambda np: np.fft.fft(np.array(X), n=5, axis=1),
    "fft_ortho": lambda np: np.fft.fft(np.array(X), norm="ortho"),
    "fft_int": lambda np: np.fft.fft(np.array(INTS)),
    "ifft": lambda np: np.fft.ifft(np.array(XC)),
    "fft2": lambda np: np.fft.fft2(np.array(X)),
    "fft2_s_axes": lambda np: np.fft.fft2(np.array(X), s=(3, 6),
                                          axes=(0, 2)),
    "ifft2": lambda np: np.fft.ifft2(np.array(XC)),
    "fftn": lambda np: np.fft.fftn(np.array(X)),
    "fftn_axes": lambda np: np.fft.fftn(np.array(X), axes=(0, 1)),
    "ifftn": lambda np: np.fft.ifftn(np.array(XC)),
    "rfft": lambda np: np.fft.rfft(np.array(X)),
    "rfft_n": lambda np: np.fft.rfft(np.array(X), n=6, axis=0),
    "irfft": lambda np: np.fft.irfft(np.array(XC)),
    "irfft_n": lambda np: np.fft.irfft(np.array(XC), n=7),
    "rfft2": lambda np: np.fft.rfft2(np.array(X)),
    "irfft2": lambda np: np.fft.irfft2(np.array(XC)),
    "irfft2_s": lambda np: np.fft.irfft2(np.array(XC), s=(4, 9)),
    "rfftn": lambda np: np.fft.rfftn(np.array(X)),
    "irfftn": lambda np: np.fft.irfftn(np.array(XC)),
    "hfft": lambda np: np.fft.hfft(np.array(XC)),
    "ihfft": lambda np: np.fft.ihfft(np.array(X)),
    "fftshift": lambda np: np.fft.fftshift(np.array(X)),
    "fftshift_axes": lambda np: np.fft.fftshift(np.array(X), axes=(1,)),
    "ifftshift": lambda np: np.fft.ifftshift(np.array(X)),
}


@pytest.mark.parametrize("case", sorted(FFTS))
def test_fft_values(case):
    got, want = _both(FFTS[case])
    w = _host(want)
    _close(got, want, rtol=1e-5, atol=1e-5 * max(onp.abs(w).max(), 1.0))


def test_fft_round_trips_and_narrowing():
    x64 = rng.randn(4, 6)
    with tmx.cpu():
        spec = tmx.np.fft.rfft2(tmx.np.array(x64, dtype="float64"))
        back = tmx.np.fft.irfft2(spec, s=(4, 6))
        full = tmx.np.fft.ifftn(tmx.np.fft.fftn(tmx.np.array(X)))
    assert spec.dtype == onp.complex64 and back.dtype == onp.float32
    onp.testing.assert_allclose(back.asnumpy(), x64, rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(full.asnumpy().real, X, atol=1e-5)


@pytest.mark.parametrize("fn,n,d", [("fftfreq", 8, 1.0), ("fftfreq", 7, 0.5),
                                    ("rfftfreq", 8, 0.1),
                                    ("rfftfreq", 9, 2.0)])
def test_fftfreq_values(fn, n, d):
    with jmx.cpu():
        want = onp.asarray(getattr(jmx.np.fft, fn)(n, d))
    with tmx.cpu():
        got = getattr(tmx.np.fft, fn)(n, d)
    assert isinstance(got, tmx.nd.NDArray)
    assert got.dtype == want.dtype == onp.float32
    onp.testing.assert_array_equal(got.asnumpy(), want)


def test_namespaces_have_the_references_names():
    for sub in ("linalg", "fft"):
        ref = {n for n in dir(getattr(jmx.np, sub)) if not n.startswith("_")}
        ref -= {"jnp", "jax", "apply_op"}
        assert ref <= set(dir(getattr(tmx.np, sub))), \
            ref - set(dir(getattr(tmx.np, sub)))
    assert hasattr(tmx.np, "current_context")
