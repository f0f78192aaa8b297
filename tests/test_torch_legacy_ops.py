"""The legacy ``mx.nd`` op namespace of the port against the JAX
package's (``mxnet_tpu/ndarray/legacy_ops.py``), on the same numpy
inputs (the port under ``with mx.cpu():``), and the namespace itself.

Tolerances: integer, bool, shape and data-movement ops exactly; float32
arithmetic at rtol 1e-5 / atol 1e-6; the ``linalg_*`` factorizations
(``potrf`` is unique, ``syevd`` / ``gelqf`` are not) by reconstruction
and invariants within 1e-4; dtypes equal.  Gradients of
``FullyConnected``, ``Convolution``, ``BatchNorm`` (batch statistics),
``SoftmaxOutput``, ``make_loss`` and ``BlockGrad`` are held against
JAX's at the same tolerance.  The random ops are held to their
properties (shape, dtype, range, mean): the two packages cannot draw
the same numbers.
"""
import os
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

RTOL, ATOL = 1e-5, 1e-6
rng = onp.random.RandomState(0)
X4 = rng.randn(2, 3, 4, 5).astype(onp.float32)
X3 = rng.randn(2, 3, 4).astype(onp.float32)
M = rng.randn(3, 4).astype(onp.float32)
N = rng.randn(4, 2).astype(onp.float32)
V = rng.randn(4).astype(onp.float32)
POS = (onp.abs(rng.randn(3, 4)) + 0.5).astype(onp.float32)
I3 = onp.array([[1, 5, 2], [4, 4, 0]], onp.int32)
TIES = onp.array([[3, 1, 3, 2, 1], [0, 0, 5, 5, 1]], onp.float32)
IMG = rng.randn(1, 2, 5, 5).astype(onp.float32)
W33 = rng.randn(3, 2, 3, 3).astype(onp.float32)
BIAS = rng.randn(3).astype(onp.float32)
FC_X = rng.randn(2, 6).astype(onp.float32)
FC_W = rng.randn(3, 6).astype(onp.float32)
SEQ = rng.randn(4, 2, 3).astype(onp.float32)
LENS = onp.array([2, 4], onp.float32)
S = (M @ M.T + 3 * onp.eye(3)).astype(onp.float32)
L = onp.linalg.cholesky(S).astype(onp.float32)
B34 = rng.randn(3, 4).astype(onp.float32)
GAMMA = (rng.rand(2) + 0.5).astype(onp.float32)
BETA = rng.randn(2).astype(onp.float32)
RMEAN = rng.randn(2).astype(onp.float32)
RVAR = (rng.rand(2) + 0.5).astype(onp.float32)


def _a(nd, x, dtype=None):
    return nd.array(x, dtype=dtype) if dtype else nd.array(x)


def _both(fn):
    with jmx.cpu():
        want = fn(jmx.nd)
    with tmx.cpu():
        got = fn(tmx.nd)
    return got, want


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return onp.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _dtype(x):
    return str(getattr(x, "dtype", onp.asarray(x).dtype)).replace(
        "torch.", "")


def _same(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rtol, atol)
        return
    assert _dtype(got) == _dtype(want), (_dtype(got), _dtype(want))
    g, w = _host(got), _host(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if onp.issubdtype(w.dtype, onp.floating):
        onp.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    else:
        onp.testing.assert_array_equal(g, w)


CASES = {
    # layers
    "FullyConnected": lambda nd: nd.FullyConnected(
        _a(nd, FC_X), _a(nd, FC_W), _a(nd, BIAS), num_hidden=3),
    "FullyConnected_no_bias": lambda nd: nd.FullyConnected(
        _a(nd, X3), _a(nd, rng_w((3, 12))), None, num_hidden=3,
        no_bias=True),
    "Convolution": lambda nd: nd.Convolution(
        _a(nd, IMG), _a(nd, W33), _a(nd, BIAS), kernel=(3, 3), pad=(1, 1),
        num_filter=3),
    "Convolution_stride": lambda nd: nd.Convolution(
        _a(nd, IMG), _a(nd, W33), None, kernel=(3, 3), stride=(2, 2),
        num_filter=3, no_bias=True),
    "Deconvolution": lambda nd: nd.Deconvolution(
        _a(nd, IMG), _a(nd, rng_w((2, 3, 3, 3))), _a(nd, BIAS),
        kernel=(3, 3), stride=(2, 2), num_filter=3),
    "Activation_relu": lambda nd: nd.Activation(_a(nd, X3), act_type="relu"),
    "Activation_sigmoid": lambda nd: nd.Activation(_a(nd, X3),
                                                   act_type="sigmoid"),
    "Activation_tanh": lambda nd: nd.Activation(_a(nd, X3), act_type="tanh"),
    "Activation_softrelu": lambda nd: nd.Activation(_a(nd, X3),
                                                    act_type="softrelu"),
    "Activation_softsign": lambda nd: nd.Activation(_a(nd, X3),
                                                    act_type="softsign"),
    "BatchNorm_global": lambda nd: nd.BatchNorm(
        _a(nd, IMG), _a(nd, GAMMA), _a(nd, BETA), _a(nd, RMEAN),
        _a(nd, RVAR), use_global_stats=True),
    "BatchNorm_fix_gamma": lambda nd: nd.BatchNorm(
        _a(nd, IMG), _a(nd, GAMMA), _a(nd, BETA), _a(nd, RMEAN),
        _a(nd, RVAR), fix_gamma=True, use_global_stats=True),
    "Pooling_max": lambda nd: nd.Pooling(_a(nd, IMG), kernel=(2, 2),
                                         stride=(2, 2), pool_type="max"),
    "Pooling_avg_pad": lambda nd: nd.Pooling(
        _a(nd, IMG), kernel=(3, 3), stride=(2, 2), pad=(1, 1),
        pool_type="avg"),
    "Pooling_global": lambda nd: nd.Pooling(_a(nd, IMG), global_pool=True,
                                            pool_type="avg"),
    "Embedding": lambda nd: nd.Embedding(_a(nd, I3), _a(nd, rng_w((6, 3))),
                                         input_dim=6, output_dim=3),
    "LeakyReLU": lambda nd: nd.LeakyReLU(_a(nd, X3), slope=0.1),
    "LeakyReLU_elu": lambda nd: nd.LeakyReLU(_a(nd, X3), act_type="elu",
                                             slope=0.3),
    "softmax": lambda nd: nd.softmax(_a(nd, X3), axis=1),
    "log_softmax": lambda nd: nd.log_softmax(_a(nd, X3)),
    "SoftmaxOutput": lambda nd: nd.SoftmaxOutput(_a(nd, M), _a(nd, V[:3])),
    "SoftmaxOutput_multi": lambda nd: nd.SoftmaxOutput(
        _a(nd, X3), None, multi_output=True),
    "SoftmaxActivation": lambda nd: nd.SoftmaxActivation(_a(nd, M)),
    "LayerNorm": lambda nd: nd.LayerNorm(_a(nd, X3), _a(nd, V),
                                         _a(nd, V * 0 + 0.5)),
    "InstanceNorm": lambda nd: nd.InstanceNorm(_a(nd, IMG), _a(nd, GAMMA),
                                               _a(nd, BETA)),
    "L2Normalization": lambda nd: nd.L2Normalization(_a(nd, X3)),
    "L2Normalization_channel": lambda nd: nd.L2Normalization(
        _a(nd, IMG), mode="channel"),
    "GroupNorm": lambda nd: nd.GroupNorm(_a(nd, X4), _a(nd, rng_w((3,))),
                                         _a(nd, rng_w((3,))), num_groups=3),
    "Dropout_predict": lambda nd: nd.Dropout(_a(nd, X3), p=0.5),
    "UpSampling_nearest": lambda nd: nd.UpSampling(_a(nd, IMG), scale=2),
    "UpSampling_bilinear": lambda nd: nd.UpSampling(
        _a(nd, IMG), scale=2, sample_type="bilinear"),
    "LRN": lambda nd: nd.LRN(_a(nd, X4), nsize=3),
    "LRN_5": lambda nd: nd.LRN(_a(nd, rng_w((1, 7, 2, 2))), alpha=1e-2,
                               beta=0.5, knorm=1.0),
    "GridGenerator_affine": lambda nd: nd.GridGenerator(
        _a(nd, onp.array([[1.0, 0.2, 0.1, -0.1, 0.9, 0.0]], onp.float32)),
        transform_type="affine", target_shape=(3, 4)),
    "GridGenerator_warp": lambda nd: nd.GridGenerator(
        _a(nd, rng_w((1, 2, 3, 4))), transform_type="warp"),
    "BilinearSampler": lambda nd: nd.BilinearSampler(
        _a(nd, IMG), _a(nd, onp.clip(rng_w((1, 2, 4, 3)), -1.2, 1.2))),
    "SpatialTransformer": lambda nd: nd.SpatialTransformer(
        _a(nd, IMG), _a(nd, onp.array([[0.8, 0.1, 0.05, -0.1, 0.9, 0.1]],
                                      onp.float32)), target_shape=(4, 4)),
    "ROIPooling": lambda nd: nd.ROIPooling(
        _a(nd, IMG), _a(nd, onp.array([[0, 0, 0, 3, 3], [0, 1, 1, 4, 2]],
                                      onp.float32)), (2, 2), 1.0),
    "Correlation": lambda nd: nd.Correlation(
        _a(nd, IMG), _a(nd, IMG[:, ::-1].copy()), max_displacement=1,
        pad_size=1),
    "Correlation_abs": lambda nd: nd.Correlation(
        _a(nd, IMG), _a(nd, IMG * 0.5), max_displacement=2, pad_size=2,
        stride2=2, is_multiply=False),
    "SequenceMask": lambda nd: nd.SequenceMask(
        _a(nd, SEQ), _a(nd, LENS), use_sequence_length=True, value=-1.0),
    "SequenceLast": lambda nd: nd.SequenceLast(_a(nd, SEQ)),
    "SequenceLast_lens": lambda nd: nd.SequenceLast(
        _a(nd, SEQ), _a(nd, LENS), use_sequence_length=True),
    "SequenceReverse": lambda nd: nd.SequenceReverse(_a(nd, SEQ)),
    "SequenceReverse_lens": lambda nd: nd.SequenceReverse(
        _a(nd, SEQ), _a(nd, LENS), use_sequence_length=True),
    "softmax_cross_entropy": lambda nd: nd.softmax_cross_entropy(
        _a(nd, M), _a(nd, onp.array([1, 0, 3], onp.float32))),
    "moments": lambda nd: nd.moments(_a(nd, X4), axes=(0, 2)),
    "moments_keepdims": lambda nd: nd.moments(_a(nd, X3), axes=1,
                                              keepdims=True),
    "softmin": lambda nd: nd.softmin(_a(nd, X3)),
    "softmin_temperature": lambda nd: nd.softmin(_a(nd, X3), axis=1,
                                                 temperature=2.0),
    "depth_to_space": lambda nd: nd.depth_to_space(
        _a(nd, rng_w((1, 8, 2, 3))), 2),
    "space_to_depth": lambda nd: nd.space_to_depth(
        _a(nd, rng_w((1, 2, 4, 6))), 2),
    # shapes and data movement
    "reshape_codes_0_-1": lambda nd: nd.reshape(_a(nd, X4), shape=(0, -1)),
    "reshape_codes_-2": lambda nd: nd.reshape(_a(nd, X4), shape=(2, -2)),
    "reshape_codes_-3": lambda nd: nd.reshape(_a(nd, X4), shape=(-3, 0, 0)),
    "reshape_codes_-4": lambda nd: nd.reshape(_a(nd, X4),
                                              shape=(-4, 1, 2, -2)),
    "reshape_codes_-4_infer": lambda nd: nd.reshape(
        _a(nd, X4), shape=(0, -4, -1, 1, 0, 0)),
    "reshape_plain": lambda nd: nd.reshape(_a(nd, X4), shape=(6, -1)),
    "Reshape_reverse": lambda nd: nd.Reshape(_a(nd, X4), shape=(0, 0, -1),
                                             reverse=True),
    "flatten": lambda nd: nd.flatten(_a(nd, X4)),
    "Flatten": lambda nd: nd.Flatten(_a(nd, X3)),
    "transpose": lambda nd: nd.transpose(_a(nd, X4), axes=(3, 1, 0, 2)),
    "transpose_default": lambda nd: nd.transpose(_a(nd, X3)),
    "dot": lambda nd: nd.dot(_a(nd, M), _a(nd, N)),
    "dot_transposed": lambda nd: nd.dot(_a(nd, N), _a(nd, M),
                                        transpose_a=True, transpose_b=True),
    "dot_3d": lambda nd: nd.dot(_a(nd, X3), _a(nd, N)),
    "dot_vector": lambda nd: nd.dot(_a(nd, M), _a(nd, V)),
    "batch_dot": lambda nd: nd.batch_dot(_a(nd, X3), _a(nd, X3),
                                         transpose_b=True),
    "batch_dot_ta": lambda nd: nd.batch_dot(_a(nd, X3), _a(nd, X3),
                                            transpose_a=True),
    "concat": lambda nd: nd.concat(_a(nd, X3), _a(nd, X3 * 2), dim=2),
    "Concat_default_dim": lambda nd: nd.Concat(_a(nd, X3), _a(nd, X3)),
    "stack": lambda nd: nd.stack(_a(nd, M), _a(nd, M + 1), axis=1),
    "split": lambda nd: nd.split(_a(nd, X4), num_outputs=3),
    "split_squeeze": lambda nd: nd.split(_a(nd, X4), num_outputs=2, axis=0,
                                         squeeze_axis=True),
    "SliceChannel": lambda nd: nd.SliceChannel(_a(nd, X4), num_outputs=1),
    "split_v2_sections": lambda nd: nd.split_v2(_a(nd, X4), 2),
    "split_v2_indices": lambda nd: nd.split_v2(_a(nd, X4), [1, 3], axis=2),
    "tile": lambda nd: nd.tile(_a(nd, M), (2, 1)),
    "repeat": lambda nd: nd.repeat(_a(nd, M), 2, axis=1),
    "expand_dims": lambda nd: nd.expand_dims(_a(nd, M), 1),
    "squeeze": lambda nd: nd.squeeze(_a(nd, X4[:1])),
    "swapaxes": lambda nd: nd.swapaxes(_a(nd, X4), 1, 3),
    "SwapAxis": lambda nd: nd.SwapAxis(_a(nd, X3)),
    "flip": lambda nd: nd.flip(_a(nd, X3), axis=1),
    "reverse": lambda nd: nd.reverse(_a(nd, X3), axis=2),
    "pad_constant": lambda nd: nd.pad(_a(nd, IMG), pad_width=(
        0, 0, 0, 0, 1, 2, 2, 1), constant_value=0.5),
    "pad_edge": lambda nd: nd.Pad(_a(nd, IMG), mode="edge", pad_width=(
        0, 0, 0, 0, 2, 1, 1, 3)),
    "pad_reflect": lambda nd: nd.pad(_a(nd, IMG), mode="reflect",
                                     pad_width=(0, 0, 0, 0, 2, 2, 1, 3)),
    "cast": lambda nd: nd.cast(_a(nd, X3), "int32"),
    "Cast_f16": lambda nd: nd.Cast(_a(nd, X3), dtype="float16"),
    "amp_cast": lambda nd: nd.amp_cast(_a(nd, X3), "float16"),
    "amp_multicast": lambda nd: nd.amp_multicast(
        _a(nd, X3, "float16"), _a(nd, X3), num_outputs=2),
    "amp_multicast_narrow": lambda nd: nd.amp_multicast(
        _a(nd, X3, "float16"), _a(nd, X3), num_outputs=2, cast_narrow=True),
    "slice": lambda nd: nd.slice(_a(nd, X4), begin=(0, 1), end=(2, 3)),
    "slice_axis": lambda nd: nd.slice_axis(_a(nd, X4), axis=2, begin=1,
                                           end=3),
    "slice_like": lambda nd: nd.slice_like(_a(nd, X4), _a(nd, X3[:, :2])),
    "broadcast_to": lambda nd: nd.broadcast_to(_a(nd, V), shape=(3, 4)),
    "broadcast_like": lambda nd: nd.broadcast_like(_a(nd, V), _a(nd, M)),
    "broadcast_axis": lambda nd: nd.broadcast_axis(
        _a(nd, M[:, :1]), axis=1, size=5),
    "one_hot": lambda nd: nd.one_hot(_a(nd, I3), 6),
    "pick": lambda nd: nd.pick(_a(nd, M), _a(nd, onp.array([0, 3, 1],
                                                           onp.float32))),
    "topk": lambda nd: nd.topk(_a(nd, M), k=2),
    "topk_value": lambda nd: nd.topk(_a(nd, M), k=2, ret_typ="value",
                                     axis=0),
    "gather_nd": lambda nd: nd.gather_nd(_a(nd, M), _a(nd, onp.array(
        [[0, 2], [1, 3]], onp.int32))),
    "scatter_nd": lambda nd: nd.scatter_nd(
        _a(nd, onp.array([2.0, 3.0], onp.float32)),
        _a(nd, onp.array([[0, 1], [1, 2]], onp.int32)), (2, 3)),
    "take_clips": lambda nd: nd.take(_a(nd, M), _a(nd, onp.array(
        [[0, 7], [-3, 2]], onp.float32)), mode="wrap"),
    "take_axis1": lambda nd: nd.take(_a(nd, X3), _a(nd, onp.array(
        [2, 0, 9], onp.int32)), axis=1),
    "batch_take": lambda nd: nd.batch_take(_a(nd, M), _a(nd, onp.array(
        [3, 0, 1], onp.int32))),
    "diag": lambda nd: nd.diag(_a(nd, M), k=1),
    "diag_vector": lambda nd: nd.diag(_a(nd, V)),
    "khatri_rao": lambda nd: nd.khatri_rao(_a(nd, M), _a(nd, B34[:2])),
    "shape_array": lambda nd: nd.shape_array(_a(nd, X3)),
    "size_array": lambda nd: nd.size_array(_a(nd, X3)),
    "zeros_like": lambda nd: nd.zeros_like(_a(nd, I3)),
    "ones_like": lambda nd: nd.ones_like(_a(nd, X3)),
    "linspace": lambda nd: nd.linspace(0, 1, 7),
    "linspace_open": lambda nd: nd.linspace(-2, 3, 5, endpoint=False),
    "eye": lambda nd: nd.eye(3, 4, k=1),
    "full_like": lambda nd: nd.full_like(_a(nd, M), 2.5),
    "make_loss": lambda nd: nd.make_loss(_a(nd, M)),
    "stop_gradient": lambda nd: nd.stop_gradient(_a(nd, M)),
    "BlockGrad": lambda nd: nd.BlockGrad(_a(nd, M)),
    "identity": lambda nd: nd.identity(_a(nd, M)),
    "argmax_channel": lambda nd: nd.argmax_channel(_a(nd, X3)),
    "cast_storage_default": lambda nd: nd.cast_storage(_a(nd, M)),
    # reductions, sorting
    "sum": lambda nd: nd.sum(_a(nd, X4), axis=(1, 3), keepdims=True),
    "mean": lambda nd: nd.mean(_a(nd, X4), axis=2),
    "max": lambda nd: nd.max(_a(nd, X4)),
    "min": lambda nd: nd.min(_a(nd, X4), axis=0),
    "prod": lambda nd: nd.prod(_a(nd, M), axis=1),
    "norm": lambda nd: nd.norm(_a(nd, X4)),
    "norm_ord1_axis": lambda nd: nd.norm(_a(nd, X4), ord=1, axis=1),
    "norm_keepdims": lambda nd: nd.norm(_a(nd, M), axis=1, keepdims=True),
    "norm_keepdims_flat": lambda nd: nd.norm(_a(nd, M), keepdims=True),
    "sort": lambda nd: nd.sort(_a(nd, TIES)),
    "sort_descending_ties": lambda nd: nd.sort(_a(nd, TIES),
                                               is_ascend=False),
    "sort_axis0": lambda nd: nd.sort(_a(nd, TIES), axis=0, is_ascend=False),
    "argsort": lambda nd: nd.argsort(_a(nd, TIES)),
    "argsort_descending_ties": lambda nd: nd.argsort(_a(nd, TIES),
                                                     is_ascend=False),
    "argmax_keepdims_ignored": lambda nd: nd.argmax(_a(nd, M), axis=1,
                                                    keepdims=True),
    "argmin": lambda nd: nd.argmin(_a(nd, M), axis=0),
    "argmax_flat": lambda nd: nd.argmax(_a(nd, TIES)),
    "clip": lambda nd: nd.clip(_a(nd, X3), -0.5, 0.5),
    "where": lambda nd: nd.where(_a(nd, (M > 0).astype(onp.float32)),
                                 _a(nd, M), _a(nd, -M)),
    "add_n": lambda nd: nd.add_n(_a(nd, M), _a(nd, M * 2), _a(nd, POS)),
    "ElementWiseSum_list": lambda nd: nd.add_n([_a(nd, M), _a(nd, POS)]),
    # elementwise
    "erf": lambda nd: nd.erf(_a(nd, X3)),
    "erfinv": lambda nd: nd.erfinv(_a(nd, onp.tanh(X3) * 0.9)),
    "gamma": lambda nd: nd.gamma(_a(nd, POS)),
    "gammaln": lambda nd: nd.gammaln(_a(nd, POS)),
    "smooth_l1": lambda nd: nd.smooth_l1(_a(nd, X3), scalar=2.0),
    "logical_not": lambda nd: nd.logical_not(_a(nd, (M > 0).astype(
        onp.float32))),
    "logical_not_int": lambda nd: nd.logical_not(_a(nd, I3)),
}
for _u in ("sigmoid", "relu", "tanh", "exp", "square", "abs", "sign",
           "round", "ceil", "floor", "rint", "trunc", "negative",
           "reciprocal"):
    CASES[_u] = (lambda name: lambda nd: getattr(nd, name)(
        _a(nd, X3 * 2.5)))(_u)
for _u in ("log", "sqrt"):
    CASES[_u] = (lambda name: lambda nd: getattr(nd, name)(
        _a(nd, POS)))(_u)
CASES["round_halves"] = lambda nd: nd.round(_a(nd, onp.array(
    [0.5, 1.5, 2.5, -0.5, -1.5], onp.float32)))
for _b in ("broadcast_add", "broadcast_sub", "broadcast_mul",
           "broadcast_div", "broadcast_maximum", "broadcast_minimum",
           "broadcast_power", "broadcast_equal", "broadcast_not_equal",
           "broadcast_greater", "broadcast_lesser", "elemwise_add",
           "elemwise_sub", "elemwise_mul", "elemwise_div", "add",
           "subtract", "multiply", "divide", "mod", "equal", "not_equal",
           "greater", "lesser", "greater_equal", "lesser_equal", "power",
           "maximum", "minimum"):
    CASES[_b] = (lambda name: lambda nd: getattr(nd, name)(
        _a(nd, POS), _a(nd, POS[:1] * 1.5)))(_b)
for _b in ("broadcast_equal", "greater", "lesser_equal", "mod",
           "broadcast_add"):
    CASES[_b + "_int"] = (lambda name: lambda nd: getattr(nd, name)(
        _a(nd, I3), _a(nd, I3[::-1].copy())))(_b)


def rng_w(shape, _r=onp.random.RandomState(7)):
    """A fixed random array per shape (the same in both packages)."""
    key = tuple(shape)
    if key not in _W:
        _W[key] = _r.randn(*shape).astype(onp.float32)
    return _W[key]


_W = {}


@pytest.mark.parametrize("case", sorted(CASES))
def test_legacy_op(case):
    got, want = _both(CASES[case])
    _same(got, want)


# -- linalg_* -----------------------------------------------------------
LINALG = {
    "gemm": lambda nd: nd.linalg_gemm(_a(nd, M), _a(nd, N), _a(nd, S[:, :2]),
                                      alpha=2.0, beta=0.5),
    "gemm_t": lambda nd: nd.linalg.gemm(_a(nd, N), _a(nd, M), _a(nd, S[:2]),
                                        transpose_a=True, transpose_b=True),
    "gemm2": lambda nd: nd.linalg_gemm2(_a(nd, M), _a(nd, N), alpha=0.5),
    "gemm2_batch": lambda nd: nd.linalg.gemm2(_a(nd, X3), _a(nd, X3),
                                              transpose_b=True),
    "potrf": lambda nd: nd.linalg_potrf(_a(nd, S)),
    "potri": lambda nd: nd.linalg.potri(_a(nd, L)),
    "syrk": lambda nd: nd.linalg_syrk(_a(nd, M), alpha=0.5),
    "syrk_t": lambda nd: nd.linalg.syrk(_a(nd, M), transpose=True),
    "trsm": lambda nd: nd.linalg_trsm(_a(nd, L), _a(nd, B34), alpha=2.0),
    "trsm_right_t": lambda nd: nd.linalg.trsm(
        _a(nd, L), _a(nd, B34.T.copy()), rightside=True, transpose=True),
    "trsm_upper": lambda nd: nd.linalg.trsm(_a(nd, L.T.copy()),
                                            _a(nd, B34), lower=False),
    "trmm": lambda nd: nd.linalg_trmm(_a(nd, S), _a(nd, B34), alpha=1.5),
    "trmm_right_upper": lambda nd: nd.linalg.trmm(
        _a(nd, S), _a(nd, B34.T.copy()), rightside=True, lower=False),
    "trmm_t": lambda nd: nd.linalg.trmm(_a(nd, S), _a(nd, B34),
                                        transpose=True),
    "inverse": lambda nd: nd.linalg_inverse(_a(nd, S)),
    "det": lambda nd: nd.linalg.det(_a(nd, S)),
    "slogdet": lambda nd: nd.linalg_slogdet(_a(nd, M[:, :3])),
    "sumlogdiag": lambda nd: nd.linalg.sumlogdiag(_a(nd, L)),
    "extractdiag": lambda nd: nd.linalg_extractdiag(_a(nd, S), offset=1),
    "makediag": lambda nd: nd.linalg.makediag(_a(nd, V), offset=-1),
    "makediag_batch": lambda nd: nd.linalg.makediag(_a(nd, M), offset=2),
    "extracttrian": lambda nd: nd.linalg_extracttrian(_a(nd, S)),
    "extracttrian_upper": lambda nd: nd.linalg.extracttrian(
        _a(nd, X3[:, :, :3]), lower=False),
    "extracttrian_offset": lambda nd: nd.linalg.extracttrian(
        _a(nd, X4[0, :, :3, :3]), offset=-1),
    "maketrian": lambda nd: nd.linalg_maketrian(_a(nd, V[:3])),
    "maketrian_offset": lambda nd: nd.linalg.maketrian(
        _a(nd, M[:, :3]), offset=1),
    "maketrian_upper": lambda nd: nd.linalg.maketrian(_a(nd, V[:3]),
                                                      lower=False),
}


@pytest.mark.parametrize("case", sorted(LINALG))
def test_legacy_linalg(case):
    got, want = _both(LINALG[case])
    _same(got, want, rtol=1e-4, atol=1e-5)


def test_legacy_linalg_factorizations_by_reconstruction():
    with tmx.cpu():
        nd = tmx.nd
        u, lam = nd.linalg.syevd(nd.array(S))
        lq, q = nd.linalg.gelqf(nd.array(M))
    with jmx.cpu():
        _, jlam = jmx.nd.linalg.syevd(jmx.nd.array(S))
        jl, _ = jmx.nd.linalg.gelqf(jmx.nd.array(M))
    u, lam, lq, q = (x.asnumpy() for x in (u, lam, lq, q))
    onp.testing.assert_allclose(lam, jlam.asnumpy(), rtol=1e-4, atol=1e-5)
    assert onp.abs(u.T @ onp.diag(lam) @ u - S).max() < 1e-4
    assert onp.abs(lq @ q - M).max() < 1e-4
    assert onp.abs(q @ q.T - onp.eye(3)).max() < 1e-4
    onp.testing.assert_allclose(onp.abs(onp.diag(lq)),
                                onp.abs(onp.diag(jl.asnumpy())), rtol=1e-4)


# -- random ops: properties ----------------------------------------------
@pytest.mark.parametrize("name,args,lo,hi", [
    ("random_uniform", dict(low=-1.0, high=2.0), -1.0, 2.0),
    ("uniform", dict(low=0.0, high=1.0), 0.0, 1.0),
    ("random_normal", dict(loc=1.0, scale=0.1), 0.0, 2.0),
    ("normal", dict(), -10.0, 10.0),
    ("random_gamma", dict(alpha=2.0, beta=1.5), 0.0, float("inf")),
    ("sample_gamma", dict(alpha=1.0), 0.0, float("inf")),
    ("random_randint", dict(low=3, high=9), 3, 8)])
def test_legacy_samplers(name, args, lo, hi):
    for pkg in (jmx, tmx):
        with pkg.cpu():
            x = getattr(pkg.nd, name)(shape=(400, 5), **args).asnumpy()
        assert x.shape == (400, 5)
        assert x.min() >= lo and x.max() <= hi
    with tmx.cpu():
        d = tmx.nd.random_randint(3, 9, shape=(5,))
    assert d.dtype == onp.int32


@pytest.mark.parametrize("get_prob", [False, True])
def test_sample_multinomial(get_prob):
    p = onp.array([[0.1, 0.0, 0.9], [0.5, 0.5, 0.0]], onp.float32)
    res = {}
    for pkg in (jmx, tmx):
        with pkg.cpu():
            res[pkg] = pkg.nd.sample_multinomial(pkg.nd.array(p),
                                                 shape=(2000,),
                                                 get_prob=get_prob)
    got, want = res[tmx], res[jmx]
    if get_prob:
        got, lp = got
        want, _ = want
        lp = lp.asnumpy()
    assert got.shape == want.shape == (2, 2000)
    assert got.dtype == want.dtype
    g = got.asnumpy()
    assert (g[0] != 1).all() and (g[1] != 2).all()
    assert abs((g[0] == 2).mean() - 0.9) < 0.05
    assert abs((g[1] == 0).mean() - 0.5) < 0.05
    if get_prob:
        onp.testing.assert_allclose(lp, onp.log(p[onp.arange(2)[:, None],
                                                  g]), rtol=1e-6)
    with tmx.cpu():
        one = tmx.nd.sample_multinomial(tmx.nd.array(p[0]))
    assert one.shape == ()


def test_dropout_training_masks_and_scales():
    x = onp.ones((200, 50), onp.float32)
    with tmx.cpu(), tmx.autograd.train_mode():
        y = tmx.nd.Dropout(tmx.nd.array(x), p=0.25).asnumpy()
    assert set(onp.unique(y)) <= {0.0, onp.float32(1 / 0.75)}
    assert abs((y == 0).mean() - 0.25) < 0.03
    with tmx.cpu():
        y = tmx.nd.Dropout(tmx.nd.array(x), p=0.25, mode="always").asnumpy()
    assert (y == 0).any()


# -- gradients ------------------------------------------------------------
GRADS = {
    "FullyConnected": (lambda nd, x, w: nd.FullyConnected(
        x, w, None, num_hidden=3, no_bias=True), (FC_X, FC_W)),
    "Convolution": (lambda nd, x, w: nd.Convolution(
        x, w, None, kernel=(3, 3), pad=(1, 1), num_filter=3, no_bias=True),
        (IMG, W33)),
    "BatchNorm_train": (lambda nd, x, g: nd.BatchNorm(
        x, g, nd.array(BETA), nd.array(RMEAN), nd.array(RVAR)),
        (IMG, GAMMA)),
    "SoftmaxOutput": (lambda nd, x: nd.SoftmaxOutput(x, None) * nd.array(
        POS), (M,)),
    "make_loss": (lambda nd, x: nd.make_loss(nd.square(x)), (M,)),
    "BlockGrad": (lambda nd, x, y: nd.BlockGrad(x * y) + x * y, (M, POS)),
}


def _grads(pkg, fn, arrays):
    with pkg.cpu():
        xs = [pkg.nd.array(a) for a in arrays]
        for x in xs:
            x.attach_grad()
        with pkg.autograd.record():
            y = fn(pkg.nd, *xs)
            loss = (y * y).sum()
        loss.backward()
        return [y] + [x.grad for x in xs]


@pytest.mark.parametrize("case", sorted(GRADS))
def test_legacy_gradients(case):
    fn, arrays = GRADS[case]
    got = _grads(tmx, fn, arrays)
    want = _grads(jmx, fn, arrays)
    _same(got, want, rtol=1e-4, atol=1e-5)


# -- save / load -------------------------------------------------------
def test_save_load_lists_and_dicts_cross_packages(tmp_path):
    arrays = [X3, M, I3]
    for writer, reader in ((jmx, tmx), (tmx, jmx), (tmx, tmx)):
        path = str(tmp_path / ("%s_%s.params" % (writer.__name__,
                                                 reader.__name__)))
        with writer.cpu():
            writer.nd.save(path, [writer.nd.array(a) for a in arrays] * 4)
            writer.nd.save(path + ".d", {"w": writer.nd.array(M),
                                         "0": writer.nd.array(V)})
        with reader.cpu():
            back = reader.nd.load(path)
            d = reader.nd.load(path + ".d")
        assert isinstance(back, list) and len(back) == 12
        for a, b in zip(arrays * 4, back):
            onp.testing.assert_array_equal(b.asnumpy(), a)
        assert sorted(d) == ["0", "w"]
        onp.testing.assert_array_equal(d["w"].asnumpy(), M)


# -- the namespace ---------------------------------------------------------
BY_DESIGN = {"jax", "jnp", "apply_op", "annotations"}
WAITING = {  # name -> the queue 5 item it waits for
    ("nd", "RNN"): 3, ("nd", "CTCLoss"): 3, ("nd", "ctc_loss"): 3,
    ("nd", "im2col"): 3, ("nd", "col2im"): 3,
    ("nd", "DeformableConvolution"): 3, ("nd", "Custom"): 5,
    ("nd.contrib", "sldwin_atten_score"): 3,
    ("nd.contrib", "sldwin_atten_context"): 3,
    ("nd.contrib", "sldwin_atten_mask_like"): 3,
    ("nd.contrib", "im2col"): 3, ("nd.contrib", "col2im"): 3,
    ("nd.contrib", "deformable_convolution"): 3,
}
SPACES = ["nd", "nd.contrib", "nd.linalg", "nd.sparse", "nd.image",
          "np.linalg", "np.fft"]


def _mod(pkg, space):
    mod = pkg
    for part in space.split("."):
        mod = getattr(mod, part)
    return mod


@pytest.mark.parametrize("space", SPACES)
def test_namespace_has_the_references_names(space):
    ref = {n for n in dir(_mod(jmx, space)) if not n.startswith("_")}
    port = _mod(tmx, space)
    missing = sorted(n for n in ref - BY_DESIGN if not hasattr(port, n))
    assert not missing, missing
    if space == "nd":
        assert len(ref) == 242
    if space == "nd.contrib":
        assert len(ref) == 75


@pytest.mark.parametrize("space,name", sorted(WAITING))
def test_waiting_names_raise_naming_their_item(space, name):
    fn = getattr(_mod(tmx, space), name)
    with pytest.raises(NotImplementedError,
                       match="queue 5 item %d" % WAITING[(space, name)]):
        fn(None)


def test_only_the_waiting_names_raise():
    """Every other callable of the namespaces exists as a function or
    class that does not refuse by its name alone (its ``__name__`` is not
    one of the waiting stubs')."""
    for space in SPACES:
        mod = _mod(tmx, space)
        for name in dir(mod):
            fn = getattr(mod, name)
            if callable(fn) and getattr(fn, "__code__", None) is not None:
                stub = "is not ported yet" in str(fn.__code__.co_consts)
                assert stub == ((space, name) in WAITING), (space, name)


def test_entry_points_need_a_card_without_a_context():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context works")
    calls = [lambda: tmx.nd.array(M), lambda: tmx.nd.zeros((2,)),
             lambda: tmx.nd.linspace(0, 1, 3), lambda: tmx.nd.eye(2),
             lambda: tmx.nd.random_uniform(shape=(2,)),
             lambda: tmx.nd.sparse.zeros("csr", (2, 2)),
             lambda: tmx.nd.sparse.csr_matrix(M),
             lambda: tmx.nd.sparse.row_sparse_array(M),
             lambda: tmx.nd.image.to_tensor(onp.zeros((2, 2, 3), onp.uint8)),
             lambda: tmx.nd.contrib.MultiBoxPrior(onp.zeros((1, 1, 2, 2))),
             lambda: tmx.npx.multibox_prior(onp.zeros((1, 1, 2, 2))),
             lambda: tmx.np.linalg.inv(S), lambda: tmx.np.fft.fft(V),
             lambda: tmx.np.fft.fftfreq(4)]
    for call in calls:
        with pytest.raises(RuntimeError):
            call()


# -- the legacy spelling of a ResNet -------------------------------------
def test_legacy_resnet_helper_matches_both_nets():
    """chip_smoke's legacy spelling of a ResNet V1 (resnet18_v1 at
    thumbnail size) against the port's ``net(x)`` bit for bit and the
    JAX package's ``net(x)`` within 1e-4 of max|logit|, the same weights
    carried into the port by ``convert.load_params``."""
    import chip_smoke
    from _zoo_parity import _weights
    from mxnet_tpu.gluon.model_zoo import vision as jv

    def make():
        return tmx.gluon.model_zoo.vision.resnet18_v1(thumbnail=True,
                                                      classes=10)
    x = rng.randn(2, 3, 16, 16).astype(onp.float32)
    shaper = make().initialize(device="cpu")
    with tmx.autograd.pause():
        shaper(torch.from_numpy(x))
    weights = _weights({k: tuple(p.shape) for k, p in
                        shaper.collect_params().items()}, 0)
    jnet = jv.resnet18_v1(thumbnail=True, classes=10)
    jnet.setattr("grad_req", "null")
    for k, p in jnet.collect_params().items():
        p.set_data(jmx.np.array(weights[k]))
    jnet.hybridize()
    want = jnet(jmx.np.array(x)).asnumpy()
    net = tmx.convert.load_params(make().initialize(device="cpu"), weights)
    with tmx.cpu(), tmx.autograd.pause():
        own = net(torch.from_numpy(x))
        got = chip_smoke.legacy_resnet_v1(tmx, net, tmx.nd.array(x))
    assert torch.equal(got._data, own)
    err = onp.abs(got.asnumpy() - want).max() / onp.abs(want).max()
    assert err <= 1e-4, err
