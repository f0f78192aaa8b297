"""``mx.nd.contrib`` of the port (detection, layers, tensor utilities,
custom gradients, the graph ops) and ``npx.multibox_*``, against the JAX
package's on the same numpy inputs (the port under ``with mx.cpu():``).

Tolerances: integer outputs, matches, class targets and masks exactly;
float32 values (anchors, box targets, detections, pooled features,
likelihoods) at rtol 1e-5 / atol 1e-6; the FFT pair at atol 1e-5.  The
custom-gradient ops' backward (``gradientmultiplier``, ``round_ste``,
``sign_ste``, ``IdentityAttachKLSparseReg``) equals JAX's.  The graph
samplers draw from the port's generator: they are held to the
reference's invariants and to their own reproducibility under a seed.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

RTOL, ATOL = 1e-5, 1e-6
rng = onp.random.RandomState(0)


def _both(fn):
    with jmx.cpu():
        want = fn(jmx)
    with tmx.cpu():
        got = fn(tmx)
    return got, want


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return onp.asarray(x.asnumpy())


def _same(got, want, rtol=RTOL, atol=ATOL):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, rtol, atol)
        return
    assert getattr(got, "stype", "default") == getattr(want, "stype",
                                                       "default")
    g, w = _host(got), _host(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert str(g.dtype) == str(w.dtype), (g.dtype, w.dtype)
    if onp.issubdtype(w.dtype, onp.floating):
        onp.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    else:
        onp.testing.assert_array_equal(g, w)


# -- SSD MultiBox at a small anchor grid ----------------------------------
FEAT = onp.zeros((1, 1, 6, 6), onp.float32)
FEAT2 = onp.zeros((1, 1, 3, 3), onp.float32)


def _labels(B=3, seed=1):
    r = onp.random.RandomState(seed)
    lab = -onp.ones((B, 4, 5), onp.float32)
    for n in range(B - 1):                # the last image has no boxes
        k = r.randint(1, 5)
        xy = r.rand(k, 2) * 0.6
        lab[n, :k, 0] = r.randint(0, 4, k)
        lab[n, :k, 1:3] = xy
        lab[n, :k, 3:5] = xy + 0.1 + r.rand(k, 2) * 0.3
    return lab


def _anchors(mx, npx=False):
    prior = mx.npx.multibox_prior if npx else mx.nd.contrib.MultiBoxPrior
    a = prior(mx.nd.array(FEAT), sizes=(0.3, 0.2), ratios=(1, 2, 0.5))
    b = prior(mx.nd.array(FEAT2), sizes=(0.6,), ratios=(1, 3))
    return mx.np.concatenate([a, b], axis=1)


A_COUNT = 6 * 6 * 4 + 3 * 3 * 2
LAB = _labels()
CLS = rng.randn(3, 5, A_COUNT).astype(onp.float32)
LOC = (rng.randn(3, A_COUNT * 4) * 0.2).astype(onp.float32)
PROB = onp.exp(CLS) / onp.exp(CLS).sum(1, keepdims=True)

MULTIBOX = {
    "prior": lambda mx: _anchors(mx),
    "prior_clip_steps": lambda mx: mx.nd.contrib.MultiBoxPrior(
        mx.nd.array(FEAT), sizes=(0.5, 0.9), ratios=(1, 4), clip=True,
        steps=(0.2, 0.1), offsets=(0.25, 0.75)),
    "target": lambda mx: mx.nd.contrib.MultiBoxTarget(
        _anchors(mx), mx.nd.array(LAB), mx.nd.array(CLS)),
    "target_mining": lambda mx: mx.nd.contrib.MultiBoxTarget(
        _anchors(mx), mx.nd.array(LAB), mx.nd.array(CLS),
        overlap_threshold=0.4, negative_mining_ratio=3,
        negative_mining_thresh=0.3, minimum_negative_samples=5),
    "target_no_threshold": lambda mx: mx.nd.contrib.MultiBoxTarget(
        _anchors(mx), mx.nd.array(LAB), mx.nd.array(CLS),
        overlap_threshold=0.0, ignore_label=-2),
    "detection": lambda mx: mx.nd.contrib.MultiBoxDetection(
        mx.nd.array(PROB), mx.nd.array(LOC), _anchors(mx)),
    "detection_topk_force": lambda mx: mx.nd.contrib.MultiBoxDetection(
        mx.nd.array(PROB), mx.nd.array(LOC), _anchors(mx), threshold=0.3,
        nms_threshold=0.3, force_suppress=True, nms_topk=20, clip=False),
    "detection_background_2": lambda mx: mx.nd.contrib.MultiBoxDetection(
        mx.nd.array(PROB), mx.nd.array(LOC), _anchors(mx),
        background_id=2, nms_threshold=0.6),
    "npx_prior": lambda mx: _anchors(mx, npx=True),
    "npx_target": lambda mx: mx.npx.multibox_target(
        _anchors(mx, True), mx.nd.array(LAB), mx.nd.array(CLS)),
    "npx_target_mining": lambda mx: mx.npx.multibox_target(
        _anchors(mx, True), mx.nd.array(LAB), mx.nd.array(CLS),
        overlap_threshold=0.4, negative_mining_ratio=2,
        negative_mining_thresh=0.4, minimum_negative_samples=3),
    "npx_target_no_threshold": lambda mx: mx.npx.multibox_target(
        _anchors(mx, True), mx.nd.array(LAB), mx.nd.array(CLS),
        overlap_threshold=0.0),
    "npx_detection": lambda mx: mx.npx.multibox_detection(
        mx.nd.array(PROB), mx.nd.array(LOC), _anchors(mx, True)),
    "npx_detection_force_topk": lambda mx: mx.npx.multibox_detection(
        mx.nd.array(PROB), mx.nd.array(LOC), _anchors(mx, True),
        threshold=0.25, nms_threshold=0.2, force_suppress=True, nms_topk=15),
    "npx_detection_background_1": lambda mx: mx.npx.multibox_detection(
        mx.nd.array(PROB), mx.nd.array(LOC), _anchors(mx, True),
        background_id=1, clip=False),
}


@pytest.mark.parametrize("case", sorted(MULTIBOX))
def test_multibox(case):
    got, want = _both(MULTIBOX[case])
    _same(got, want)


# -- boxes, matching, proposals, ROI ops ------------------------------------
BOXES = onp.sort(rng.rand(2, 5, 2, 2), axis=2).reshape(2, 5, 4)[
    ..., [0, 2, 1, 3]].astype(onp.float32)
REFS = onp.sort(rng.rand(2, 3, 2, 2), axis=2).reshape(2, 3, 4)[
    ..., [0, 2, 1, 3]].astype(onp.float32)
SCORES = rng.rand(2, 4, 3).astype(onp.float32)
FM = rng.randn(2, 8, 6, 6).astype(onp.float32)
ROIS = onp.array([[0, 0.5, 0.5, 4.0, 5.0], [1, 1.0, 0.0, 5.5, 3.5],
                  [0, 2.0, 2.0, 2.5, 2.5]], onp.float32)
RROIS = onp.array([[0, 3.0, 3.0, 4.0, 2.0, 30.0], [1, 2.5, 3.5, 3.0, 3.0,
                                                   -45.0]], onp.float32)
TRANS = (rng.randn(3, 4, 2, 2) * 0.5).astype(onp.float32)
RPN_P = rng.rand(2, 6, 4, 5).astype(onp.float32)
RPN_D = (rng.randn(2, 12, 4, 5) * 0.2).astype(onp.float32)
IM_INFO = onp.array([[64.0, 80.0, 1.0], [60.0, 70.0, 1.5]], onp.float32)

OPS = {
    "box_encode": lambda mx: mx.nd.contrib.box_encode(
        mx.nd.array((rng_s((2, 5)) > 0.3).astype(onp.float32)),
        mx.nd.array(onp.array([[0, 2, 1, 0, 2], [1, 1, 0, 2, 0]],
                              onp.float32)),
        mx.nd.array(BOXES), mx.nd.array(REFS)),
    "box_decode": lambda mx: mx.nd.contrib.box_decode(
        mx.nd.array(rng_s((2, 5, 4)) * 0.3), mx.nd.array(BOXES)),
    "box_decode_center_clip": lambda mx: mx.nd.contrib.box_decode(
        mx.nd.array(rng_s((2, 5, 4)) * 0.3), mx.nd.array(BOXES),
        format="center", clip=0.8),
    "bipartite_matching": lambda mx: mx.nd.contrib.bipartite_matching(
        mx.nd.array(SCORES), threshold=0.2),
    "bipartite_matching_ascend_topk": lambda mx:
        mx.nd.contrib.bipartite_matching(mx.nd.array(SCORES[0]),
                                         threshold=0.8, is_ascend=True,
                                         topk=2),
    "proposal": lambda mx: mx.nd.contrib.proposal(
        mx.nd.array(RPN_P[:1]), mx.nd.array(RPN_D[:1]),
        mx.nd.array(IM_INFO[:1]), rpn_pre_nms_top_n=30,
        rpn_post_nms_top_n=8, scales=(1, 2), ratios=(0.5, 1, 2),
        feature_stride=16, rpn_min_size=4, output_score=True),
    "Proposal_iou_loss": lambda mx: mx.nd.contrib.Proposal(
        mx.nd.array(RPN_P[:1]), mx.nd.array(RPN_D[:1]),
        mx.nd.array(IM_INFO[:1]), rpn_post_nms_top_n=5, scales=(1, 2),
        ratios=(0.5, 1, 2), threshold=0.5, iou_loss=True),
    "multi_proposal": lambda mx: mx.nd.contrib.MultiProposal(
        mx.nd.array(RPN_P), mx.nd.array(RPN_D), mx.nd.array(IM_INFO),
        rpn_pre_nms_top_n=20, rpn_post_nms_top_n=6, scales=(1, 2),
        ratios=(0.5, 1, 2), rpn_min_size=8, output_score=True),
    "psroi_pooling": lambda mx: mx.nd.contrib.psroi_pooling(
        mx.nd.array(FM), mx.nd.array(ROIS), 1.0, 2, 2),
    "deformable_psroi_pooling": lambda mx:
        mx.nd.contrib.deformable_psroi_pooling(
            mx.nd.array(FM), mx.nd.array(ROIS), mx.nd.array(TRANS), 1.0, 2,
            2, 2, part_size=2, trans_std=0.1),
    "deformable_psroi_no_trans": lambda mx:
        mx.nd.contrib.deformable_psroi_pooling(
            mx.nd.array(FM), mx.nd.array(ROIS), None, 0.5, 2, 2, 2,
            no_trans=True),
    "RROIAlign": lambda mx: mx.nd.contrib.RROIAlign(
        mx.nd.array(FM), mx.nd.array(RROIS), (3, 2), spatial_scale=1.0),
    "ROIAlign": lambda mx: mx.nd.contrib.ROIAlign(
        mx.nd.array(FM), mx.nd.array(ROIS), (2, 2), 1.0),
    "AdaptiveAvgPooling2D": lambda mx: mx.nd.contrib.AdaptiveAvgPooling2D(
        mx.nd.array(FM), output_size=(4, 3)),
    "AdaptiveAvgPooling2D_even": lambda mx:
        mx.nd.contrib.AdaptiveAvgPooling2D(mx.nd.array(FM), 3),
    "BilinearResize2D_up": lambda mx: mx.nd.contrib.BilinearResize2D(
        mx.nd.array(FM), height=9, width=13),
    "BilinearResize2D_down_scale": lambda mx: mx.nd.contrib.BilinearResize2D(
        mx.nd.array(FM), scale_height=0.5, scale_width=0.7),
    "SyncBatchNorm": lambda mx: mx.nd.contrib.SyncBatchNorm(
        mx.nd.array(FM), mx.nd.array(onp.ones(8, onp.float32) * 1.5),
        mx.nd.array(onp.arange(8, dtype=onp.float32)),
        mx.nd.array(onp.zeros(8, onp.float32)),
        mx.nd.array(onp.ones(8, onp.float32)), use_global_stats=True,
        fix_gamma=False),
    "BatchNormWithReLU": lambda mx: mx.nd.contrib.BatchNormWithReLU(
        mx.nd.array(FM), mx.nd.array(onp.ones(8, onp.float32)),
        mx.nd.array(onp.zeros(8, onp.float32) - 0.2),
        mx.nd.array(onp.zeros(8, onp.float32) + 0.1),
        mx.nd.array(onp.ones(8, onp.float32) * 2), use_global_stats=True),
    "quadratic": lambda mx: mx.nd.contrib.quadratic(mx.nd.array(FM), 1.5,
                                                    -2.0, 0.5),
    "index_copy": lambda mx: mx.nd.contrib.index_copy(
        mx.nd.array(FM[0, :4, 0]), mx.nd.array(onp.array([3, 0], onp.int32)),
        mx.nd.array(onp.ones((2, 6), onp.float32))),
    "index_array": lambda mx: mx.nd.contrib.index_array(mx.nd.array(FM[0])),
    "index_array_axes": lambda mx: mx.nd.contrib.index_array(
        mx.nd.array(FM[0]), axes=(2, 0)),
    "getnnz": lambda mx: mx.nd.contrib.getnnz(mx.nd.array(
        onp.maximum(FM[0, 0], 0))),
    "getnnz_axis": lambda mx: mx.nd.contrib.getnnz(mx.nd.array(
        onp.maximum(FM[0, 0], 0)), axis=1),
    "boolean_mask": lambda mx: mx.nd.contrib.boolean_mask(
        mx.nd.array(FM[0]), mx.nd.array(onp.array([1, 0, 0, 1, 1, 0, 0, 1],
                                                  onp.float32))),
    "boolean_mask_axis": lambda mx: mx.nd.contrib.boolean_mask(
        mx.nd.array(FM[0, 0]), mx.nd.array(onp.array([0, 1, 1, 0, 0, 1],
                                                     onp.int32)), axis=1),
    "dynamic_reshape": lambda mx: mx.nd.contrib.dynamic_reshape(
        mx.nd.array(FM), mx.nd.array(onp.array([4, -1, 9], onp.int32))),
    "div_sqrt_dim": lambda mx: mx.nd.contrib.div_sqrt_dim(mx.nd.array(FM)),
    "allclose_true": lambda mx: mx.nd.contrib.allclose(
        mx.nd.array(FM), mx.nd.array(FM + 1e-7)),
    "allclose_false": lambda mx: mx.nd.contrib.allclose(
        mx.nd.array(FM), mx.nd.array(FM + 1e-2), rtol=1e-5, atol=1e-4),
    "count_sketch": lambda mx: mx.nd.contrib.count_sketch(
        mx.nd.array(FM[0, :, :, 0]), mx.nd.array(onp.array(
            [0, 2, 1, 2, 0, 3], onp.float32)), mx.nd.array(onp.array(
                [1, -1, 1, 1, -1, 1], onp.float32)), out_dim=4),
    "khatri_rao": lambda mx: mx.nd.contrib.khatri_rao(
        mx.nd.array(FM[0, 0, :2]), mx.nd.array(FM[0, 1, :3]),
        mx.nd.array(FM[1, 0, :2])),
    "fft_ifft": lambda mx: [mx.nd.contrib.fft(mx.nd.array(FM[0])),
                            mx.nd.contrib.ifft(mx.nd.contrib.fft(
                                mx.nd.array(FM[0])))],
}


def rng_s(shape, _r=onp.random.RandomState(9)):
    key = tuple(shape)
    if key not in _S:
        _S[key] = _r.rand(*shape).astype(onp.float32)
    return _S[key]


_S = {}


@pytest.mark.parametrize("case", sorted(OPS))
def test_contrib_op(case):
    got, want = _both(OPS[case])
    atol = 1e-5 if case == "fft_ifft" else ATOL
    _same(got, want, atol=atol)


def test_hawkesll():
    r = onp.random.RandomState(4)
    N, K, T = 3, 2, 5
    args = [r.rand(N, K).astype(onp.float32) + 0.2,
            r.rand(K).astype(onp.float32) * 0.5,
            r.rand(K).astype(onp.float32) + 0.5,
            r.rand(N, K).astype(onp.float32),
            r.rand(N, T).astype(onp.float32) + 0.1,
            r.randint(0, K, (N, T)).astype(onp.int32),
            onp.array([5, 3, 0], onp.float32),
            onp.array([4.0, 3.5, 2.0], onp.float32)]
    got, want = _both(lambda mx: mx.nd.contrib.hawkesll(
        *[mx.nd.array(a) for a in args]))
    _same(got, want, rtol=1e-5, atol=1e-5)


# -- custom gradients ---------------------------------------------------
GRADS = {
    "gradientmultiplier": lambda mx, x: mx.nd.contrib.gradientmultiplier(
        x, scalar=-0.5),
    "round_ste": lambda mx, x: mx.nd.contrib.round_ste(x * 3),
    "sign_ste": lambda mx, x: mx.nd.contrib.sign_ste(x),
    "IdentityAttachKLSparseReg": lambda mx, x:
        mx.nd.contrib.IdentityAttachKLSparseReg(
            mx.nd.sigmoid(x), sparseness_target=0.2, penalty=0.01),
}


@pytest.mark.parametrize("case", sorted(GRADS))
def test_custom_gradient(case):
    x0 = rng.randn(4, 3).astype(onp.float32)
    w = rng.randn(4, 3).astype(onp.float32)

    def run(mx):
        x = mx.nd.array(x0)
        x.attach_grad()
        with mx.autograd.record():
            y = GRADS[case](mx, x)
            loss = (y * mx.nd.array(w)).sum()
        loss.backward()
        return [y, x.grad]
    got, want = _both(run)
    _same(got, want)


# -- graph ops ---------------------------------------------------------------
def _k5(mx):
    """The reference tests' 5-vertex complete graph, edge ids 1..20."""
    data = onp.arange(1, 21, dtype=onp.int64)
    indices = onp.array([1, 2, 3, 4, 0, 2, 3, 4, 0, 1, 3, 4,
                         0, 1, 2, 4, 0, 1, 2, 3], onp.int64)
    indptr = onp.array([0, 4, 8, 12, 16, 20], onp.int64)
    return mx.nd.sparse.csr_matrix((data, indices, indptr), shape=(5, 5))


def _zero_edge(mx):
    return mx.nd.sparse.csr_matrix(
        (onp.array([0.0, 5.0, 7.0], onp.float32), onp.array([1, 2, 0]),
         onp.array([0, 2, 3, 3])), shape=(3, 3))


GRAPH = {
    "subgraph": lambda mx: mx.nd.contrib.dgl_subgraph(
        _k5(mx), mx.nd.array(onp.array([0, 1, 3], onp.int64))),
    "subgraph_mapping": lambda mx: mx.nd.contrib.dgl_subgraph(
        _k5(mx), mx.nd.array(onp.array([4, 2], onp.int64)),
        mx.nd.array(onp.array([1, 2, 3], onp.int64)), return_mapping=True),
    "adjacency": lambda mx: mx.nd.contrib.dgl_adjacency(_k5(mx)),
    "adjacency_zero_edge": lambda mx: mx.nd.contrib.dgl_adjacency(
        _zero_edge(mx)),
    "edge_id": lambda mx: mx.nd.contrib.edge_id(
        _k5(mx), mx.nd.array(onp.array([0, 1, 2, 3, 4], onp.int64)),
        mx.nd.array(onp.array([1, 1, 4, 0, 0], onp.int64))),
    "edge_id_explicit_zero": lambda mx: mx.nd.contrib.edge_id(
        _zero_edge(mx), mx.nd.array(onp.array([0, 0, 1, 2])),
        mx.nd.array(onp.array([1, 0, 0, 2]))),
    "edge_id_dense": lambda mx: mx.nd.contrib.edge_id(
        mx.nd.array(onp.arange(9, dtype=onp.float32).reshape(3, 3)),
        mx.nd.array(onp.array([0, 2])), mx.nd.array(onp.array([1, 2]))),
    "graph_compact": lambda mx: mx.nd.contrib.dgl_graph_compact(
        mx.nd.sparse.csr_matrix(
            (onp.array([1, 2, 3], onp.float32), onp.array([7, 3, 7]),
             onp.array([0, 2, 3, 3, 3])), shape=(4, 8)),
        mx.nd.array(onp.array([3, 7, -1, -1, 2], onp.int64)),
        graph_sizes=2),
}


@pytest.mark.parametrize("case", sorted(GRAPH))
def test_graph_op(case):
    got, want = _both(GRAPH[case])
    _same(got, want)
    for g, w in zip(got if isinstance(got, list) else [got],
                    want if isinstance(want, list) else [want]):
        if getattr(w, "stype", "default") == "csr":
            for part in ("indices", "indptr", "data"):
                onp.testing.assert_array_equal(
                    getattr(g, part).asnumpy(), getattr(w, part).asnumpy())


@pytest.mark.parametrize("seeds,num_hops,num_neighbor,max_v", [
    ([0, 1, 2, 3, 4], 1, 2, 5), ([0], 1, 1, 4), ([0], 2, 1, 3),
    ([0, 2, 4], 1, 2, 5), ([0, 4], 2, 2, 5)])
def test_uniform_sample_invariants(seeds, num_hops, num_neighbor, max_v):
    with tmx.cpu():
        tmx.np.random.seed(1)
        sid, sub, layer = tmx.nd.contrib.dgl_csr_neighbor_uniform_sample(
            _k5(tmx), tmx.nd.array(onp.array(seeds, onp.int64)),
            num_hops=num_hops, num_neighbor=num_neighbor,
            max_num_vertices=max_v)
        tmx.np.random.seed(1)
        again = tmx.nd.contrib.dgl_csr_neighbor_uniform_sample(
            _k5(tmx), tmx.nd.array(onp.array(seeds, onp.int64)),
            num_hops=num_hops, num_neighbor=num_neighbor,
            max_num_vertices=max_v)
    assert sid.shape == (max_v + 1,) and sub.stype == "csr"
    nv = int(sid.asnumpy()[-1])
    assert 0 < nv <= max_v
    lay = layer.asnumpy()
    assert (lay[:nv] >= 0).all() and (lay[:nv] <= num_hops).all()
    indptr = sub.indptr.asnumpy()
    assert (indptr[nv:] == indptr[nv]).all()
    assert (onp.diff(indptr[:nv + 1]) <= num_neighbor).all()
    onp.testing.assert_array_equal(again[0].asnumpy(), sid.asnumpy())
    onp.testing.assert_array_equal(again[1].asnumpy(), sub.asnumpy())
    with tmx.cpu():
        compact = tmx.nd.contrib.dgl_graph_compact(sub, sid, graph_sizes=nv)
    ids = sid.asnumpy()
    assert (ids[compact.indices.asnumpy()] == sub.indices.asnumpy()).all()


def test_non_uniform_sample_skips_zero_probability():
    prob = onp.array([0.5, 0.0, 0.5, 0.0, 1.0], onp.float32)
    with tmx.cpu():
        tmx.np.random.seed(2)
        sid, sub, p, layer = \
            tmx.nd.contrib.dgl_csr_neighbor_non_uniform_sample(
                _k5(tmx), tmx.nd.array(prob),
                tmx.nd.array(onp.array([0], onp.int64)), num_hops=2,
                num_neighbor=3, max_num_vertices=5)
    nv = int(sid.asnumpy()[-1])
    got = set(sid.asnumpy()[:nv].tolist())
    assert 1 not in got and 3 not in got and 0 in got
    onp.testing.assert_array_equal(p.asnumpy()[:nv],
                                   prob[sid.asnumpy()[:nv]])
