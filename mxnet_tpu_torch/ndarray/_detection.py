"""The detection ops of ``mx.nd.contrib``: SSD's MultiBox family, box
encode / decode, bipartite matching, RPN proposals, (deformable)
position-sensitive ROI pooling and rotated ROI align.

Counterpart of ``mxnet_tpu/ndarray/contrib.py:62-352`` and :842-1122.
The anchor grid, box encode / decode and ``RROIAlign`` run on the
inputs' device.  The assignment and suppression ops (``MultiBoxTarget``,
``MultiBoxDetection``, ``bipartite_matching``, ``proposal`` /
``multi_proposal``, the PS-ROI poolings) have data-dependent control
flow: they compute in host numpy, as the reference does (and as MXNet
runs them, on the CPU), and hand their result back on the device of
their first input.  The loops over anchors are numpy array operations
in the reference's order of float32 operations, so they give the
reference's values; the greedy suppression visits candidates in the
reference's order.
"""
from __future__ import annotations

import math

import numpy as _onp
import torch

from .ndarray import NDArray, apply_op, as_tensor


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return _onp.asarray(x)


def _dev(x):
    return x._data.device if isinstance(x, NDArray) else \
        x.device if torch.is_tensor(x) else None


def _out(arr, like):
    """A host result on the device of ``like`` (the current context for
    host input)."""
    return NDArray(as_tensor(_onp.ascontiguousarray(arr), device=_dev(like)))


# ----------------------------------------------------------------------
# SSD MultiBox (multibox_prior.cc, multibox_target.cc,
# multibox_detection.cc)
# ----------------------------------------------------------------------
def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes of each feature-map cell: every size at ratios[0],
    then sizes[0] at each further ratio; corners in [0, 1] units,
    (1, H * W * A, 4)."""
    sizes = [float(s) for s in sizes]
    ratios = [float(r) for r in ratios]

    def g(x):
        in_h, in_w = x.shape[-2], x.shape[-1]
        step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
        step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
        f32 = dict(dtype=torch.float32, device=x.device)
        cy = (torch.arange(in_h, **f32) + offsets[0]) * step_y
        cx = (torch.arange(in_w, **f32) + offsets[1]) * step_x
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
        r0 = _onp.sqrt(ratios[0])
        ws = [s * in_h / in_w * r0 / 2 for s in sizes]
        hs = [s / r0 / 2 for s in sizes]
        for r in ratios[1:]:
            rr = _onp.sqrt(r)
            ws.append(sizes[0] * in_h / in_w * rr / 2)
            hs.append(sizes[0] / rr / 2)
        ws = torch.tensor(_onp.asarray(ws, _onp.float32), device=x.device)
        hs = torch.tensor(_onp.asarray(hs, _onp.float32), device=x.device)
        cxg, cyg = cxg[..., None], cyg[..., None]
        boxes = torch.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs], -1)
        if clip:
            boxes = boxes.clamp(0.0, 1.0)
        return boxes.reshape(1, -1, 4)
    return apply_op(g, [data], "MultiBoxPrior")


def _pairwise_iou(anchors, gt_boxes):
    """(A, G) IoU of corner boxes, float32, the reference's formula."""
    tl = _onp.maximum(anchors[:, None, :2], gt_boxes[None, :, :2])
    br = _onp.minimum(anchors[:, None, 2:4], gt_boxes[None, :, 2:4])
    inter = _onp.prod(br - tl, axis=2) * (tl < br).all(axis=2)
    area_a = _onp.prod(anchors[:, 2:4] - anchors[:, :2], axis=1)
    area_g = _onp.prod(gt_boxes[:, 2:4] - gt_boxes[:, :2], axis=1)
    union = area_a[:, None] + area_g[None, :] - inter
    return _onp.where(union > 0, inter / _onp.maximum(union, 1e-12),
                      0.0).astype("float32")


def _encode(anchors, gts, variances):
    """SSD's (dx, dy, dw, dh) of ``gts`` (M, 4) against ``anchors``
    (M, 4), float32 in the reference's order of operations."""
    al, at, ar, ab = (anchors[:, i] for i in range(4))
    aw, ah = ar - al, ab - at
    ax, ay = (al + ar) / 2, (at + ab) / 2
    gl, gt_, gr, gb = (gts[:, i] for i in range(4))
    gw, gh = gr - gl, gb - gt_
    gx, gy = (gl + gr) / 2, (gt_ + gb) / 2
    return _onp.stack([(gx - ax) / aw / variances[0],
                       (gy - ay) / ah / variances[1],
                       _onp.log(gw / aw) / variances[2],
                       _onp.log(gh / ah) / variances[3]], 1)


def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1, negative_mining_ratio=-1,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets (``MultiBoxTargetForward``): a greedy
    bipartite match, then every anchor over ``overlap_threshold``, then
    optional hard-negative mining.  Host numpy; returns (loc_target,
    loc_mask, cls_target) on ``anchor``'s device."""
    anchors = _np(anchor).reshape(-1, 4)
    labels = _np(label)
    cls_preds = _np(cls_pred)
    B, num_labels, _ = labels.shape
    A = anchors.shape[0]
    loc_target = _onp.zeros((B, A * 4), "float32")
    loc_mask = _onp.zeros((B, A * 4), "float32")
    cls_target = _onp.full((B, A), float(ignore_label), "float32")
    for n in range(B):
        lab = labels[n]
        stop = _onp.nonzero(lab[:, 0] == -1.0)[0]
        valid = lab[:stop[0] if len(stop) else num_labels]
        if len(valid) == 0:
            continue
        overlaps = _pairwise_iou(anchors, valid[:, 1:5])
        flags = -_onp.ones(A, "int8")
        best = -_onp.ones(A, "float32")
        match = -_onp.ones(A, "int64")
        gt_flags = _onp.zeros(len(valid), bool)
        while not gt_flags.all():
            masked = overlaps.copy()
            masked[flags == 1, :] = -1
            masked[:, gt_flags] = -1
            j, k = _onp.unravel_index(_onp.argmax(masked), masked.shape)
            if masked[j, k] <= 1e-6:
                break
            best[j], match[j] = masked[j, k], k
            gt_flags[k] = True
            flags[j] = 1
        if overlap_threshold > 0:
            rest = flags != 1
            k = overlaps.argmax(1)
            ov = overlaps[_onp.arange(A), k]
            best[rest], match[rest] = ov[rest], k[rest]
            flags[rest & (ov > overlap_threshold)] = 1
        if negative_mining_ratio > 0:
            num_pos = int((flags == 1).sum())
            num_neg = min(max(int(num_pos * negative_mining_ratio),
                              int(minimum_negative_samples)), A - num_pos)
            cand = _onp.nonzero((flags != 1) &
                                (best < negative_mining_thresh))[0]
            logits = _onp.ascontiguousarray(cls_preds[n][:, cand].T)
            e = _onp.exp(logits - logits.max(1, keepdims=True))
            prob = e[:, 0] / e.sum(1)
            # hardest negatives: lowest background probability
            flags[cand[_onp.lexsort((cand, prob))[:num_neg]]] = 0
        else:
            flags[flags != 1] = 0
        pos = _onp.nonzero(flags == 1)[0]
        cls_target[n, pos] = valid[match[pos], 0] + 1
        cls_target[n, flags == 0] = 0
        loc_mask[n].reshape(A, 4)[pos] = 1
        loc_target[n].reshape(A, 4)[pos] = _encode(
            anchors[pos], valid[match[pos], 1:5], variances)
    return (_out(loc_target, anchor), _out(loc_mask, anchor),
            _out(cls_target, anchor))


def _iou_rows(box, boxes):
    """IoU of one corner box against rows of ``boxes`` (float32, the
    reference's ``_iou_corner`` operation by operation)."""
    w = _onp.maximum(0.0, _onp.minimum(box[2], boxes[:, 2])
                     - _onp.maximum(box[0], boxes[:, 0]))
    h = _onp.maximum(0.0, _onp.minimum(box[3], boxes[:, 3])
                     - _onp.maximum(box[1], boxes[:, 1]))
    i = w * h
    u = (box[2] - box[0]) * (box[3] - box[1]) \
        + (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) - i
    return _onp.where(u <= 0, 0.0, i / _onp.where(u <= 0, 1.0, u))


def _greedy_nms(boxes, ids, order, thresh, force, iou=_iou_rows):
    """The kept indices of ``order`` (best first): a candidate goes when
    a kept box of its class (any class with ``force``) overlaps it by
    more than ``thresh``."""
    alive = _onp.ones(len(order), bool)
    keep = []
    for pos, i in enumerate(order):
        if not alive[pos]:
            continue
        keep.append(i)
        later = order[pos + 1:]
        hit = iou(boxes[i], boxes[later]) > thresh
        if not force:
            hit &= ids[later] == ids[i]
        alive[pos + 1:] &= ~hit
    return keep


def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      background_id=0, nms_threshold=0.5,
                      force_suppress=False,
                      variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD decode and per-class NMS (``MultiBoxDetectionForward``).  Host
    numpy; (B, A, 6) rows [class, score, xmin, ymin, xmax, ymax] on
    ``cls_prob``'s device, the unused rows -1."""
    probs = _np(cls_prob)
    locs = _np(loc_pred)
    anchors = _np(anchor).reshape(-1, 4)
    B, num_classes, A = probs.shape
    out = -_onp.ones((B, A, 6), "float32")
    fg = [c for c in range(num_classes) if c != background_id]
    al, at, ar, ab = (anchors[:, i] for i in range(4))
    aw, ah = ar - al, ab - at
    ax, ay = (al + ar) / 2, (at + ab) / 2
    for n in range(B):
        scores = probs[n, fg]                         # (C - 1, A)
        cid = scores.argmax(0)
        score = scores[cid, _onp.arange(A)]
        lp = locs[n].reshape(A, 4)
        ox = lp[:, 0] * variances[0] * aw + ax
        oy = lp[:, 1] * variances[1] * ah + ay
        ow = _onp.exp(lp[:, 2] * variances[2]) * aw / 2
        oh = _onp.exp(lp[:, 3] * variances[3]) * ah / 2
        boxes = _onp.stack([ox - ow, oy - oh, ox + ow, oy + oh], 1)
        if clip:
            boxes = _onp.clip(boxes, 0.0, 1.0)
        cand = _onp.nonzero(score >= threshold)[0]
        order = cand[_onp.argsort(-score[cand], kind="stable")]
        if nms_topk > 0:
            order = order[:nms_topk]
        keep = _greedy_nms(boxes, cid, order, nms_threshold, force_suppress)
        out[n, :len(keep), 0] = cid[keep]
        out[n, :len(keep), 1] = score[keep]
        out[n, :len(keep), 2:] = boxes[keep]
    return _out(out, cls_prob)


# ----------------------------------------------------------------------
# box encode / decode (bounding_box-inl.h:802-1000), bipartite matching
# ----------------------------------------------------------------------
def _centers(a):
    return ((a[..., 0] + a[..., 2]) * 0.5, (a[..., 1] + a[..., 3]) * 0.5,
            a[..., 2] - a[..., 0], a[..., 3] - a[..., 1])


def box_encode(samples, matches, anchors, refs, means=(0.0, 0.0, 0.0, 0.0),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Matched reference boxes encoded against the anchors where
    ``samples > 0.5``: (targets, masks), both (B, N, 4)."""
    def g(s, m, a, r):
        ref = torch.gather(r, 1, m.long()[..., None].expand(
            m.shape + (r.shape[-1],)))
        a_x, a_y, a_w, a_h = _centers(a)
        r_x, r_y, r_w, r_h = _centers(ref)
        valid = (s > 0.5)[..., None]
        t = torch.stack([((r_x - a_x) / a_w - means[0]) / stds[0],
                         ((r_y - a_y) / a_h - means[1]) / stds[1],
                         (torch.log(r_w / a_w) - means[2]) / stds[2],
                         (torch.log(r_h / a_h) - means[3]) / stds[3]], -1)
        zero = torch.zeros((), dtype=t.dtype, device=t.device)
        return (torch.where(valid, t, zero),
                torch.where(valid, 1.0, zero) * torch.ones_like(t))
    return apply_op(g, [samples, matches, anchors, refs], "box_encode")


def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):  # noqa: A002
    """Center-format deltas decoded against the anchors (corner or
    center format) into corner boxes, clipped to [0, clip] when clip >
    0."""
    def g(d, a):
        if format == "corner":
            a_x, a_y, a_w, a_h = _centers(a)
        else:
            a_x, a_y, a_w, a_h = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        ox = d[..., 0] * std0 * a_w + a_x
        oy = d[..., 1] * std1 * a_h + a_y
        ow = torch.exp(d[..., 2] * std2) * a_w * 0.5
        oh = torch.exp(d[..., 3] * std3) * a_h * 0.5
        out = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], -1)
        return out.clamp(0.0, clip) if clip > 0 else out
    return apply_op(g, [data, anchors], "box_decode")


def bipartite_matching(data, threshold, is_ascend=False, topk=-1):
    """Greedy matching on a (..., N, M) score matrix: (row_match,
    col_match), -1 where unmatched.  Host numpy."""
    arr = _np(data).astype("float64")
    shape = arr.shape
    arr2 = arr.reshape(-1, shape[-2], shape[-1])
    B, N, M = arr2.shape
    row = -_onp.ones((B, N), "float32")
    col = -_onp.ones((B, M), "float32")
    fill = _onp.inf if is_ascend else -_onp.inf
    for b in range(B):
        scores = arr2[b].copy()
        n_iter = min(N, M) if topk <= 0 else min(topk, min(N, M))
        for _ in range(n_iter):
            idx = scores.argmin() if is_ascend else scores.argmax()
            i, j = _onp.unravel_index(idx, scores.shape)
            v = scores[i, j]
            if (is_ascend and v > threshold) or \
                    (not is_ascend and v < threshold):
                break
            row[b, i] = j
            col[b, j] = i
            scores[i, :] = fill
            scores[:, j] = fill
    return (_out(row.reshape(shape[:-1]), data),
            _out(col.reshape(shape[:-2] + (M,)), data))


# ----------------------------------------------------------------------
# PS-ROI pooling (psroi_pooling.cc, deformable_psroi_pooling.cc)
# ----------------------------------------------------------------------
def _psroi_impl(feat, r, tr, spatial_scale, output_dim, pooled_size,
                group_size, trans_std):
    """Position-sensitive average pooling; ``tr`` (R, 2 * classes, part,
    part) shifts each bin by its class's offset, None for none."""
    g = int(group_size)
    p = int(pooled_size)
    od = int(output_dim)
    _, _, H, W = feat.shape
    R = r.shape[0]
    out = _onp.zeros((R, od, p, p), "float32")
    if tr is not None:
        cls_of = (_onp.arange(od) * (tr.shape[1] // 2)) // od
        pt = tr.shape[2]
    chan_base = _onp.arange(od) * g * g
    for n in range(R):
        b = int(r[n, 0])
        x0, y0, x1, y1 = r[n, 1:5] * spatial_scale
        rw = max(x1 - x0, 0.1)
        rh = max(y1 - y0, 0.1)
        bw, bh = rw / p, rh / p
        for i in range(p):
            for j in range(p):
                chans = chan_base + int(i * g / p) * g + int(j * g / p)
                if tr is None:
                    dx = dy = _onp.zeros(od)
                else:
                    pi, pj = int(i * pt / p), int(j * pt / p)
                    dx = tr[n, 2 * cls_of, pi, pj] * trans_std * rw
                    dy = tr[n, 2 * cls_of + 1, pi, pj] * trans_std * rh
                for ux, uy in set(zip(dx.tolist(), dy.tolist())):
                    sel = (dx == ux) & (dy == uy)
                    hs = min(max(int(_onp.floor(y0 + i * bh + uy)), 0), H)
                    he = min(max(int(_onp.ceil(y0 + (i + 1) * bh + uy)),
                                 0), H)
                    ws = min(max(int(_onp.floor(x0 + j * bw + ux)), 0), W)
                    we = min(max(int(_onp.ceil(x0 + (j + 1) * bw + ux)),
                                 0), W)
                    if he > hs and we > ws:
                        out[n, sel, i, j] = feat[b, chans[sel], hs:he,
                                                 ws:we].mean(axis=(1, 2))
    return out


def psroi_pooling(data, rois, spatial_scale, output_dim, pooled_size,
                  group_size=None):
    """R-FCN's position-sensitive ROI average pooling: data (N,
    output_dim * g * g, H, W), rois (R, 5) of (batch, x0, y0, x1, y1).
    Host numpy."""
    return _out(_psroi_impl(_np(data), _np(rois), None, spatial_scale,
                            output_dim, pooled_size,
                            group_size or pooled_size, 0.0), data)


def deformable_psroi_pooling(data, rois, trans, spatial_scale, output_dim,
                             group_size, pooled_size, part_size=None,
                             sample_per_part=1, trans_std=0.0,
                             no_trans=False):
    """PS-ROI pooling with bins shifted by class-aware offsets ``trans``;
    ``no_trans`` gives :func:`psroi_pooling`.  Host numpy."""
    tr = None if (no_trans or trans is None) else _np(trans)
    return _out(_psroi_impl(_np(data), _np(rois), tr, spatial_scale,
                            output_dim, pooled_size, group_size, trans_std),
                data)


# ----------------------------------------------------------------------
# RPN proposals (proposal.cc, multi_proposal.cc)
# ----------------------------------------------------------------------
def _rpn_anchors(base_size, scales, ratios):
    """Faster R-CNN's base anchors, ratio-major."""
    w = h = float(base_size)
    x_ctr, y_ctr = 0.5 * (w - 1), 0.5 * (h - 1)
    out = []
    for r in ratios:
        new_w = _onp.floor(_onp.sqrt(_onp.floor(w * h / r)) + 0.5)
        new_h = _onp.floor(new_w * r + 0.5)
        for s in scales:
            ws, hs = new_w * s, new_h * s
            out.append([x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                        x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)])
    return _onp.array(out, "float32")


def _iou_inclusive(a, b):
    """Pixel-inclusive IoU (+1 widths), the proposal convention."""
    w = max(0.0, min(a[2], b[2]) - max(a[0], b[0]) + 1.0)
    h = max(0.0, min(a[3], b[3]) - max(a[1], b[1]) + 1.0)
    i = w * h
    u = (a[2] - a[0] + 1) * (a[3] - a[1] + 1) \
        + (b[2] - b[0] + 1) * (b[3] - b[1] + 1) - i
    return 0.0 if u <= 0 else i / u


def _proposal_one(scores, deltas, im_info, pre_n, post_n, threshold,
                  min_size, stride, scales, ratios, iou_loss):
    """One image of Proposal: decode over the anchor grid, clip, filter
    small boxes, sort, NMS, pad to ``post_n`` rows."""
    A4, H, W = deltas.shape
    A = A4 // 4
    base = _rpn_anchors(stride, scales, ratios)[:A]
    im_h, im_w, im_scale = (float(im_info[0]), float(im_info[1]),
                            float(im_info[2]))
    real_h = min(int(im_h / stride) + 1, H)
    real_w = min(int(im_w / stride) + 1, W)
    hh, ww = _onp.meshgrid(_onp.arange(real_h), _onp.arange(real_w),
                           indexing="ij")
    shift = _onp.stack([ww, hh, ww, hh], axis=-1) * stride
    anc = base[None, None, :, :] + shift[:, :, None, :]
    d = deltas.reshape(A, 4, H, W)[:, :, :real_h, :real_w]
    d = _onp.moveaxis(d, (2, 3), (0, 1))
    x1, y1, x2, y2 = (anc[..., k] for k in range(4))
    if iou_loss:
        px1, py1 = x1 + d[..., 0], y1 + d[..., 1]
        px2, py2 = x2 + d[..., 2], y2 + d[..., 3]
    else:
        bw = x2 - x1 + 1.0
        bh = y2 - y1 + 1.0
        cx = x1 + 0.5 * (bw - 1)
        cy = y1 + 0.5 * (bh - 1)
        pcx = d[..., 0] * bw + cx
        pcy = d[..., 1] * bh + cy
        pw = _onp.exp(d[..., 2]) * bw
        ph = _onp.exp(d[..., 3]) * bh
        px1, py1 = pcx - 0.5 * (pw - 1), pcy - 0.5 * (ph - 1)
        px2, py2 = pcx + 0.5 * (pw - 1), pcy + 0.5 * (ph - 1)
    px1 = _onp.clip(px1, 0, im_w - 1)
    py1 = _onp.clip(py1, 0, im_h - 1)
    px2 = _onp.clip(px2, 0, im_w - 1)
    py2 = _onp.clip(py2, 0, im_h - 1)
    sc = _onp.moveaxis(scores[:, :real_h, :real_w], 0, -1).copy()
    ms = min_size * im_scale
    small = ((px2 - px1 + 1) < ms) | ((py2 - py1 + 1) < ms)
    px1 = _onp.where(small, px1 - ms / 2, px1)
    py1 = _onp.where(small, py1 - ms / 2, py1)
    px2 = _onp.where(small, px2 + ms / 2, px2)
    py2 = _onp.where(small, py2 + ms / 2, py2)
    sc = _onp.where(small, -1.0, sc)
    rows = _onp.stack([px1, py1, px2, py2, sc], axis=-1).reshape(-1, 5)
    rows = rows[_onp.argsort(-rows[:, 4], kind="stable")[:pre_n]]
    keep = []
    for r in rows:
        if len(keep) >= post_n:
            break
        if all(_iou_inclusive(k[:4], r[:4]) <= threshold for k in keep):
            keep.append(list(r))
    while len(keep) < post_n:
        keep.append(list(keep[0]) if keep else [0, 0, 0, 0, 0])
    return keep


def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """Region proposals of one image from RPN scores (1, 2A, H, W) and
    deltas: (post_nms, 5) rois (batch 0, x1, y1, x2, y2), and their
    (post_nms, 1) scores with ``output_score``.  Host numpy."""
    probs = _np(cls_prob)
    if probs.shape[0] != 1:
        raise ValueError("proposal handles batch=1; use multi_proposal")
    rois, sc = _proposals(probs, _np(bbox_pred), _np(im_info),
                          rpn_pre_nms_top_n, rpn_post_nms_top_n, threshold,
                          rpn_min_size, scales, ratios, feature_stride,
                          iou_loss)
    if output_score:
        return _out(rois, cls_prob), _out(sc, cls_prob)
    return _out(rois, cls_prob)


def _proposals(probs, deltas, info, pre_n, post_n, threshold, min_size,
               scales, ratios, stride, iou_loss):
    A = probs.shape[1] // 2
    rois, scores = [], []
    for n in range(probs.shape[0]):
        keep = _proposal_one(probs[n, A:], deltas[n], info[n], pre_n,
                             post_n, threshold, min_size, stride, scales,
                             ratios, iou_loss)
        rois += [[float(n)] + r[:4] for r in keep]
        scores += [[r[4]] for r in keep]
    return _onp.array(rois, "float32"), _onp.array(scores, "float32")


def multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                   rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                   scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                   feature_stride=16, output_score=False, iou_loss=False):
    """Batched :func:`proposal`: (N * post_nms, 5) with each image's batch
    index.  Host numpy."""
    rois, sc = _proposals(_np(cls_prob), _np(bbox_pred), _np(im_info),
                          rpn_pre_nms_top_n, rpn_post_nms_top_n, threshold,
                          rpn_min_size, scales, ratios, feature_stride,
                          iou_loss)
    if output_score:
        return _out(rois, cls_prob), _out(sc, cls_prob)
    return _out(rois, cls_prob)


Proposal = proposal
MultiProposal = multi_proposal


# ----------------------------------------------------------------------
# rotated ROI align (rroi_align.cc)
# ----------------------------------------------------------------------
def RROIAlign(data, rois, pooled_size, spatial_scale=1.0, sampling_ratio=2):
    """Rotated ROI align: rois (R, 6) of (batch, cx, cy, w, h, angle in
    degrees), one bilinear sample at each bin centre of the rotated grid,
    (R, C, ph, pw)."""
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))

    def g(feat, r):
        _, _, H, W = feat.shape
        R = r.shape[0]
        bidx = r[:, 0].long()
        cx, cy = r[:, 1] * spatial_scale, r[:, 2] * spatial_scale
        rw = torch.clamp(r[:, 3] * spatial_scale, min=1.0)
        rh = torch.clamp(r[:, 4] * spatial_scale, min=1.0)
        theta = r[:, 5] * math.pi / 180.0
        f32 = dict(dtype=torch.float32, device=feat.device)
        ys = (torch.arange(ph, **f32) + 0.5) / ph - 0.5
        xs = (torch.arange(pw, **f32) + 0.5) / pw - 0.5
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        lx = gx[None] * rw[:, None, None]
        ly = gy[None] * rh[:, None, None]
        cos, sin = torch.cos(theta)[:, None, None], \
            torch.sin(theta)[:, None, None]
        sx = cx[:, None, None] + lx * cos - ly * sin
        sy = cy[:, None, None] + lx * sin + ly * cos
        x0 = torch.clamp(torch.floor(sx), 0, W - 1)
        y0 = torch.clamp(torch.floor(sy), 0, H - 1)
        x1 = torch.clamp(x0 + 1, 0, W - 1)
        y1 = torch.clamp(y0 + 1, 0, H - 1)
        wx, wy = sx - x0, sy - y0
        fb = feat[bidx]
        ridx = torch.arange(R, device=feat.device)[:, None, None]

        def gat(iy, ix):
            return fb[ridx, :, iy.long(), ix.long()]      # (R, ph, pw, C)
        v = (gat(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
             + gat(y0, x1) * (wx * (1 - wy))[..., None]
             + gat(y1, x0) * ((1 - wx) * wy)[..., None]
             + gat(y1, x1) * (wx * wy)[..., None])
        return v.permute(0, 3, 1, 2)
    return apply_op(g, [data, rois], "RROIAlign")
