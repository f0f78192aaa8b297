"""``npx.multibox_prior`` / ``multibox_target`` / ``multibox_detection``.

Counterpart of ``mxnet_tpu/numpy_extension/__init__.py:551-749`` (the
reference's ``_npx_multibox_*``), which differ from ``nd.contrib``'s
MultiBox ops in their matching (``>=`` the threshold), their negative
mining (the lowest background scores among anchors under
``negative_mining_thresh``) and their class ids (0-based foreground).
The anchor grid runs on the input's device; target assignment and NMS
compute in host numpy, as the reference does, and return on the
device of their first input.
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..ndarray._detection import _encode, _greedy_nms, _np, _out
from ..ndarray.ndarray import apply_op

__all__ = ["multibox_prior", "multibox_target", "multibox_detection"]


def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """SSD anchors of a (B, C, H, W) feature map: (1, H * W * A, 4)."""
    sizes = tuple(float(s) for s in (sizes if isinstance(sizes, (list, tuple))
                                     else (sizes,)))
    ratios = tuple(float(r) for r in (ratios if isinstance(
        ratios, (list, tuple)) else (ratios,)))

    def g(x):
        in_h, in_w = x.shape[-2], x.shape[-1]
        step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
        step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
        f32 = dict(dtype=torch.float32, device=x.device)
        cy = (torch.arange(in_h, **f32) + offsets[0]) * step_y
        cx = (torch.arange(in_w, **f32) + offsets[1]) * step_x
        r0 = float(ratios[0]) ** 0.5 if ratios else 1.0
        whs = [(s * in_h / in_w * r0 / 2.0, s / r0 / 2.0) for s in sizes]
        whs += [(sizes[0] * in_h / in_w * (r ** 0.5) / 2.0,
                 sizes[0] / (r ** 0.5) / 2.0) for r in ratios[1:]]
        half = torch.tensor(_onp.asarray(whs, _onp.float32),
                            device=x.device)[None, None]
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
        centers = torch.stack([cxg, cyg], -1)[:, :, None, :]
        boxes = torch.cat([centers - half, centers + half], -1)
        if clip:
            boxes = boxes.clamp(0.0, 1.0)
        return boxes.reshape(1, -1, 4)
    return apply_op(g, [data], "multibox_prior")


def _iou_matrix(anchors, gts):
    """(A, G) IoU of corner boxes (the reference's float32 formula)."""
    ix1 = _onp.maximum(anchors[:, None, 0], gts[None, :, 0])
    iy1 = _onp.maximum(anchors[:, None, 1], gts[None, :, 1])
    ix2 = _onp.minimum(anchors[:, None, 2], gts[None, :, 2])
    iy2 = _onp.minimum(anchors[:, None, 3], gts[None, :, 3])
    inter = _onp.maximum(0, ix2 - ix1) * _onp.maximum(0, iy2 - iy1)
    area_a = (anchors[:, 2] - anchors[:, 0]) * (anchors[:, 3] - anchors[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_a[:, None] + area_g[None, :] - inter
    return _onp.where(union <= 0, 0.0, inter / _onp.maximum(union, 1e-12))


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1, negative_mining_ratio=-1,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD targets: greedy bipartite matching, then every anchor at or
    over ``overlap_threshold``; (loc_target (B, A*4), loc_mask (B, A*4),
    cls_target (B, A)).  Host numpy."""
    anchors = _np(anchor).reshape(-1, 4)
    labels = _np(label)
    cls_preds = _np(cls_pred)
    B, A = labels.shape[0], anchors.shape[0]
    loc_t = _onp.zeros((B, A * 4), "float32")
    loc_m = _onp.zeros((B, A * 4), "float32")
    cls_t = _onp.zeros((B, A), "float32")
    for n in range(B):
        lab = labels[n]
        stop = _onp.nonzero(lab[:, 0] == -1)[0]
        gts = _onp.asarray(lab[:stop[0] if len(stop) else len(lab)],
                           "float32")
        if not len(gts):
            continue
        overlaps = _iou_matrix(anchors, gts[:, 1:5])
        matches = _onp.full(A, -1, _onp.int64)
        state = _onp.full(A, -1, _onp.int64)     # -1 ignore, 0 neg, 1 pos
        ov = overlaps.copy()
        for _ in range(len(gts)):
            j, k = _onp.unravel_index(_onp.argmax(ov), ov.shape)
            if ov[j, k] < 1e-6:
                break
            matches[j], state[j] = k, 1
            ov[j, :] = -1
            ov[:, k] = -1
        if overlap_threshold > 0:
            rest = state != 1
            k = _onp.argmax(overlaps, axis=1)
            hit = overlaps[_onp.arange(A), k] >= overlap_threshold
            matches[rest & hit] = k[rest & hit]
            state[rest] = _onp.where(hit[rest], 1, 0)
        else:
            state[state != 1] = 0
        if negative_mining_ratio > 0:
            maxiou = overlaps.max(axis=1)
            unmatched = state == 0
            eligible = _onp.where(unmatched &
                                  (maxiou < negative_mining_thresh))[0]
            state[unmatched] = -1
            num_pos = int((state == 1).sum())
            max_neg = max(int(negative_mining_ratio * num_pos),
                          int(minimum_negative_samples))
            if len(eligible):
                order = _onp.argsort(cls_preds[n, 0, eligible])
                state[eligible[order[:max_neg]]] = 0
        pos = _onp.nonzero(state == 1)[0]
        cls_t[n, pos] = gts[matches[pos], 0] + 1
        loc_t[n].reshape(A, 4)[pos] = _encode(anchors[pos],
                                              gts[matches[pos], 1:5],
                                              variances)
        loc_m[n].reshape(A, 4)[pos] = 1.0
        cls_t[n, state == -1] = ignore_label
    return _out(loc_t, anchor), _out(loc_m, anchor), _out(cls_t, anchor)


def _iou_one(box, boxes):
    return _iou_matrix(boxes, box[None])[:, 0]


def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0,
                       nms_threshold=0.5, force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD decode and NMS: (B, A, 6) rows [class, score, xmin, ymin, xmax,
    ymax], the class 0-based among the foreground ones, unused rows -1.
    Host numpy."""
    probs = _np(cls_prob)
    locs = _np(loc_pred)
    anchors = _np(anchor).reshape(-1, 4)
    B, C, A = probs.shape
    vx, vy, vw, vh = variances
    out = _onp.full((B, A, 6), -1.0, "float32")
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) / 2
    ay = (anchors[:, 1] + anchors[:, 3]) / 2
    fg_rows = [c for c in range(C) if c != background_id]
    for n in range(B):
        scores = probs[n, fg_rows, :]
        rows = _onp.asarray(fg_rows)[scores.argmax(axis=0)]
        ids = _onp.where(rows > background_id, rows - 1, rows)
        conf = scores.max(axis=0)
        lp = locs[n].reshape(A, 4)
        ox = lp[:, 0] * vx * aw + ax
        oy = lp[:, 1] * vy * ah + ay
        ow = _onp.exp(lp[:, 2] * vw) * aw / 2
        oh = _onp.exp(lp[:, 3] * vh) * ah / 2
        boxes = _onp.stack([ox - ow, oy - oh, ox + ow, oy + oh], -1)
        if clip:
            boxes = _onp.clip(boxes, 0.0, 1.0)
        valid = _onp.where(conf >= threshold)[0]
        order = valid[_onp.argsort(-conf[valid])]
        if nms_topk > 0:
            order = order[:nms_topk]
        kept = _greedy_nms(boxes, ids, order, nms_threshold, force_suppress,
                           iou=_iou_one)
        out[n, :len(kept), 0] = ids[kept]
        out[n, :len(kept), 1] = conf[kept]
        out[n, :len(kept), 2:] = boxes[kept]
    return _out(out, cls_prob)

