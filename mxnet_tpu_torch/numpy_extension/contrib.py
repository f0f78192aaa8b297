"""Contrib operators of ``mx.npx``.

Counterpart of ``mxnet_tpu/numpy_extension/contrib.py``: ``roi_align``
(:71), ``roi_pooling`` (:80), ``box_iou`` (:144), ``box_nms`` (:149)
and the four interleaved attention matmuls of the reference's
``transformer.cc`` (:193-251), over torch.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import apply_op

__all__ = ["roi_align", "roi_pooling", "box_iou", "box_nms",
           "interleaved_matmul_selfatt_qk", "interleaved_matmul_selfatt_valatt",
           "interleaved_matmul_encdec_qk", "interleaved_matmul_encdec_valatt"]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _bilinear(feat, y, x):
    """feat (C, H, W) sampled at the float points (y, x) of any shape:
    (C, *y.shape); points more than one pixel outside read 0."""
    H, W = feat.shape[1], feat.shape[2]
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0

    def at(yy, xx):
        return feat[:, yy.clamp(0, H - 1).long(), xx.clamp(0, W - 1).long()]
    val = (at(y0, x0) * (1 - wy1) * (1 - wx1) + at(y0, x0 + 1) * (1 - wy1)
           * wx1 + at(y0 + 1, x0) * wy1 * (1 - wx1) + at(y0 + 1, x0 + 1)
           * wy1 * wx1)
    valid = (y >= -1) & (y <= H) & (x >= -1) & (x <= W)
    return torch.where(valid, val, torch.zeros_like(val))


def roi_align(data, rois, pooled_size, spatial_scale=1.0, sample_ratio=2,
              position_sensitive=False, aligned=False):
    """(R, C, ph, pw): each bin the mean of sample_ratio^2 bilinear
    samples; rois (R, 5) rows [batch index, x1, y1, x2, y2]."""
    ph, pw = _pair(pooled_size)
    sr = max(sample_ratio, 1)

    def impl(d, r):
        outs = []
        off = (torch.arange(sr, device=d.device, dtype=d.dtype) + 0.5) / sr
        for roi in r:
            b = int(roi[0])
            x1, y1, x2, y2 = (roi[1:] * spatial_scale).unbind()
            bh = torch.clamp(y2 - y1, min=1.0) / ph
            bw = torch.clamp(x2 - x1, min=1.0) / pw
            ys = y1 + (torch.arange(ph, device=d.device)[:, None] + off) * bh
            xs = x1 + (torch.arange(pw, device=d.device)[:, None] + off) * bw
            yy = ys[:, None, :, None].expand(ph, pw, sr, sr)
            xx = xs[None, :, None, :].expand(ph, pw, sr, sr)
            v = _bilinear(d[min(max(b, 0), d.shape[0] - 1)], yy, xx)
            v = v.mean(dim=(-1, -2))
            outs.append(v if b >= 0 else torch.zeros_like(v))
        return torch.stack(outs)
    return apply_op(impl, [data, rois], "roi_align")


def roi_pooling(data, rois, pooled_size, spatial_scale=1.0):
    """(R, C, ph, pw): the max over each bin of the rounded ROI; an empty
    bin gives 0."""
    ph, pw = _pair(pooled_size)

    def impl(d, r):
        N, C, H, W = d.shape
        ys = torch.arange(H, device=d.device, dtype=torch.float32)
        xs = torch.arange(W, device=d.device, dtype=torch.float32)
        outs = []
        for roi in r:
            feat = d[min(max(int(roi[0]), 0), N - 1)]
            x1, y1, x2, y2 = torch.round(roi[1:].float()
                                         * spatial_scale).unbind()
            rh = torch.clamp(y2 - y1 + 1, min=1.0)
            rw = torch.clamp(x2 - x1 + 1, min=1.0)
            iy = torch.arange(ph, device=d.device)[:, None]
            ix = torch.arange(pw, device=d.device)[:, None]
            my = (ys >= y1 + torch.floor(iy * rh / ph)) & \
                (ys < y1 + torch.ceil((iy + 1) * rh / ph))      # (ph, H)
            mx = (xs >= x1 + torch.floor(ix * rw / pw)) & \
                (xs < x1 + torch.ceil((ix + 1) * rw / pw))      # (pw, W)
            mask = my[:, None, :, None] & mx[None, :, None, :]  # ph pw H W
            v = torch.where(mask[None], feat[:, None, None],
                            torch.full((), -float("inf"), dtype=d.dtype,
                                       device=d.device)).amax(dim=(-1, -2))
            outs.append(torch.where(torch.isfinite(v), v,
                                    torch.zeros_like(v)))
        return torch.stack(outs)
    return apply_op(impl, [data, rois], "roi_pooling")


def _corners(b, fmt):
    if fmt == "center":
        return (b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2)
    return b[..., 0], b[..., 1], b[..., 2], b[..., 3]


def _iou(a, b, fmt="corner"):
    ax1, ay1, ax2, ay2 = _corners(a, fmt)
    bx1, by1, bx2, by2 = _corners(b, fmt)
    iw = (torch.minimum(ax2[..., :, None], bx2[..., None, :])
          - torch.maximum(ax1[..., :, None], bx1[..., None, :])).clamp(min=0)
    ih = (torch.minimum(ay2[..., :, None], by2[..., None, :])
          - torch.maximum(ay1[..., :, None], by1[..., None, :])).clamp(min=0)
    inter = iw * ih
    area_a = ((ax2 - ax1) * (ay2 - ay1)).clamp(min=0)
    area_b = ((bx2 - bx1) * (by2 - by1)).clamp(min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def box_iou(lhs, rhs, format="corner"):  # noqa: A002
    return apply_op(lambda a, b: _iou(a, b, format), [lhs, rhs], "box_iou")


def box_nms(data, overlap_thresh=0.5, valid_thresh=0, topk=-1, coord_start=2,
            score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Non-maximum suppression over rows [id?, score, x1, y1, x2, y2,
    ...] of (N, K) or (B, N, K) data: rows come out sorted by score, the
    suppressed (and invalid) ones set to -1."""
    def one(d):
        n = d.shape[0]
        order = torch.argsort(-d[:, score_index], stable=True)
        ds = d[order]
        iou = _iou(ds[:, coord_start:coord_start + 4],
                   ds[:, coord_start:coord_start + 4], in_format)
        keep = ds[:, score_index] > valid_thresh
        same = (ds[:, id_index][:, None] == ds[:, id_index][None, :]) \
            if id_index >= 0 and not force_suppress \
            else torch.ones(n, n, dtype=torch.bool, device=d.device)
        later = torch.arange(n, device=d.device)
        for i in range(n):
            if keep[i]:
                keep = keep & ~((iou[i] > overlap_thresh) & same[i]
                                & (later > i))
        if topk > 0:
            keep = keep & (torch.cumsum(keep.int(), 0) <= topk)
        return torch.where(keep[:, None], ds, torch.full_like(ds, -1.0))

    def impl(d):
        return torch.stack([one(x) for x in d]) if d.dim() == 3 else one(d)
    return apply_op(impl, [data], "box_nms")


def interleaved_matmul_selfatt_qk(queries_keys_values, heads):
    """qkv (T, B, 3 * H * D), per head [q, k, v]: (B * H, T, T) scores of
    q / sqrt(D) against k."""
    def impl(qkv):
        T, B, P = qkv.shape
        D = P // (3 * heads)
        x = qkv.reshape(T, B, heads, 3, D)
        s = torch.einsum("tbhd,sbhd->bhts", x[:, :, :, 0] / D ** 0.5,
                         x[:, :, :, 1])
        return s.reshape(B * heads, T, T)
    return apply_op(impl, [queries_keys_values],
                    "interleaved_matmul_selfatt_qk")


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, heads):
    """attention (B * H, T, T) over the interleaved v: (T, B, H * D)."""
    def impl(qkv, att):
        T, B, P = qkv.shape
        D = P // (3 * heads)
        v = qkv.reshape(T, B, heads, 3, D)[:, :, :, 2]
        out = torch.einsum("bhts,sbhd->tbhd",
                           att.reshape(B, heads, T, T), v)
        return out.reshape(T, B, heads * D)
    return apply_op(impl, [queries_keys_values, attention],
                    "interleaved_matmul_selfatt_valatt")


def interleaved_matmul_encdec_qk(queries, keys_values, heads):
    """q (Tq, B, H * D) against the k of kv (Tk, B, 2 * H * D):
    (B * H, Tq, Tk) scores of q / sqrt(D)."""
    def impl(q, kv):
        Tq, B, Pq = q.shape
        D = Pq // heads
        k = kv.reshape(kv.shape[0], B, heads, 2, D)[:, :, :, 0]
        s = torch.einsum("tbhd,sbhd->bhts",
                         q.reshape(Tq, B, heads, D) / D ** 0.5, k)
        return s.reshape(B * heads, Tq, kv.shape[0])
    return apply_op(impl, [queries, keys_values],
                    "interleaved_matmul_encdec_qk")


def interleaved_matmul_encdec_valatt(keys_values, attention, heads):
    """attention (B * H, Tq, Tk) over the v of kv: (Tq, B, H * D)."""
    def impl(kv, att):
        Tk, B, P = kv.shape
        D = P // (2 * heads)
        v = kv.reshape(Tk, B, heads, 2, D)[:, :, :, 1]
        Tq = att.shape[1]
        out = torch.einsum("bhts,sbhd->tbhd",
                           att.reshape(B, heads, Tq, Tk), v)
        return out.reshape(Tq, B, heads * D)
    return apply_op(impl, [keys_values, attention],
                    "interleaved_matmul_encdec_valatt")
