"""Gluon losses of the training path.

Counterpart of ``mxnet_tpu/gluon/loss.py:20-60,105-128``: ``Loss`` with
``_mean_over_nonbatch``, ``L2Loss``, ``L1Loss`` and
``SoftmaxCrossEntropyLoss`` (alias ``SoftmaxCELoss``; sparse or dense
labels, ``from_logits``).  Each returns the per-sample loss, averaged
over every axis but ``batch_axis``.  The other losses of the JAX
package are not ported yet.
"""
from __future__ import annotations

from ..ops import nn as F
from .block import Block

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    if pred.shape != label.shape:
        label = label.reshape(pred.shape)
    return label


class Loss(Block):
    def __init__(self, weight=None, batch_axis=0):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def extra_repr(self):
        return "batch_axis=%s, w=%s" % (self._batch_axis, self._weight)

    def _mean_over_nonbatch(self, loss):
        dims = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=dims) if dims else loss


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (label - pred).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_over_nonbatch(loss)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (label - pred).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class SoftmaxCrossEntropyLoss(Loss):
    """Softmax cross-entropy: sparse (class index) or dense (one
    distribution per row) labels; ``from_logits=True`` takes
    log-probabilities as they are."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -F.pick(pred, label, axis=self._axis)
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
