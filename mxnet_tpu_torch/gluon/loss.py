"""Gluon losses.

Counterpart of ``mxnet_tpu/gluon/loss.py``: ``Loss`` with
``_mean_over_nonbatch`` (:20-60), ``L2Loss``, ``L1Loss``,
``SigmoidBinaryCrossEntropyLoss`` (alias ``SigmoidBCELoss``; ``pos_weight``,
``from_sigmoid``), ``SoftmaxCrossEntropyLoss`` (alias ``SoftmaxCELoss``;
sparse or dense labels, ``from_logits``), ``KLDivLoss``, ``HuberLoss``,
``HingeLoss``, ``SquaredHingeLoss``, ``LogisticLoss``, ``TripletLoss``,
``PoissonNLLLoss``, ``CosineEmbeddingLoss`` and ``SDMLLoss``
(:73-323), each with the reference's arithmetic, so values and
gradients match it.  Most return the per-sample loss, averaged over
every axis but ``batch_axis``; ``TripletLoss`` and
``CosineEmbeddingLoss`` return it unaveraged, ``PoissonNLLLoss`` the
mean over everything, as there.  ``CTCLoss`` waits for ROADMAP queue 5.
"""
from __future__ import annotations

import math

import torch

from ..ops import nn as F
from .block import Block

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss"]


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


def _softplus_neg_abs(pred):
    """``log(1 + exp(-|pred|))``, in the reference's spelling."""
    return torch.log(1 + torch.exp(-pred.abs()))


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy on logits (or on probabilities with
    ``from_sigmoid``); ``pos_weight`` weighs the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.clamp(pred, min=0) - pred * label + \
                    _softplus_neg_abs(pred)
            else:
                loss = (1 - label) * pred + \
                    (1 + (pos_weight - 1) * label) * \
                    (_softplus_neg_abs(pred) + torch.clamp(-pred, min=0))
        else:
            eps = 1e-12
            pos = torch.log(pred + eps) * label
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log(1 - pred + eps) * (1 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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


class KLDivLoss(Loss):
    """``label * (log(label) - pred)``, ``pred`` log-probabilities
    (``from_logits=True``) or logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = F.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class CTCLoss(Loss):
    """Not ported yet (ROADMAP queue 5)."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        raise NotImplementedError("mxnet_tpu_torch: CTCLoss is not ported "
                                  "yet (ROADMAP queue 5)")


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = (label - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss.square())
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.clamp(self._margin - pred * label, min=0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        loss = torch.clamp(self._margin - pred * label, min=0).square()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class LogisticLoss(Loss):
    """The logistic loss of a logit; labels in {-1, 1} (``"signed"``) or
    {0, 1} (``"binary"``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format can only be signed or binary, "
                             "got %r" % (label_format,))
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.clamp(pred, min=0) - pred * label + \
            _softplus_neg_abs(pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_over_nonbatch(loss)


class TripletLoss(Loss):
    """``max(|pred - positive|^2 - |pred - negative|^2 + margin, 0)``,
    the squares summed over every axis but the first; per sample, not
    averaged."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        loss = (pred - positive).square() - (pred - negative).square()
        dims = tuple(range(1, loss.dim()))
        loss = loss.sum(dim=dims) if dims else loss
        loss = torch.clamp(loss + self._margin, min=0)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """The Poisson negative log-likelihood of ``target`` under the rate
    ``exp(pred)`` (``from_logits``) or ``pred``, with Stirling's term
    where ``compute_full``; the mean over every element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + 1e-12) - target + \
                0.5 * torch.log(2 * math.pi * (target + 1e-12))
            stirling = torch.where(target <= 1, torch.zeros_like(stirling),
                                   stirling)
            loss = loss + stirling
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` where ``label`` is 1, else
    ``max(cos - margin, 0)``; per sample, not averaged."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = _reshape_like(input2, input1)
        cos = (input1 * input2).sum(dim=-1) / (
            input1.square().sum(dim=-1).sqrt() *
            input2.square().sum(dim=-1).sqrt() + 1e-12)
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1 - cos,
                           torch.clamp(cos - self._margin, min=0))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Smoothed Deep Metric Learning (reference ``loss.py:997``): rows
    ``i`` of ``x1`` and ``x2`` are pairs and the rest of the batch their
    negatives; the KL divergence between ``softmax(-distances)`` over
    each row and the label-smoothed identity."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    def forward(self, x1, x2):
        batch_size = x1.shape[0]
        if batch_size < 2:
            raise ValueError(
                "SDMLLoss needs batch_size >= 2 (in-batch negatives); got "
                "%d: drop or pad remainder batches" % batch_size)
        distances = (x1.unsqueeze(1) - x2.unsqueeze(0)).square().sum(dim=2)
        gold = torch.eye(batch_size, dtype=distances.dtype,
                         device=distances.device)
        labels = gold * (1 - self.smoothing_parameter) + \
            (1 - gold) * self.smoothing_parameter / (batch_size - 1)
        return self.kl_loss(F.log_softmax(-distances, axis=1), labels)
