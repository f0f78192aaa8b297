"""Evaluation metrics (counterpart of ``mxnet_tpu/gluon/metric.py``):
``Accuracy``, ``TopKAccuracy``, ``F1``, ``MCC``, ``Fbeta``,
``BinaryAccuracy``, ``MAE`` / ``MSE`` / ``RMSE``, ``CrossEntropy`` /
``NegativeLogLikelihood``, ``Perplexity``, ``PearsonCorrelation``,
``PCC``, ``MeanCosineSimilarity``, ``Loss``, ``CustomMetric``,
``CompositeEvalMetric``, the registry and ``create``.

The reference reads every label and prediction to the host in
``update`` (``.asnumpy()``: one synchronizing copy a batch).  The port
keeps each metric's accumulators on the device of its inputs -- sums in
float64, counts in int64 -- and ``update`` runs only device operations,
so a training loop that updates a metric every step adds no host
transfer.  ``get()`` copies the accumulators to the host once.  Counts
that the inputs' shapes give are kept as Python integers.
``PearsonCorrelation`` and ``PCC`` keep their inputs until ``get()``;
``CustomMetric`` calls its numpy ``feval`` in ``update``, so it reads
each batch to the host, as the reference does.  Element-wise values are
computed in float32 (or the inputs' wider dtype) and summed in float64.
"""
from __future__ import annotations

import math
import numbers

import numpy as _onp
import torch

from ..ndarray.ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Fbeta", "BinaryAccuracy", "MAE", "MSE", "RMSE",
           "CrossEntropy", "NegativeLogLikelihood", "Perplexity",
           "PearsonCorrelation", "PCC", "MeanCosineSimilarity", "Loss",
           "CustomMetric", "create", "register", "np", "check_label_shapes"]


class _Registry:
    """Metric classes by lower-cased name."""

    def __init__(self):
        self._store = {}

    def register(self, name=None):
        def deco(cls):
            self._store[(name or cls.__name__).lower()] = cls
            return cls
        return deco

    def create(self, name, *args, **kwargs):
        key = name.lower()
        if key not in self._store:
            raise KeyError("metric %r not registered; known: %s"
                           % (name, sorted(self._store)))
        return self._store[key](*args, **kwargs)


_registry = _Registry()
register = _registry.register


def _t(x):
    """The tensor of an NDArray, tensor or array (numpy stays on the
    host, as a CPU tensor)."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(_onp.asarray(x))


def _f(x):
    """``x`` in float32, or its own wider floating dtype."""
    return x if x.dtype == torch.float64 else x.to(torch.float32)


def _on(x, like):
    return x if x.device == like.device else x.to(like.device)


def _host(*values):
    """Python numbers of ``values`` (numbers or tensors), the tensors
    read to the host in one copy."""
    ts = [v for v in values if isinstance(v, torch.Tensor)]
    if not ts:
        return values
    dev = ts[0].device
    host = iter(torch.stack([v.detach().to(dev, torch.float64).reshape(())
                             for v in ts]).tolist())
    return tuple(next(host) if isinstance(v, torch.Tensor) else v
                 for v in values)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Lists of labels and predictions of equal length (a single array
    is wrapped)."""
    if isinstance(labels, (NDArray, torch.Tensor)):
        labels = [labels]
    if isinstance(preds, (NDArray, torch.Tensor)):
        preds = [preds]
    if len(labels) != len(preds):
        raise ValueError("labels and predictions have different lengths")
    return labels, preds


class EvalMetric:
    """The base: ``update(labels, preds)``, ``get()`` -> (name, value),
    ``reset()``; ``sum_metric`` / ``num_inst`` read the accumulators
    (a host copy where they are on the device)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        config = self._kwargs.copy()
        config.update({"metric": self.__class__.__name__, "name": self.name,
                       "output_names": self.output_names,
                       "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self._sum = 0.0
        self._num = 0

    @property
    def sum_metric(self):
        return _host(self._sum)[0]

    @sum_metric.setter
    def sum_metric(self, value):
        self._sum = value

    @property
    def num_inst(self):
        n = _host(self._num)[0]
        return int(n) if isinstance(n, float) and n.is_integer() else n

    @num_inst.setter
    def num_inst(self, value):
        self._num = value

    def _add(self, total, count):
        """Add ``total`` (a tensor, summed in float64 on its device, or a
        number) and ``count`` to the accumulators."""
        if isinstance(total, torch.Tensor):
            total = total.to(torch.float64)
            self._sum = total + self._sum if not isinstance(
                self._sum, torch.Tensor) else self._sum + total
        else:
            self._sum = self._sum + total
        if isinstance(count, torch.Tensor) and \
                isinstance(self._num, torch.Tensor):
            self._num = self._num + count
        elif isinstance(count, torch.Tensor):
            self._num = count.to(torch.int64) + self._num
        else:
            self._num = self._num + count

    def _value(self, s, n):
        return s / n

    def get(self):
        s, n = _host(self._sum, self._num)
        if n == 0:
            return (self.name, float("nan"))
        return (self.name, self._value(s, n))

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


def create(metric, *args, **kwargs):
    """A metric from an instance, a callable (``CustomMetric``), a list
    (``CompositeEvalMetric``) or a registered name."""
    if isinstance(metric, EvalMetric):
        return metric
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    return _registry.create(metric, *args, **kwargs)


@register("composite")
@register()
class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get()`` gives their names and
    values as lists."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = metrics if metrics is not None else []

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        super().reset()
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, numbers.Number):
                value = [value]
            names.extend(name)
            values.extend(value)
        return names, values


@register("acc")
@register()
class Accuracy(EvalMetric):
    """The share of predictions (the argmax over ``axis`` where ``pred``
    has more axes than the label) equal to the label."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _t(label), _t(pred)
            if pred.dim() > label.dim():
                pred = pred.argmax(dim=self.axis)
            pred = pred.to(torch.int32).reshape(-1)
            label = _on(label.to(torch.int32).reshape(-1), pred)
            self._add((pred == label).sum(), label.numel())


@register("top_k_accuracy")
@register("top_k_acc")
@register()
class TopKAccuracy(EvalMetric):
    """The share of labels among the ``top_k`` largest predictions."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert self.top_k > 1, "use Accuracy for top_k=1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label, pred = _t(label), _t(pred)
            assert pred.dim() == 2
            top = torch.topk(pred, self.top_k, dim=1).indices
            label = _on(label.to(torch.int32).reshape(-1, 1), top)
            self._add((top == label).sum(), label.shape[0])


class _BinaryClassificationMetrics:
    """True / false positive / negative counts (int64, on the inputs'
    device) of a thresholded binary prediction."""

    def __init__(self, threshold=0.5):
        self.threshold = threshold
        self.reset_stats()

    def update_binary_stats(self, label, pred):
        label, pred = _t(label), _t(pred)
        label = label.reshape(-1).to(torch.int32)
        if pred.dim() > 1 and pred.shape[-1] > 1:
            pred = pred[..., 1]
        pred_label = (pred.reshape(-1) > self.threshold).to(torch.int32)
        label = _on(label, pred_label)
        stats = torch.stack([
            ((pred_label == 1) & (label == 1)).sum(),
            ((pred_label == 1) & (label == 0)).sum(),
            ((pred_label == 0) & (label == 0)).sum(),
            ((pred_label == 0) & (label == 1)).sum()])
        self._stats = stats if self._stats is None else \
            self._stats + _on(stats, self._stats)

    def _counts(self):
        """(tp, fp, tn, fn) as float64 tensors (zeros before any
        update)."""
        s = self._stats if self._stats is not None else \
            torch.zeros(4, dtype=torch.int64)
        return tuple(s.to(torch.float64))

    @staticmethod
    def _ratio(a, b):
        return torch.where(b > 0, a / torch.where(b > 0, b, 1.0), 0.0)

    def _precision(self):
        tp, fp, _, _ = self._counts()
        return self._ratio(tp, tp + fp)

    def _recall(self):
        tp, _, _, fn = self._counts()
        return self._ratio(tp, tp + fn)

    def _fbeta(self, beta=1):
        p, r = self._precision(), self._recall()
        b2 = beta * beta
        return self._ratio((1 + b2) * p * r, b2 * p + r)

    def _mcc(self):
        tp, fp, tn, fn = self._counts()
        denom = torch.ones((), dtype=torch.float64, device=tp.device)
        for t in (tp + fp, tp + fn, tn + fp, tn + fn):
            denom = denom * torch.where(t != 0, t, 1.0)
        return (tp * tn - fp * fn) / denom.sqrt()

    def _total(self):
        return self._stats.sum() if self._stats is not None else 0

    @property
    def precision(self):
        return _host(self._precision())[0]

    @property
    def recall(self):
        return _host(self._recall())[0]

    @property
    def fscore(self):
        return _host(self._fbeta())[0]

    @property
    def matthewscc(self):
        return _host(self._mcc())[0]

    @property
    def total_examples(self):
        return int(_host(self._total())[0])

    def reset_stats(self):
        self._stats = None


class _BinaryMetric(EvalMetric):
    """F1 / MCC / Fbeta: per update (``average="macro"``) or over all
    updates (``"micro"``)."""

    def __init__(self, name, output_names, label_names, average, threshold):
        self.average = average
        self.metrics = _BinaryClassificationMetrics(threshold)
        super().__init__(name, output_names, label_names)

    def _score(self):
        raise NotImplementedError

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        score = self._score()
        if self.average == "macro":
            self._add(score, 1)
            self.metrics.reset_stats()
        else:
            total = self.metrics._total()
            self._sum, self._num = score * total, total

    def reset(self):
        super().reset()
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register()
class F1(_BinaryMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro", threshold=0.5):
        super().__init__(name, output_names, label_names, average,
                         threshold)

    def _score(self):
        return self.metrics._fbeta()


@register()
class MCC(_BinaryMetric):
    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro", threshold=0.5):
        super().__init__(name, output_names, label_names, average,
                         threshold)

    def _score(self):
        return self.metrics._mcc()


@register()
class Fbeta(_BinaryMetric):
    """The F-beta score: ``beta`` weighs recall."""

    def __init__(self, name="fbeta", output_names=None, label_names=None,
                 average="macro", threshold=0.5, beta=1):
        super().__init__(name, output_names, label_names, average,
                         threshold)
        self.beta = beta

    def _score(self):
        return self.metrics._fbeta(self.beta)


def _diff(label, pred):
    label, pred = _t(label), _t(pred)
    label = _on(label, pred)
    return _f(label) - _f(pred).reshape(label.shape), label.shape[0]


@register()
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            d, n = _diff(label, pred)
            self._add(d.abs().to(torch.float64).mean() * n, n)


@register()
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            d, n = _diff(label, pred)
            self._add((d * d).to(torch.float64).mean() * n, n)


@register()
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def _value(self, s, n):
        return math.sqrt(s / n)


def _picked(label, pred):
    """``pred[i, label[i]]`` for each row (``label`` flattened)."""
    label, pred = _t(label), _t(pred)
    label = _on(label.reshape(-1).to(torch.int64), pred)
    pred = pred.reshape(label.shape[0], -1)
    rows = torch.arange(label.shape[0], device=pred.device)
    return _f(pred[rows, label]), label


@register("ce")
@register()
class CrossEntropy(EvalMetric):
    """The mean of ``-log(p[label] + eps)`` over samples; ``pred`` holds
    probabilities."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            assert _t(label).reshape(-1).shape[0] == _t(pred).shape[0]
            prob, label = _picked(label, pred)
            self._add((-torch.log(prob + self.eps)).to(torch.float64).sum(),
                      label.shape[0])


@register("nll_loss")
@register()
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register()
class Perplexity(EvalMetric):
    """``exp`` of the mean ``-log(max(1e-10, p[label]))`` over the tokens
    whose label is not ``ignore_label``; ``pred`` holds probabilities."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            probs, label = _picked(label, pred)
            num = label.shape[0]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                probs = torch.where(ignore, 1.0, probs)
                num = num - ignore.sum()
            self._add(-torch.log(torch.clamp_min(probs, 1e-10)).to(
                torch.float64).sum(), num)

    def _value(self, s, n):
        return math.exp(s / n)


@register("pearsonr")
@register()
class PearsonCorrelation(EvalMetric):
    """Pearson's r of all labels and predictions, kept (on their device)
    until ``get()``."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def reset(self):
        super().reset()
        self._labels = []
        self._preds = []

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _t(pred)
            self._labels.append(_on(_t(label), pred).reshape(-1))
            self._preds.append(pred.reshape(-1))
            self._num += 1

    def get(self):
        if self._num == 0:
            return (self.name, float("nan"))
        lab = torch.cat([x.to(torch.float64) for x in self._labels])
        prd = torch.cat([x.to(torch.float64) for x in self._preds])
        both = torch.stack([lab, _on(prd, lab)]).cpu().numpy()
        return (self.name, float(_onp.corrcoef(both[0], both[1])[0, 1]))


@register()
class Loss(EvalMetric):
    """The mean of the given loss values."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        if isinstance(preds, (NDArray, torch.Tensor)):
            preds = [preds]
        for pred in preds:
            pred = _t(pred)
            self._add(_f(pred).to(torch.float64).sum(), pred.numel())


@register()
class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays (each batch read to the
    host), returning a value or (sum, count)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = getattr(feval, "__name__", "custom")
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_t(label).detach().cpu().numpy(),
                                _t(pred).detach().cpu().numpy())
            if isinstance(reval, tuple):
                self._add(*reval)
            else:
                self._add(reval, 1)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A ``CustomMetric`` of a numpy function."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


@register()
class BinaryAccuracy(EvalMetric):
    """The share of ``pred > threshold`` equal to ``label > 0.5``."""

    def __init__(self, name="binary_accuracy", output_names=None,
                 label_names=None, threshold=0.5):
        super().__init__(name, output_names, label_names)
        self.threshold = threshold

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _t(pred)
            lab = _on(_t(label), pred).reshape(-1)
            prd = pred.reshape(-1) > self.threshold
            self._add((prd == (lab > 0.5)).sum(), lab.numel())


@register()
class MeanCosineSimilarity(EvalMetric):
    """The mean cosine similarity of labels and predictions along the
    last axis."""

    def __init__(self, name="cos_sim", output_names=None,
                 label_names=None, eps=1e-12):
        super().__init__(name, output_names, label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            prd = _f(_t(pred))
            lab = _f(_on(_t(label), prd))
            if lab.dim() == 1:
                lab, prd = lab[None], prd[None]
            num = (lab * prd).sum(-1)
            den = (lab * lab).sum(-1).sqrt() * (prd * prd).sum(-1).sqrt()
            sim = num / torch.clamp_min(den, self.eps)
            self._add(sim.to(torch.float64).sum(), sim.numel())


@register()
class PCC(EvalMetric):
    """The multiclass Pearson correlation of the confusion matrix (MCC
    generalized); labels and predicted classes are kept until
    ``get()``."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def reset(self):
        super().reset()
        self._pairs = []

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            prd = _t(pred)
            if prd.dim() > 1:
                prd = prd.argmax(-1)
            prd = prd.reshape(-1).to(torch.int64)
            lab = _on(_t(label).reshape(-1).to(torch.int64), prd)
            self._pairs.append(torch.stack([lab, prd]))
            self._num += lab.numel()

    def get(self):
        if not self._pairs:
            return (self.name, float("nan"))
        lab, prd = torch.cat(self._pairs, dim=1).cpu().numpy()
        k = int(max(lab.max(), prd.max())) + 1
        c = _onp.zeros((k, k), _onp.float64)
        _onp.add.at(c, (lab, prd), 1)
        n = c.sum()
        t = c.sum(axis=1)
        p = c.sum(axis=0)
        cov_tp = (c.trace() * n - (t * p).sum())
        cov_tt = (n * n - (t * t).sum())
        cov_pp = (n * n - (p * p).sum())
        denom = math.sqrt(cov_tt * cov_pp)
        return (self.name, float(cov_tp / denom) if denom else 0.0)
