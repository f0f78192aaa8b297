"""Gluon ``Trainer``: applies an optimizer to a set of parameters.

Counterpart of ``mxnet_tpu/gluon/trainer.py:20-453``.
``step(batch_size)`` sets the optimizer's ``rescale_grad`` to
``rescale_grad / batch_size`` (:274-286; over the loss scale too when an
AMP scaler is attached and the gradients were not unscaled by hand) and
updates every trainable parameter from its ``.grad`` with one
``update_multi_precision`` call over all of them (:385; states from
``create_state_multi_precision``, :105-109), which runs each group of
SGD / NAG / Adam / AdamW / LAMB as one multi-tensor kernel launch on the
card; the update runs on the parameters' own device.

MXNet's ``grad_req="write"`` is not torch's accumulate: a backward in
MXNet overwrites the gradient, torch adds to it.  So after each update
the Trainer sets the updated parameters' ``.grad`` to ``None``, and the
next backward writes them fresh.  ``None`` is also how the Trainer tells
a stale gradient: a trainable parameter that no backward reached since
the last step has ``.grad is None`` and raises the stale-gradient
``UserWarning`` (:241-247), unless ``ignore_stale_grad=True`` skips it.
A parameter with ``grad_req="add"`` keeps its gradient across steps, as
in MXNet: the caller zeroes it (``zero_grad``).

The kvstore (``kvstore=``: a type name of ``mx.kv.create`` or a store;
:mod:`mxnet_tpu_torch.kvstore`) is made at the first step (:70-90).  A
store with more than one worker first broadcasts every parameter from
worker 0, and ``step`` sums the gradients over the workers
(``pushpull``) before the update; ``compression_params`` set its
gradient compression.  ``update_on_kvstore=True`` keeps the weights in
the store and runs the optimizer there: ``step`` pushes each fresh
gradient and pulls the updated weight back, after the stale-gradient
check, so a raising step leaves every weight as it was; ``update`` and
``allreduce_grads`` then raise ``ValueError``, and ``save_states`` /
``load_states`` go through the store.

The profiler's step seams are the reference's (``gluon/trainer.py``
:166-194, :303-358): with ``profile_imperative`` on, ``step`` records
``Trainer::step`` (and bumps ``trainer::steps``), the gradient sum
``Trainer::allreduce`` and the update ``Trainer::update``; with
``profile_memory`` each step samples the cards' memory.  Off, each seam
costs one flag read.

Low precision and the fault guard (:150-300, :326-380): an AMP loss
scaler (``amp.init_trainer``) drops a batch whose gradients overflow
(the scale halves, the weights stay) and grows the scale after its
window of clean steps; ``step(skip_nonfinite=True)``, or a
``fault.GradGuard`` attached, skips a non-finite batch, backs the scale
off and counts ``fault::nonfinite_steps``.  Either check is
``fault.grads_finite``: one ``multi_all_finite`` kernel launch over the
fresh gradients and one host sync, and a "finite" verdict of the guard
spares the scaler a second check.  The checks run after the stale-
gradient check and before any update or push, so a skipped step leaves
every weight as it was; its gradients count as consumed.  The step seam
delivers the ``fault`` harness's step faults (``nan_grad``, ``preempt``,
``peer_preempt``), and with a step heartbeat installed
(``fault_dist.enable_step_heartbeat``) ``step`` beats it after the
kvstore is made (reference :166-182): a hung peer surfaces as a
``PeerLostError`` there, and under a step lease the beat is the step's
aggregate vote.  :meth:`reset_kvstore` (reference :112-142) detaches the
store, so the next step rebuilds it over the current world (the elastic
resize), carrying an ``update_on_kvstore`` store's optimizer states
over.

``save_states`` / ``load_states`` (:403, :428) write and read the
optimizer states as one npz with the JAX Trainer's keys: ``s<i>_<j>``
for item ``j`` of parameter ``i``'s state, ``s<i>_<j>_<k>`` inside a
nested tuple (the state beside a ``multi_precision`` master copy), and
``__meta_num_update__``; a file either Trainer writes loads into the
other.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import fault as _fault
from .. import optimizer as opt_mod
from .. import profiler as _profiler
from . import parameter as param_mod
from ..utils import serialization

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            self._param_names = list(params.keys())
            params = list(params.values())
        elif isinstance(params, (list, tuple)):
            self._param_names = [str(i) for i in range(len(params))]
            params = list(params)
        else:
            raise ValueError("params must be a dict or list of Parameters, "
                             "got %s" % type(params))
        for p in params:
            if not isinstance(p, nn.Parameter):
                raise ValueError("Invalid parameter %r" % (p,))
        self._params = params
        self._compression_params = compression_params
        self._kvstore_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = update_on_kvstore
        optimizer_params = optimizer_params or {}
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        param_dict = dict(enumerate(params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and \
                    list(optimizer_params) != ["rescale_grad"]:
                raise ValueError("optimizer_params must be None if "
                                 "optimizer is an instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer,
                                             param_dict=param_dict,
                                             **optimizer_params)
        self._states = [None] * len(params)
        self._grad_guard = None
        self._pending_opt_states = None

    @property
    def optimizer(self):
        return self._optimizer

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_kvstore(self):
        from .. import kvstore as kv_mod
        if self._kvstore_type is None:
            self._kvstore = None
        elif isinstance(self._kvstore_type, str):
            self._kvstore = kv_mod.create(self._kvstore_type)
        else:
            self._kvstore = self._kvstore_type
        kv = self._kvstore
        if kv is not None and self._compression_params:
            kv.set_gradient_compression(self._compression_params)
        self._kv_initialized = True
        if kv is not None and kv.num_workers > 1:
            # the replicas start from worker 0's parameters
            for i, p in enumerate(self._params):
                kv.broadcast(i, p.data(), p.data())
        if kv is not None and self._update_on_kvstore:
            for i, p in enumerate(self._params):
                kv.init(i, p.data())
            kv.set_optimizer(self._optimizer)
            carried = self._pending_opt_states
            if carried and hasattr(kv, "_opt_states"):
                kv._opt_states.update(carried)
            self._pending_opt_states = None

    def reset_kvstore(self, kvstore=None, update_on_kvstore=None):
        """Detach the kvstore so the next ``step`` rebuilds it over the
        CURRENT world: the Trainer's side of an elastic resize.  After a
        re-bootstrap the old store describes the old world; its
        ``update_on_kvstore`` optimizer states are carried onto the
        rebuilt store, so Adam / momentum resume rather than restart.
        ``kvstore`` / ``update_on_kvstore`` override the original
        settings when given."""
        carried = None
        if self._kvstore is not None:
            carried = getattr(self._kvstore, "_opt_states", None)
        from ..kvstore import kvstore as _kvs
        _kvs.reset_distributed()
        if kvstore is not None:
            self._kvstore_type = kvstore
        if update_on_kvstore is not None:
            self._update_on_kvstore = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._pending_opt_states = carried if self._update_on_kvstore \
            else None

    def _on_kvstore(self):
        return bool(self._update_on_kvstore) and self._kvstore is not None

    def allreduce_grads(self):
        """Sum the gradients over the kvstore's workers (nothing with one
        worker)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._on_kvstore():
            raise ValueError(
                "allreduce_grads() is not supported when "
                "update_on_kvstore=True: aggregation and update are one "
                "server-side push")
        self._allreduce_grads()

    def _allreduce_grads(self):
        kv = self._kvstore
        if kv is None or kv.num_workers <= 1:
            return
        prof_t0 = _profiler._now_us() if _profiler._STEP else None
        for i, p in enumerate(self._params):
            if p.requires_grad and param_mod.grad_of(p) is not None:
                g = p.grad()
                kv.pushpull(i, g, out=g, priority=-i)
        if prof_t0 is not None:
            _profiler.record_duration(
                "Trainer::allreduce", "trainer", prof_t0,
                _profiler._now_us() - prof_t0)

    def step(self, batch_size, ignore_stale_grad=False,
             skip_nonfinite=False):
        """Sum the gradients over the workers, then update every
        trainable parameter from its gradient, rescaled by
        ``rescale_grad / batch_size`` (on the kvstore with
        ``update_on_kvstore``).  With ``skip_nonfinite`` (or a
        ``fault.GradGuard`` attached) a batch with an inf or NaN gradient
        updates nothing."""
        prof_t0 = _profiler._now_us() if _profiler._STEP else None
        if _fault._ACTIVE:
            _fault.step_hook(self)
        if not self._kv_initialized:
            self._init_kvstore()
        if _fault._DIST_HEARTBEAT is not None:
            # the step-boundary peer-health allgather, after the store
            # is made (it may bootstrap the job the beat votes over)
            _fault._DIST_HEARTBEAT.beat(
                step=getattr(self._optimizer, "num_update", None))
        self._optimizer.rescale_grad = self._grad_rescale(batch_size)
        if self._on_kvstore():
            self._step_on_kvstore(ignore_stale_grad, skip_nonfinite)
        else:
            self._allreduce_grads()
            self._update(ignore_stale_grad, skip_nonfinite)
        if prof_t0 is not None:
            _profiler.record_duration(
                "Trainer::step", "trainer", prof_t0,
                _profiler._now_us() - prof_t0,
                args={"batch_size": batch_size})
            _profiler.counter_add("trainer::steps", 1, cat="trainer")
        if _profiler._MEMORY:  # profile_memory alone samples too
            _profiler.record_memory()

    def _fresh(self, ignore_stale_grad):
        """Indices of the trainable parameters with a fresh gradient;
        a stale one raises (before anything is updated) unless
        ``ignore_stale_grad``."""
        fresh = []
        for i, p in enumerate(self._params):
            if not p.requires_grad:
                continue
            if param_mod.grad_of(p) is None:
                if not ignore_stale_grad:
                    raise UserWarning(self._stale_msg(self._param_names[i]))
                continue
            fresh.append(i)
        return fresh

    def _consume(self, fresh):
        for i in fresh:
            p = self._params[i]
            if getattr(p, "grad_req", "write") != "add":
                p.grad = None   # "write": the next backward writes

    def _skip_nonfinite_step(self, fresh, skip_nonfinite):
        """The step guard: when on (``skip_nonfinite`` or a GradGuard)
        and a fresh gradient is not finite, consume the gradients
        without an update, back off the AMP scale and count the skip.
        "skip" when skipped, "finite" when checked and finite (the
        scaler need not check again), None when the guard is off."""
        guard = self._grad_guard
        if not (skip_nonfinite or guard is not None):
            return None
        if _fault.grads_finite([self._params[i] for i in fresh]):
            if guard is not None:
                guard._record_ok()
            return "finite"
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            scaler.update_scale(True)
        _profiler.counter_bump("fault::nonfinite_steps", 1, cat="fault")
        self._consume(fresh)
        if guard is not None:
            guard._record_skip()      # may raise after max_consecutive
        return "skip"

    def _checked(self, fresh, skip_nonfinite):
        """Whether the update of ``fresh`` goes ahead: the guard, then
        the AMP scaler (an overflowed batch is dropped: the scale halves,
        the gradients are consumed, the weights stay).  A batch with no
        fresh gradient carries no evidence and moves neither."""
        if not fresh:
            return True
        verdict = self._skip_nonfinite_step(fresh, skip_nonfinite)
        if verdict == "skip":
            return False
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is None:
            return True
        overflow = False if verdict == "finite" else \
            scaler.has_overflow([self._params[i] for i in fresh])
        scaler.update_scale(overflow)
        if overflow:
            self._consume(fresh)
        return not overflow

    def _grad_rescale(self, batch_size):
        """``rescale_grad / batch_size``, over the loss scale when a
        scaler is attached, unless ``amp.unscale`` divided the gradients
        already: its flag is read (and cleared) here, so it covers exactly
        this step attempt, even one that then raises stale."""
        scale = self._scale / batch_size
        scaler = getattr(self, "_amp_loss_scaler", None)
        if scaler is not None:
            manual = scaler._manual_unscaled
            scaler._manual_unscaled = False
            if not manual:
                scale /= scaler.loss_scale
        return scale

    def _step_on_kvstore(self, ignore_stale_grad, skip_nonfinite=False):
        """push(grad) runs the store's optimizer on its weight, pull
        brings the weight back; the guard and the scaler decide first, so
        a skipped step pushes nothing."""
        kv = self._kvstore
        fresh = self._fresh(ignore_stale_grad)
        if not self._checked(fresh, skip_nonfinite):
            return
        for i in fresh:
            p = self._params[i]
            kv.push(i, p.grad(), priority=-i)
            kv.pull(i, out=p.data(), priority=-i)
        self._consume(fresh)

    def update(self, batch_size, ignore_stale_grad=False,
               skip_nonfinite=False):
        if not self._kv_initialized:
            self._init_kvstore()
        if self._on_kvstore():
            raise ValueError(
                "update() is not supported when update_on_kvstore=True: "
                "a local update would diverge from the store's weights; "
                "call step()")
        self._optimizer.rescale_grad = self._grad_rescale(batch_size)
        self._update(ignore_stale_grad, skip_nonfinite)

    def _update(self, ignore_stale_grad, skip_nonfinite=False):
        prof_t0 = _profiler._now_us() if _profiler._STEP else None
        fresh = self._fresh(ignore_stale_grad)
        for i in fresh:
            if self._states[i] is None:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(
                        i, self._params[i].data)
        if not self._checked(fresh, skip_nonfinite):
            if prof_t0 is not None:
                _profiler.record_duration(
                    "Trainer::update", "trainer", prof_t0,
                    _profiler._now_us() - prof_t0, args={"skipped": True})
            return
        if fresh:
            self._optimizer.update_multi_precision(
                fresh, [self._params[i].data for i in fresh],
                [self._params[i].grad for i in fresh],
                [self._states[i] for i in fresh])
        self._consume(fresh)
        if prof_t0 is not None:
            _profiler.record_duration(
                "Trainer::update", "trainer", prof_t0,
                _profiler._now_us() - prof_t0)

    def _init_states(self):
        for i, p in enumerate(self._params):
            if p.requires_grad and self._states[i] is None:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(i, p.data)

    def _flat_states(self):
        """``{key: tensor}`` of every state, by the JAX Trainer's keys."""
        flat = {}
        for i, st in enumerate(self._states):
            items = st if isinstance(st, tuple) else (st,)
            for j, s in enumerate(items):
                if isinstance(s, torch.Tensor):
                    flat["s%d_%d" % (i, j)] = s
                elif isinstance(s, tuple):
                    for k, ss in enumerate(s):
                        flat["s%d_%d_%d" % (i, j, k)] = ss
        return flat

    def save_states(self, fname):
        """The optimizer states and its update count, as one npz (with
        ``update_on_kvstore``, the store's states, its own format)."""
        if self._on_kvstore():
            self._kvstore.save_optimizer_states(fname)
            return
        flat = self._flat_states()
        flat["__meta_num_update__"] = torch.tensor(
            self._optimizer.num_update, dtype=torch.int32)
        serialization.savez(fname, **flat)

    def load_states(self, fname):
        """Fill the optimizer states (made first where missing) and the
        update count from a :meth:`save_states` file; a state the file
        does not hold keeps its value."""
        if self._update_on_kvstore and self._kvstore_type is not None:
            if not self._kv_initialized:
                self._init_kvstore()
            self._kvstore.load_optimizer_states(fname)
            return
        loaded = serialization.load(fname, device="cpu")
        meta = loaded.pop("__meta_num_update__", None)
        if meta is not None:
            self._optimizer.num_update = int(meta._data.item())
        self._init_states()
        with torch.no_grad():
            for key, s in self._flat_states().items():
                if key in loaded:
                    s.copy_(loaded[key]._data)

    @staticmethod
    def _stale_msg(name):
        return ("Gradient of Parameter `%s` was not updated by backward "
                "since the last trainer step.  If the model "
                "intentionally used only a subset of its parameters "
                "this iteration, call step/update with "
                "ignore_stale_grad=True to skip them." % name)
