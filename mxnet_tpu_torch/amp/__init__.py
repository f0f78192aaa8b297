"""``mx.amp`` -- automatic mixed precision.

Counterpart of ``mxnet_tpu/amp/__init__.py`` (the reference's
``python/mxnet/amp/``): :func:`init` picks the low-precision dtype
(float16 attaches a dynamic :class:`LossScaler` prototype; bfloat16
needs none), :func:`init_trainer` gives a Trainer its own scaler,
:func:`scale_loss` multiplies the loss by the scale before backward, the
Trainer divides it back out of the gradients at its step (or
:func:`unscale` does it by hand, for clipping before ``step``) and drops
a batch that overflowed (``gluon/trainer.py``);
:func:`convert_hybrid_block` casts a block to the low-precision dtype
and keeps its norms (BatchNorm, LayerNorm, GroupNorm, InstanceNorm) in
float32.  The op lists are documentation of the policy the port's ops
implement (float32 statistics inside the norms and softmaxes).
"""
from __future__ import annotations

import numpy as _onp
import torch

from ..gluon.parameter import grad_of
from .lists import FP16_FP32_FUNCS, FP16_FUNCS, FP32_FUNCS
from .loss_scaler import LossScaler

__all__ = ["init", "init_trainer", "scale_loss", "unscale",
           "convert_hybrid_block", "convert_model", "list_lp16_ops",
           "list_fp32_ops", "list_widest_type_cast", "LossScaler"]

_amp_state = {"initialized": False, "target_dtype": None, "loss_scaler": None}


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP with ``target_dtype`` "float16" (dynamic loss scaling)
    or "bfloat16".  Existing nets are converted with
    :func:`convert_hybrid_block`."""
    if target_dtype in ("float16", _onp.float16, torch.float16):
        target_dtype = "float16"
    elif target_dtype in ("bfloat16", torch.bfloat16):
        target_dtype = "bfloat16"
    else:
        raise ValueError("AMP target_dtype must be float16 or bfloat16")
    _amp_state["initialized"] = True
    _amp_state["target_dtype"] = target_dtype
    if target_dtype == "float16":
        _amp_state["loss_scaler"] = LossScaler()
    return None


def init_trainer(trainer):
    """Attach dynamic loss scaling to a Trainer (the float16 path).

    Each trainer gets its own scaler, seeded from the global one: the
    scale and the per-step flags are trainer state, so one trainer's
    overflow or manual unscale cannot touch another's updates."""
    proto = _amp_state.get("loss_scaler")
    if proto is not None:
        trainer._amp_loss_scaler = LossScaler(
            init_scale=proto.loss_scale,
            scale_factor=proto._scale_factor,
            scale_window=proto._scale_window)
    return trainer


def scale_loss(loss, trainer):
    """Context manager giving the loss times the trainer's loss scale
    (the loss itself without a scaler)."""
    class _Scope:
        def __enter__(self_inner):
            scaler = getattr(trainer, "_amp_loss_scaler", None)
            if scaler is None:
                return loss
            if isinstance(loss, (list, tuple)):
                return [l * scaler.loss_scale for l in loss]
            return loss * scaler.loss_scale

        def __exit__(self_inner, *exc):
            return False

    return _Scope()


def unscale(trainer):
    """Divide the gradients by the current loss scale, in place (the
    manual flow, for gradient clipping before ``step``); the next step
    sees the flag and does not divide again."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    inv = 1.0 / scaler.loss_scale
    with torch.no_grad():
        for p in trainer._params:
            g = grad_of(p)
            if p.requires_grad and g is not None:
                g.mul_(inv)
    scaler._manual_unscaled = True


def convert_hybrid_block(block, target_dtype="bfloat16",
                         target_dtype_ops=None, fp32_ops=None,
                         conditional_fp32_ops=None, excluded_sym_names=None,
                         device=None, cast_params_offline=False):
    """Cast ``block`` to ``target_dtype``, then its norms back to float32
    (they compute their statistics in float32 either way), and drop its
    cached graphs."""
    from ..gluon.nn import BatchNorm, GroupNorm, InstanceNorm, LayerNorm

    block.cast(target_dtype)

    def _restore_norms(b):
        if isinstance(b, (BatchNorm, LayerNorm, GroupNorm, InstanceNorm)):
            b.cast("float32")

    block.apply(_restore_norms)
    if hasattr(block, "reset_cache"):
        block.reset_cache()
    return block


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  **kwargs):
    raise NotImplementedError(
        "symbol-file AMP conversion: convert the block with "
        "convert_hybrid_block (the port, like the JAX package, has no "
        "standalone symbol graphs to rewrite)")


def list_lp16_ops(target_dtype="float16"):
    return list(FP16_FUNCS)


def list_fp32_ops(target_dtype="float16"):
    return list(FP32_FUNCS)


def list_widest_type_cast(target_dtype="float16"):
    return list(FP16_FP32_FUNCS)
