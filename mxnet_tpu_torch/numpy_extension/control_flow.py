"""Control-flow operators, run as eager Python loops.

Counterpart of ``mxnet_tpu/numpy_extension/control_flow.py``
(``foreach`` :30, ``while_loop`` :91, ``cond`` :140).  The JAX package
traces them into ``lax.scan`` / ``lax.while_loop`` / ``lax.cond``; the
port runs eagerly, so each is a loop or a branch over NDArrays, and
torch autograd records whatever the body does.  As in the JAX package,
``while_loop``'s step outputs are stacked to ``max_iterations`` rows,
the rows after the loop's exit holding zeros.
"""
from __future__ import annotations

import torch

from ..ndarray.ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]


def _aslist(x):
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def _stack(rows):
    return NDArray(torch.stack([r._data for r in rows]))


def foreach(body, data, init_states, name="foreach"):
    """``body(data_slice, states) -> (out, new_states)`` over axis 0 of
    ``data`` (an NDArray or a list of them); returns (the outputs stacked
    over the steps, the final states)."""
    data_list, data_multi = _aslist(data)
    states, states_multi = _aslist(init_states)
    outs, out_multi = [], False
    for i in range(data_list[0].shape[0]):
        xs = [d[i] for d in data_list]
        out, states = body(xs if data_multi else xs[0],
                           states if states_multi else states[0])
        out, out_multi = _aslist(out)
        states, _ = _aslist(states)
        outs.append(out)
    stacked = [_stack([o[k] for o in outs]) for k in range(len(outs[0]))] \
        if outs else []
    return (stacked if out_multi else stacked[0] if stacked else []), \
        (states if states_multi else states[0])


def while_loop(cond, func, loop_vars, max_iterations=None,
               name="while_loop"):
    """``func(*loop_vars) -> (step_output, new_loop_vars)`` while
    ``cond(*loop_vars)`` holds, at most ``max_iterations`` times; returns
    (the step outputs stacked to ``max_iterations`` rows, zeros after the
    exit, and the final loop variables)."""
    if max_iterations is None:
        raise ValueError("max_iterations is required")
    vars_, multi = _aslist(loop_vars)
    outs, out_multi = [], False
    for _ in range(max_iterations):
        if not bool(cond(*vars_)):
            break
        out, new_vars = func(*vars_)
        out, out_multi = _aslist(out)
        vars_, _ = _aslist(new_vars)
        outs.append(out)
    if not outs:                        # shapes from one probe step
        out, _ = func(*vars_)
        out, out_multi = _aslist(out)
        outs_t = [NDArray(torch.zeros((max_iterations,) + o.shape,
                                      dtype=o._data.dtype,
                                      device=o._data.device)) for o in out]
    else:
        outs_t = []
        for k in range(len(outs[0])):
            rows = [o[k]._data for o in outs]
            pad = torch.zeros((max_iterations - len(rows),) + rows[0].shape,
                              dtype=rows[0].dtype, device=rows[0].device)
            outs_t.append(NDArray(torch.cat([torch.stack(rows), pad])))
    return (outs_t if out_multi else outs_t[0]), \
        (vars_ if multi else vars_[0])


def cond(pred, then_func, else_func, inputs=None, name="cond"):
    """``then_func(*inputs)`` if ``pred`` else ``else_func(*inputs)``."""
    args, _ = _aslist(inputs) if inputs is not None else ([], False)
    return then_func(*args) if bool(pred) else else_func(*args)
