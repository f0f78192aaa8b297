"""Switch-routing Mixture-of-Experts, with experts split over an ``ep``
mesh axis.

Counterpart of ``mxnet_tpu/parallel/moe.py`` (``switch_moe`` :35,
``moe_param_specs`` :27): top-1 routing with the static capacity
``C = ceil(T/E * capacity_factor)``, dispatch and combine as dense
einsums over one-hot masks.  The routing bookkeeping (probabilities,
queue positions, ``keep``, the gate and the aux loss) is float32
whatever the activation dtype, so queue positions stay exact past 256
tokens an expert; the einsums run in the activation dtype.  Tokens are
queued in token order, so the same tokens are dropped over capacity.

With ``mesh`` holding an ``ep`` axis of ``n`` ranks, rank ``r`` owns
experts ``[r*E/n, (r+1)*E/n)``: it runs only those experts' slice of
the dispatch, and one ``all_reduce`` (sum) over ``ep`` combines the
partial outputs.  The tokens and the gate are replicated, as in the
reference's use; ``w1`` / ``w2`` are the rank's own ``E/n`` experts (the
experts' dimension split over ``ep``, :func:`moe_param_specs`).  The
result equals the unsharded call up to the order of the sum over
experts; gradients reach every input (the dispatched tokens' and the
gate's gradients are summed over ``ep``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ._compat import psum, psum_grad

__all__ = ["switch_moe", "moe_param_specs"]


def moe_param_specs():
    """Specs of the MoE parameters: experts split over ``ep``."""
    return {"gate": (None, None), "w1": ("ep", None, None),
            "w2": ("ep", None, None)}


def _local_experts(w1, E, mesh):
    """(first expert, count) of this rank's experts, checking that
    ``w1`` holds exactly them."""
    n = mesh.shape["ep"]
    if E % n or w1.shape[0] != E // n:
        raise ValueError("ep=%d: each rank holds %s of the %d experts, got "
                         "weights of %d" % (n, E / n, E, w1.shape[0]))
    return mesh.coords["ep"] * (E // n), E // n


def switch_moe(x, gate_w, w1, w2, capacity_factor=1.25, mesh=None):
    """Top-1 switch MoE FFN.

    x: (T, D) tokens; gate_w: (D, E); w1: (E, D, H); w2: (E, H, D)
    (with an ``ep`` axis in ``mesh``: this rank's E/n experts of each).
    Returns (out (T, D), aux_loss): the load-balancing loss ``E * sum_e
    f_e * p_e`` (Switch Transformer eq. 4), float32.  Tokens over an
    expert's capacity are dropped: their output is 0."""
    T, D = x.shape
    E = gate_w.shape[1]
    C = max(1, int(math.ceil(T / E * capacity_factor)))
    dt = torch.promote_types(torch.promote_types(x.dtype, gate_w.dtype),
                             torch.promote_types(w1.dtype, w2.dtype))
    x = x.to(dt)

    logits = x @ gate_w.to(dt)                         # (T, E)
    probs = torch.softmax(logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)              # first of ties
    onehot = F.one_hot(expert, E).float()             # (T, E)
    gate = (probs * onehot).sum(-1)                   # top-1 prob

    # position of each token in its expert's queue, -1 where not routed
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
    keep = (pos < C) & (onehot > 0)
    pos_cap = pos.clamp(0, C - 1).long()
    pos_onehot = F.one_hot(pos_cap, C).float() * keep[..., None].float()
    dispatch = pos_onehot.to(dt)                      # (T, E, C)
    combine = (pos_onehot * gate[:, None, None]).to(dt)

    ep = mesh is not None and "ep" in mesh.shape
    if ep:
        lo, n_local = _local_experts(w1, E, mesh)
        # each rank's partial output is complete for its experts: the
        # gradients of the shared inputs are summed over ep
        dispatch = dispatch[:, lo:lo + n_local]
        combine = psum_grad(combine, "ep", mesh)[:, lo:lo + n_local]
        x_e = psum_grad(x, "ep", mesh)
    else:
        x_e = x
    xe = torch.einsum("td,tec->ecd", x_e, dispatch)    # (E, C, D)
    h = torch.relu(torch.einsum("ecd,edh->ech", xe, w1.to(dt)))
    ye = torch.einsum("ech,ehd->ecd", h, w2.to(dt))
    out = torch.einsum("ecd,tec->td", ye, combine)    # (T, D)
    if ep:
        out = psum(out, "ep", mesh)

    frac = onehot.mean(0)
    mean_p = probs.mean(0)
    aux = E * (frac * mean_p).sum()
    return out, aux
