"""Multi-tensor optimizer updates: hand-written CUDA on the card, their
plain PyTorch versions on the CPU.

Counterpart of the JAX package's compiled update (``Optimizer._compiled``,
``mxnet_tpu/optimizer/optimizer.py:135-146``, fused into the step's
program by ``parallel/train_step.py:170-206``) and of its multi-tensor
update ops (``ndarray/op_updates.py:342-600``).  Three wrappers, each one
kernel launch (LAMB: two) over a whole list of tensors, from
``csrc/multi_tensor.cu``:

* :func:`multi_sgd` -- SGD, momentum and Nesterov (NAG); launch count
  ``multi_sgd``;
* :func:`multi_adam` -- Adam (coupled weight decay) and AdamW
  (decoupled), with or without bias correction; ``multi_adam``;
* :func:`multi_lamb` -- LAMB's phase 1 (moments, the direction r, partial
  norms) and phase 2 (trust ratio, weight); ``multi_lamb_phase1`` and
  ``multi_lamb_phase2``;
* :func:`multi_all_finite` -- whether every element of a list of tensors
  of mixed float dtypes is finite, into one float32 flag on the device
  (no host sync); ``multi_all_finite``.

Each takes a list of groups -- a weight, its gradient, its float32
states and optionally a float32 master weight (``multi_precision``) --
with per-tensor scalars (lr, wd, the step ``t``), and the scalars the
launch shares (rescale, clip, betas, eps, momentum, bounds).  Gradients
are rescaled, then clipped, then the rule runs; weights, master weights
and states are updated in place (the JAX package swaps each handle for
the rule's new array; here the caller's tensors keep their storage).

Dispatch is by the device of the tensors: CPU tensors run the plain
version (:func:`sgd_step`, :func:`adam_step`, :func:`lamb_direction` and
:func:`lamb_ratio`, per tensor, the arithmetic of the JAX rules and ops,
which the optimizers' ``_rule`` share); CUDA tensors run the kernels,
and the wrapper raises on what they do not take (a weight or gradient
that is not float16, bfloat16 or float32, a state that is not float32,
a non-contiguous tensor, mismatched sizes, mixed dtypes or devices).

:func:`multi_tensor_plan` cuts a list into launches, reading sizes only.
"""
from __future__ import annotations

import ctypes
import math

import numpy as onp
import torch

from . import _build
from .cuda_ops import LAUNCHES

__all__ = ["multi_tensor_plan", "multi_sgd", "multi_adam", "multi_lamb",
           "multi_all_finite", "multi_all_finite_plain",
           "multi_sgd_plain", "multi_adam_plain", "multi_lamb_plain",
           "sgd_step", "adam_step", "lamb_direction", "lamb_ratio",
           "one_minus", "inverse", "CHUNK", "TABLE"]

#: elements per chunk and tensors per launch (``csrc/multi_tensor.cu``)
CHUNK = 16384
TABLE = 256
VEC_BYTES = 16
KERNELS = {"multi_sgd": 0, "multi_adam": 1, "multi_lamb_phase1": 2,
           "multi_lamb_phase2": 3, "multi_all_finite": 4}
DTYPES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}
FINITE_DTYPES = {**DTYPES, torch.float64: 3}
NESTEROV, DECOUPLED, HAS_CLIP, HAS_LOWER, HAS_UPPER, NARROW = \
    1, 2, 4, 8, 16, 32

_PTRS = ("w", "g", "s0", "s1", "w32", "r")
_FLOATS = ("lr", "wd", "eta", "ic1", "ic2")
# the C structs ``mxmt::Table`` and ``mxmt::Scalars``, field for field
_TABLE_DTYPE = onp.dtype(
    [(k, "<u8", TABLE) for k in _PTRS] + [("n", "<i8", TABLE)]
    + [(k, "<f4", TABLE) for k in _FLOATS]
    + [("chunk_begin", "<i4", TABLE + 1), ("index", "<i4", TABLE),
       ("ntensors", "<i4"), ("aligned", "u1", TABLE),
       ("dtype", "u1", TABLE)], align=True)
_SCALARS_DTYPE = onp.dtype(
    [("rescale_dev", "<u8"), ("partials", "<u8"), ("ratios", "<u8"),
     ("finite", "<u8")]
    + [(k, "<f4") for k in ("rescale", "clip", "beta1", "beta2", "omb1",
                            "omb2", "eps", "momentum", "lower", "upper")]
    + [("flags", "<i4"), ("nchunks", "<i4")], align=True)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

class Launch:
    """One launch of a plan: ``tensors`` (indices into the planned list),
    ``chunk_begin`` (each tensor's first chunk, and the launch's chunk
    count last) and ``aligned`` (whether the tensor runs the 16-byte
    vector path)."""

    __slots__ = ("tensors", "chunk_begin", "aligned", "chunk")

    def __init__(self, tensors, chunk_begin, aligned, chunk):
        self.tensors, self.chunk_begin = tensors, chunk_begin
        self.aligned, self.chunk = aligned, chunk

    @property
    def nchunks(self):
        return int(self.chunk_begin[-1])

    def chunks(self):
        """(tensor, start, aligned) of every chunk, as arrays: the planned
        list's index of its tensor, its first element, and whether all
        of its pointers are 16-byte aligned (vector path) or not
        (scalar path)."""
        counts = onp.diff(self.chunk_begin)
        local = onp.arange(self.nchunks) - onp.repeat(self.chunk_begin[:-1],
                                                      counts)
        return (onp.repeat(self.tensors, counts), local * self.chunk,
                onp.repeat(self.aligned, counts))


def multi_tensor_plan(numels, itemsizes, ptr_alignments, max_entries=TABLE,
                      chunk=CHUNK):
    """Cut a list of tensors into launches of at most ``max_entries``
    tensors, each tensor into chunks of ``chunk`` elements; a list of
    :class:`Launch`.  ``itemsizes[i]`` is the smallest element size of
    tensor i's operands and ``ptr_alignments[i]`` the largest power of
    two that divides all of its pointers: its chunks take the vector
    path when that is a multiple of 16 and every element is at least 2
    bytes (so each chunk start and each group of 8 elements stays
    16-byte aligned).  Tensors with no elements are left out.  Reads
    sizes only."""
    numels = onp.asarray(numels, dtype=onp.int64).reshape(-1)
    if chunk % 8 or (chunk * 2) % VEC_BYTES:
        raise ValueError("chunk must be a multiple of 8 elements")
    live = onp.nonzero(numels > 0)[0]
    aligned = ((onp.asarray(ptr_alignments, dtype=onp.int64).reshape(-1)
                % VEC_BYTES == 0)
               & (onp.asarray(itemsizes, dtype=onp.int64).reshape(-1) >= 2))
    counts = (numels + chunk - 1) // chunk
    out = []
    for lo in range(0, len(live), max_entries):
        idx = live[lo:lo + max_entries]
        begin = onp.zeros(len(idx) + 1, dtype=onp.int64)
        onp.cumsum(counts[idx], out=begin[1:])
        if begin[-1] >= 2 ** 31:
            raise ValueError("multi-tensor launch of %d chunks: more than "
                             "an int32 counts" % begin[-1])
        out.append(Launch(idx, begin.astype(onp.int32), aligned[idx], chunk))
    return out


# ---------------------------------------------------------------------------
# the plain per-tensor rules (float32 in, new float32 tensors out)
# ---------------------------------------------------------------------------

def sgd_step(w, g, mom, lr, wd, momentum, nesterov):
    """(new w, new mom) of SGD / NAG (JAX ``SGD._rule``, ``NAG._rule``;
    ``sgd_mom_update``, ``nag_mom_update``): g += wd * w; with a
    momentum state m = momentum * m - lr * g and w += m (Nesterov: w +=
    momentum * m - lr * g), else w -= lr * g."""
    g = g + wd * w
    if mom is None:
        return w - lr * g, None
    mom = momentum * mom - lr * g
    if nesterov:
        return w + momentum * mom - lr * g, mom
    return w + mom, mom


def adam_step(w, g, m, v, lr, wd, eta, ic1, ic2, betas, eps, decoupled):
    """(new w, m, v) of Adam / AdamW (JAX ``Adam._rule``,
    ``AdamW._rule``; ``adam_update``, ``adamw_update``): g += wd * w
    unless ``decoupled``; m = beta1 m + (1 - beta1) g and v = beta2 v +
    (1 - beta2) g^2, ``betas`` = (beta1, beta2, 1 - beta1, 1 - beta2)
    (:func:`one_minus`); then w -= eta * (lr * (m ic1) / (sqrt(v ic2) +
    eps) [+ wd * w when decoupled]).  The optimizers put lr in ``eta``
    for AdamW (lr = 1) and in ``lr`` for Adam (eta = 1); ic1 = 1 / (1 -
    beta1^t), ic2 = 1 / (1 - beta2^t), or 1 (:func:`inverse`).

    Every operation rounds once, in this order: the kernel does the same
    without contracting any into an FMA, so the two agree bit for bit."""
    beta1, beta2, omb1, omb2 = betas
    if not decoupled:
        g = g + wd * w
    m = beta1 * m + omb1 * g
    v = beta2 * v + omb2 * g * g
    upd = lr * (m * ic1) / ((v * ic2).sqrt() + eps)
    if decoupled:
        return w - eta * (upd + wd * w), m, v
    return w - eta * upd, m, v


def lamb_direction(w, g, m, v, wd, ic1, ic2, betas, eps):
    """(r, m, v) of LAMB's phase 1 (JAX ``LAMB._rule``;
    ``lamb_update_phase1``, ``_lamb_one``): the moments as
    :func:`adam_step`'s, and r = (m ic1) / (sqrt(v ic2) + eps) + wd * w."""
    beta1, beta2, omb1, omb2 = betas
    m = beta1 * m + omb1 * g
    v = beta2 * v + omb2 * g * g
    return (m * ic1) / ((v * ic2).sqrt() + eps) + wd * w, m, v


def lamb_ratio(w, r, lower_bound=None, upper_bound=None):
    """LAMB's trust ratio (phase 2): ||w||, bounded, over ||r|| where
    both are positive, else 1 (a 0-dim float32 tensor)."""
    w_norm = torch.linalg.vector_norm(w)
    if lower_bound is not None:
        w_norm = torch.clamp(w_norm, min=lower_bound)
    if upper_bound is not None:
        w_norm = torch.clamp(w_norm, max=upper_bound)
    r_norm = torch.linalg.vector_norm(r)
    one = torch.ones((), dtype=w_norm.dtype, device=w_norm.device)
    return torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, one)


def one_minus(beta, t=1, f32=False):
    """1 - beta^t as a Python float: in float32 arithmetic with ``f32``,
    as the JAX optimizers compute it (their scalars are float32, so 1 -
    0.999 is 0.00099998713), else in float64, as the JAX ops compute it
    (Python scalars)."""
    if f32:
        b = onp.float32(beta)
        return float(onp.float32(1) - (
            b if t == 1 else onp.power(b, onp.float32(t))))
    return 1 - math.pow(beta, t)


def inverse(c):
    """1 / c in float32 arithmetic, as a Python float: the bias
    corrections are applied as products (the JAX rules divide; the two
    differ by at most an ulp)."""
    return float(onp.float32(1) / onp.float32(c))


def _betas(beta1, beta2, f32):
    return beta1, beta2, one_minus(beta1, 1, f32), one_minus(beta2, 1, f32)


def _prep(g, rescale, clip):
    """The gradient as every rule reads it: float32, rescaled, clipped."""
    g = g.float() * (rescale.float() if torch.is_tensor(rescale)
                     else rescale)
    if clip is not None:
        g = g.clamp(-clip, clip)
    return g


def _master(group):
    """(the float32 weight the rule reads, the tensors it is written to)."""
    w, w32 = group[0], group[-1]
    if w32 is not None:
        return w32, (w32, w)
    return w.float(), (w,)


def _write(targets, new):
    for t in targets:
        t.copy_(new)


# ---------------------------------------------------------------------------
# checks and the launch
# ---------------------------------------------------------------------------

def _on_cuda(groups):
    devs = {t.device.type for grp in groups for t in grp if t is not None}
    if not devs or devs == {"cpu"}:
        return False
    if devs == {"cuda"}:
        return True
    raise ValueError("multi-tensor update: tensors must all be on the CPU "
                     "or all on CUDA, got %s" % sorted(devs))


def _check(name, groups):
    """Raise on what the kernels do not take; the dtype codes of the
    weights and the gradients.  A group is (weight, grad, float32
    states and master weight, or None for one that is absent)."""
    w0, g0 = groups[0][0], groups[0][1]
    if w0.dtype not in DTYPES or g0.dtype not in DTYPES:
        raise TypeError("%s kernel takes float16, bfloat16 or float32 "
                        "weights and gradients, got %s / %s"
                        % (name, w0.dtype, g0.dtype))
    dev, wdt, gdt = w0.device, w0.dtype, g0.dtype
    has_master = groups[0][-1] is not None
    for grp in groups:
        w, g, shape = grp[0], grp[1], grp[0].shape
        if w.dtype != wdt or g.dtype != gdt:
            raise TypeError("%s kernel: one weight dtype and one gradient "
                            "dtype per call, got %s / %s and %s / %s"
                            % (name, wdt, gdt, w.dtype, g.dtype))
        if (grp[-1] is not None) != has_master:
            raise ValueError("%s kernel: master weights for all tensors of "
                             "a call or for none" % name)
        for k, t in enumerate(grp):
            if t is None:
                continue
            if t.device != dev:
                raise ValueError("%s kernel: tensors on %s and %s"
                                 % (name, dev, t.device))
            if not t.is_contiguous():
                raise ValueError("%s kernel: tensors must be contiguous"
                                 % name)
            if t.shape != shape:
                raise ValueError("%s kernel: a tensor of shape %s beside "
                                 "a weight of shape %s"
                                 % (name, tuple(t.shape), tuple(shape)))
            if k >= 2 and t.dtype != torch.float32:
                raise TypeError("%s kernel: states and master weights are "
                                "float32, got %s" % (name, t.dtype))
    return DTYPES[wdt], DTYPES[gdt]


def _tables(groups, floats):
    """Yield (launch, table) for each launch of the plan of ``groups``
    (checked by :func:`_check`): pointers, element counts, chunk prefix
    and the per-tensor ``floats`` (name -> one value per group)."""
    ptrs = onp.array([[0 if t is None else t.data_ptr() for t in grp]
                      for grp in groups], dtype=onp.uint64)
    if ptrs.shape[1] == 4:          # (w, g, mom, w32): no second state
        ptrs = onp.insert(ptrs, 3, 0, axis=1)
    numels = onp.array([grp[0].numel() for grp in groups], dtype=onp.int64)
    ored = onp.bitwise_or.reduce(ptrs, axis=1).astype(onp.int64)
    align = ored & -ored
    align[ored == 0] = VEC_BYTES
    size = min(groups[0][0].element_size(), groups[0][1].element_size())
    vals = {k: onp.asarray(v, dtype=onp.float32) for k, v in floats.items()}
    for launch in multi_tensor_plan(numels, onp.full(len(groups), size),
                                    align):
        tab = onp.zeros((), dtype=_TABLE_DTYPE)
        idx, k = launch.tensors, len(launch.tensors)
        for col, key in enumerate(_PTRS[:5]):
            tab[key][:k] = ptrs[idx, col]
        tab["n"][:k] = numels[idx]
        for key in _FLOATS:
            tab[key][:k] = vals[key][idx] if key in vals else 1.0
        tab["chunk_begin"][:k + 1] = launch.chunk_begin
        tab["index"][:k] = idx
        tab["ntensors"] = k
        tab["aligned"][:k] = launch.aligned
        yield launch, tab


_SIZES = []


def _library():
    lib = _build.library("multi_tensor")
    if not _SIZES:
        tb, sb = ctypes.c_int(), ctypes.c_int()
        lib.mx_multi_tensor_sizes(ctypes.byref(tb), ctypes.byref(sb))
        _SIZES.append((tb.value, sb.value))
    if _SIZES[0] != (_TABLE_DTYPE.itemsize, _SCALARS_DTYPE.itemsize):
        raise RuntimeError("multi_tensor.cu's table layout (%d, %d bytes) "
                           "differs from the host's (%d, %d)"
                           % (*_SIZES[0], _TABLE_DTYPE.itemsize,
                              _SCALARS_DTYPE.itemsize))
    return lib


def _scalars(rescale, clip, **kw):
    s = onp.zeros((), dtype=_SCALARS_DTYPE)
    if torch.is_tensor(rescale):
        s["rescale_dev"] = rescale.data_ptr()
    else:
        s["rescale"] = rescale
    flags = kw.pop("flags", 0)
    if clip is not None:
        s["clip"] = clip
        flags |= HAS_CLIP
    for k, v in kw.items():
        s[k] = v
    s["flags"] = flags
    return s


def _launch(kernel, tab, s, codes, device):
    s["nchunks"] = tab["chunk_begin"][tab["ntensors"]]
    err = _library().mx_multi_tensor(
        KERNELS[kernel], tab.ctypes.data, tab.nbytes, s.ctypes.data,
        s.nbytes, codes[0], codes[1],
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (kernel, err))
    LAUNCHES[kernel] += 1


def _device_rescale(rescale, device):
    """A tensor rescale as one float32 element on ``device``."""
    if not torch.is_tensor(rescale):
        return rescale
    return rescale.to(device=device, dtype=torch.float32).reshape(1)


def _per_tensor(vals, n, what):
    vals = [float(x) for x in vals]
    if len(vals) != n:
        raise ValueError("%d %s for %d tensors" % (len(vals), what, n))
    return vals


def _corrections(steps, beta1, beta2, bias_correction, n, f32):
    """ic1 = 1 / (1 - beta1^t) and ic2 = 1 / (1 - beta2^t) per tensor (1
    without bias correction)."""
    if not bias_correction:
        return [1.0] * n, [1.0] * n
    steps = _per_tensor(steps, n, "steps")
    per_t = {t: (inverse(one_minus(beta1, t, f32)),
                 inverse(one_minus(beta2, t, f32))) for t in set(steps)}
    return [per_t[t][0] for t in steps], [per_t[t][1] for t in steps]


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _args(groups, lrs, wds, etas=None, steps=None, beta1=0.9, beta2=0.999,
          bias_correction=True, f32_scalars=False):
    """The wrappers' arguments, normalised: (groups as tuples, lrs, wds,
    etas, ic1s, ic2s, betas = (beta1, beta2, 1 - beta1, 1 - beta2))."""
    groups = [tuple(grp) for grp in groups]
    n = len(groups)
    lrs, wds = _per_tensor(lrs, n, "lrs"), _per_tensor(wds, n, "wds")
    etas = [1.0] * n if etas is None else _per_tensor(etas, n, "etas")
    ic1s, ic2s = _corrections(steps, beta1, beta2, bias_correction, n,
                              f32_scalars)
    return (groups, lrs, wds, etas, ic1s, ic2s,
            _betas(beta1, beta2, f32_scalars))


@torch.no_grad()
def multi_sgd_plain(groups, lrs, wds, momentum=0.0, nesterov=False,
                    rescale=1.0, clip=None):
    """The plain version of :func:`multi_sgd`, on any device: per tensor,
    :func:`sgd_step` on the prepared gradient, written back in place."""
    groups, lrs, wds = _args(groups, lrs, wds, bias_correction=False)[:3]
    for (w, g, mom, w32), lr, wd in zip(groups, lrs, wds):
        wf, targets = _master((w, w32))
        new_w, new_m = sgd_step(wf, _prep(g, rescale, clip), mom, lr, wd,
                                momentum, nesterov)
        if mom is not None:
            mom.copy_(new_m)
        _write(targets, new_w)


@torch.no_grad()
def multi_sgd(groups, lrs, wds, momentum=0.0, nesterov=False, rescale=1.0,
              clip=None):
    """SGD over ``groups`` of (weight, grad, mom or None, weight32 or
    None), in place: g = clip(g * rescale) + wd * w, then the rule of
    :func:`sgd_step` with ``momentum`` (Nesterov with ``nesterov``) where
    a group has a momentum state."""
    groups, lrs, wds = _args(groups, lrs, wds, bias_correction=False)[:3]
    if not groups or not _on_cuda(groups):
        return multi_sgd_plain(groups, lrs, wds, momentum, nesterov, rescale,
                               clip)
    if len({grp[2] is None for grp in groups}) > 1:
        raise ValueError("multi_sgd kernel: a momentum state for all "
                         "tensors of a call or for none")
    codes = _check("multi_sgd", groups)
    dev = groups[0][0].device
    rescale = _device_rescale(rescale, dev)    # alive until the launch
    s = _scalars(rescale, clip, momentum=momentum,
                 flags=NESTEROV if nesterov else 0)
    for launch, tab in _tables(groups, {"lr": lrs, "wd": wds}):
        _launch("multi_sgd", tab, s, codes, dev)


@torch.no_grad()
def multi_adam_plain(groups, lrs, wds, etas=None, steps=None, beta1=0.9,
                     beta2=0.999, epsilon=1e-8, decoupled=False,
                     bias_correction=True, rescale=1.0, clip=None,
                     f32_scalars=False):
    """The plain version of :func:`multi_adam`, on any device."""
    groups, lrs, wds, etas, ic1s, ic2s, betas = _args(
        groups, lrs, wds, etas, steps, beta1, beta2, bias_correction,
        f32_scalars)
    for (w, g, m, v, w32), lr, wd, eta, ic1, ic2 in zip(
            groups, lrs, wds, etas, ic1s, ic2s):
        wf, targets = _master((w, w32))
        new_w, new_m, new_v = adam_step(
            wf, _prep(g, rescale, clip), m, v, lr, wd, eta, ic1, ic2, betas,
            epsilon, decoupled)
        m.copy_(new_m)
        v.copy_(new_v)
        _write(targets, new_w)


@torch.no_grad()
def multi_adam(groups, lrs, wds, etas=None, steps=None, beta1=0.9,
               beta2=0.999, epsilon=1e-8, decoupled=False,
               bias_correction=True, rescale=1.0, clip=None,
               f32_scalars=False):
    """Adam / AdamW over ``groups`` of (weight, grad, mean, var, weight32
    or None), in place, by :func:`adam_step`: ``etas`` default to 1,
    ``steps`` give each tensor's bias corrections.  ``rescale`` is a
    float or a one-element tensor (read on the device).  ``f32_scalars``:
    1 - beta and 1 - beta^t in float32 arithmetic (:func:`one_minus`)."""
    groups, lrs, wds, etas, ic1s, ic2s, betas = _args(
        groups, lrs, wds, etas, steps, beta1, beta2, bias_correction,
        f32_scalars)
    if not groups or not _on_cuda(groups):
        return multi_adam_plain(groups, lrs, wds, etas, steps, beta1, beta2,
                                epsilon, decoupled, bias_correction, rescale,
                                clip, f32_scalars)
    codes = _check("multi_adam", groups)
    dev = groups[0][0].device
    rescale = _device_rescale(rescale, dev)    # alive until the launch
    s = _scalars(rescale, clip, beta1=beta1,
                 beta2=beta2, omb1=betas[2], omb2=betas[3], eps=epsilon,
                 flags=DECOUPLED if decoupled else 0)
    for launch, tab in _tables(groups, {"lr": lrs, "wd": wds, "eta": etas,
                                        "ic1": ic1s, "ic2": ic2s}):
        _launch("multi_adam", tab, s, codes, dev)


@torch.no_grad()
def multi_lamb_plain(groups, lrs, wds, steps=None, beta1=0.9, beta2=0.999,
                     epsilon=1e-6, bias_correction=True, lower_bound=None,
                     upper_bound=None, rescale=1.0, clip=None,
                     f32_scalars=False, ratios=None):
    """The plain version of :func:`multi_lamb`, on any device."""
    groups, lrs, wds, _, ic1s, ic2s, betas = _args(
        groups, lrs, wds, None, steps, beta1, beta2, bias_correction,
        f32_scalars)
    for k, ((w, g, m, v, w32), lr, wd, ic1, ic2) in enumerate(
            zip(groups, lrs, wds, ic1s, ic2s)):
        wf, targets = _master((w, w32))
        r, new_m, new_v = lamb_direction(wf, _prep(g, rescale, clip), m, v,
                                         wd, ic1, ic2, betas, epsilon)
        m.copy_(new_m)
        v.copy_(new_v)
        ratio = lamb_ratio(wf, r, lower_bound, upper_bound)
        if ratios is not None and w.numel():
            ratios[k] = ratio
        _write(targets, wf - lr * ratio * r)


@torch.no_grad()
def multi_lamb(groups, lrs, wds, steps=None, beta1=0.9, beta2=0.999,
               epsilon=1e-6, bias_correction=True, lower_bound=None,
               upper_bound=None, rescale=1.0, clip=None, f32_scalars=False,
               ratios=None):
    """LAMB over ``groups`` of (weight, grad, mean, var, weight32 or
    None), in place: phase 1 (:func:`lamb_direction`) then phase 2, w -=
    lr * :func:`lamb_ratio` * r.  A bound of None is no bound;
    ``f32_scalars`` as :func:`multi_adam`'s.  ``ratios``, a float32
    tensor of one element per group on the groups' device, receives each
    tensor's trust ratio (that of a tensor with no elements stays as it
    was)."""
    args = (groups, lrs, wds, steps, beta1, beta2, epsilon,
            bias_correction, lower_bound, upper_bound, rescale, clip,
            f32_scalars, ratios)
    if not groups or not _on_cuda(groups):
        return multi_lamb_plain(*args)
    codes, dev, launches = lamb_launches(*args)
    for tab, s, _ in launches:
        _launch("multi_lamb_phase1", tab, s, codes, dev)
        _launch("multi_lamb_phase2", tab, s, codes, dev)


def multi_all_finite_plain(tensors, flag=None, narrow=True):
    """The plain version of :func:`multi_all_finite`, on any device."""
    dev = flag.device if flag is not None else (
        tensors[0].device if tensors else torch.device("cpu"))
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for t in tensors:
        ok = ok & torch.isfinite(t.float() if narrow else t).all().to(dev)
    if flag is None:
        return ok.to(torch.float32).reshape(1)
    flag.copy_(torch.where(ok, flag, torch.zeros_like(flag)))
    return flag


@torch.no_grad()
def multi_all_finite(tensors, flag=None, narrow=True):
    """Whether every element of ``tensors`` (float16, bfloat16, float32
    or float64, mixed) is finite: ``flag``, a float32 tensor of one
    element, is set to 0 if one is not and left as it was otherwise; a
    new flag of 1 when None.  Returns the flag, on the tensors' device,
    with no host sync.  ``narrow``: a float64 element is checked after
    its rounding to float32 (the reference's ops cast first).  On CUDA
    one ``finite_kernel`` launch per 256 tensors."""
    tensors = [t for t in tensors if t.numel()]
    if not tensors or not _on_cuda([(t,) for t in tensors]):
        return multi_all_finite_plain(tensors, flag, narrow)
    dev = tensors[0].device
    for t in tensors:
        if t.dtype not in FINITE_DTYPES:
            raise TypeError("multi_all_finite kernel takes float16, "
                            "bfloat16, float32 or float64 tensors, got %s"
                            % t.dtype)
        if t.device != dev:
            raise ValueError("multi_all_finite kernel: tensors on %s and %s"
                             % (dev, t.device))
        if not t.is_contiguous():
            raise ValueError("multi_all_finite kernel: tensors must be "
                             "contiguous")
    if flag is None:
        flag = torch.ones(1, dtype=torch.float32, device=dev)
    elif (flag.dtype != torch.float32 or flag.numel() != 1
          or flag.device != dev):
        raise ValueError("multi_all_finite: the flag must be one float32 "
                         "element on %s" % dev)
    ptrs = onp.array([t.data_ptr() for t in tensors], dtype=onp.int64)
    codes = onp.array([FINITE_DTYPES[t.dtype] for t in tensors],
                      dtype=onp.uint8)
    s = _scalars(1.0, None, finite=flag.data_ptr(),
                 flags=NARROW if narrow else 0)
    for launch in multi_tensor_plan(
            [t.numel() for t in tensors],
            [t.element_size() for t in tensors], ptrs & -ptrs):
        tab = onp.zeros((), dtype=_TABLE_DTYPE)
        idx, k = launch.tensors, len(launch.tensors)
        tab["g"][:k] = ptrs[idx].astype(onp.uint64)
        tab["n"][:k] = [tensors[i].numel() for i in idx]
        tab["chunk_begin"][:k + 1] = launch.chunk_begin
        tab["index"][:k] = idx
        tab["ntensors"] = k
        tab["aligned"][:k] = launch.aligned
        tab["dtype"][:k] = codes[idx]
        _launch("multi_all_finite", tab, s, (0, 0), dev)
    return flag


def lamb_launches(groups, lrs, wds, steps=None, beta1=0.9, beta2=0.999,
                  epsilon=1e-6, bias_correction=True, lower_bound=None,
                  upper_bound=None, rescale=1.0, clip=None, f32_scalars=False,
                  ratios=None):
    """(dtype codes, device, [(table, scalars, scratch)]) of
    :func:`multi_lamb`'s launches on CUDA groups, checked and ready for
    its two kernels: each launch's direction r and per-chunk partial
    sums live in the scratch tensors kept beside it."""
    groups, lrs, wds, _, ic1s, ic2s, betas = _args(
        groups, lrs, wds, None, steps, beta1, beta2, bias_correction,
        f32_scalars)
    codes = _check("multi_lamb", groups)
    dev = groups[0][0].device
    n = len(groups)
    if ratios is not None and (ratios.dtype != torch.float32 or
                               ratios.numel() != n or ratios.device != dev
                               or not ratios.is_contiguous()):
        raise ValueError("multi_lamb: ratios must be %d contiguous float32 "
                         "elements on %s" % (n, dev))
    flags = (HAS_LOWER if lower_bound is not None else 0) | (
        HAS_UPPER if upper_bound is not None else 0)
    rescale = _device_rescale(rescale, dev)
    s = _scalars(rescale, clip, beta1=beta1,
                 beta2=beta2, omb1=betas[2], omb2=betas[3], eps=epsilon,
                 lower=lower_bound or 0.0, upper=upper_bound or 0.0,
                 flags=flags, ratios=0 if ratios is None
                 else ratios.data_ptr())
    out = []
    for launch, tab in _tables(groups, {"lr": lrs, "wd": wds,
                                        "ic1": ic1s, "ic2": ic2s}):
        k = len(launch.tensors)
        # r in one float32 scratch, each tensor's rows 16-byte aligned
        sizes = onp.array([groups[i][0].numel() for i in launch.tensors])
        offs = onp.zeros(k + 1, dtype=onp.int64)
        onp.cumsum((sizes + 3) // 4 * 4, out=offs[1:])
        r = torch.empty(int(offs[-1]), dtype=torch.float32, device=dev)
        tab["r"][:k] = r.data_ptr() + 4 * offs[:-1].astype(onp.uint64)
        partials = torch.empty(2 * launch.nchunks, dtype=torch.float64,
                               device=dev)
        ls = s.copy()
        ls["partials"] = partials.data_ptr()
        out.append((tab, ls, (r, partials, rescale)))
    return codes, dev, out
