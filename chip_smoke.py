"""Chip smoke test of mxnet_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``mxnet_tpu_torch/csrc``
(printing each kernel's registers and spills, and failing where ptxas
serialised its wgmma pipeline), holds each against its plain PyTorch
version on the card, checks one training step of a small bf16 model
on the card against the CPU, serves a Llama-3-8B-width
``TransformerLM`` (random weights from a seed)
through the port's ``Server`` -- its decode, prefill and chunk programs
CUDA graphs captured at start-up, each replay held bit for bit against
an eager call of the captured function -- in bf16 and through the int8
weight path (the W8A16 ``int8_linear`` kernel, held against its plain
version at the decode's shapes), checks the served tokens against a
full-sequence forward (of the dequantized model for int8), trains an 8-layer Llama-3-8B-width model
through ``TrainStep`` and the Gluon ``Trainer``, runs ResNet-50 from
the Gluon zoo (inference at ``__graft_entry__.entry()``'s shape, eager and
hybridized, NCHW and NHWC, then training) and trains BERT-base through
the flash kernels at head_dim 64.  The general kernels (every dtype,
head_dim and GQA ratio the Hopper ones do not take) and the
tensor-core forward and backward (float16 / bfloat16 / float32 up to
head_dim 128) are held against their plain versions and timed at
BERT's float32 shape; the float32 ``tiny_config`` and ``bert_tiny_config`` run on the
card against the CPU; BERT-base trains at its default float32; and
``entry()`` runs in its MXNet spelling (``import mxnet_tpu_torch as
mx``).  The optimizer's multi-tensor kernels (SGD / NAG, Adam / AdamW,
LAMB's two phases) are held against their plain versions at the edges
of their design and at the BERT-base, ResNet-50 and LM parameter lists,
and timed there; every training path updates through them.  Each path that
runs kernels does so with the launch counts reset before it and read
after it, and fails unless every kernel it goes through was launched.
The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.  Without a CUDA device it exits non-zero at once.

A kernel's time is its own device time, summed from a torch.profiler
trace of its calls with the L2 cache flushed before each
(:func:`device_ms`), or for the optimizer's kernels the replay of a
CUDA graph of the call (:func:`graph_ms`: torch.profiler was seen to
drop a device record from their traces); the event time of the whole
wrapper call is kept beside it as ``call_ms``.  ``python3 chip_smoke.py
--kernel-timing``
runs only the forward, backward and paged kernels' timing; copied into
another checkout's root, it times that tree's kernels the same way, so
two trees compare in one call.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
# Tolerances against the plain version on the same card inputs.  Flash O
# is bf16 with P rounded to bf16 before P.V: one bf16 step of an |O| near
# 2-4 is 1.6e-2.  lse is fp32 throughout.  Paged keeps P in fp32, so O
# differs from plain only by the bf16 rounding of the output: one step,
# at most 2^-7 of |O|, plus a small floor for fp32 summation order.
FLASH_O_ATOL = 2e-2
FLASH_LSE_ATOL = 1e-5
PAGED_ATOL, PAGED_RTOL = 1e-3, 1e-2
# Flash backward: P and dS are rounded to bf16 (8 bits of mantissa, a
# relative step of 2^-8 = 3.9e-3) before their tile products, and the
# outputs are bf16, against a plain version in fp32; the limit is on
# max|kernel - plain| / max|plain| per tensor.
# Measured on an H100: at most 4.7e-3 over the cases below.
FLASH_BWD_TOL = 1e-2
# Training parity on the card (bf16 model on CUDA vs the same weights on
# the CPU's plain path): the loss to 1e-2 relative, each parameter's grad
# to GRAD_REL_TOL in ||g_cuda - g_cpu|| / ||g_cpu||.
# Measured on an H100: loss 5.5e-5 relative, grads at most 1.35e-2
# (median 8.6e-3): the kernels round P and dS to bf16, the plain path
# does not.
PARITY_LOSS_RTOL = 1e-2
GRAD_REL_TOL = 3e-2
# Served tokens against a teacher-forced full forward.  The two paths
# round differently in bf16 (decode GEMMs at M = 8 against M = T; the
# paged kernel keeps P in fp32 where the flash kernel rounds it to bf16),
# so near-ties flip.  Measured on an H100 over all 448 greedy positions
# of the serving run: the served token's logit was at most 0.1875 below
# the full forward's top with the mma.sync forward and unsplit paged
# decode, 0.1562 with the TMA/wgmma forward and split paged decode (6
# and 5 bf16 steps of a logit in [4, 8)), and 93.5% / 95.1% of the
# served tokens were the argmax.
SERVED_LOGIT_TOL = 0.25         # 8 bf16 steps of a logit in [4, 8)
SERVED_EXACT_MIN = 0.85
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
FLUSH_BYTES = 256 << 20         # > the 50 MB L2: every timed call is cold
# the flush's zero_(): a float64 fill, which no timed call launches (the
# float32 memory-efficient SDPA backward fills a uint8 buffer of its own)
FLUSH_KERNEL = "FillFunctor<double>"


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn()`` in ms, CUDA events around each call,
    with the L2 cache flushed before every call."""
    flush = torch.empty(FLUSH_BYTES // 8, dtype=torch.float64, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def device_ms(fn, match=None, iters=20, warmup=3, attempts=5):
    """(ms, per_kernel) of ``fn()``: the device time per call of its
    kernels whose name contains ``match`` (all of them when None), from
    a torch.profiler trace of ``iters`` calls with the L2 cache flushed
    before each; ``per_kernel`` maps every kernel of the call to its ms
    per call.  The flush is a float64 fill, left out by its kernel's
    name.
    The trace now and then comes back missing some or all device events
    (seen on the H100 machine); it counts only when the flush kernel
    appears once per call, and is taken again otherwise."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(FLUSH_BYTES // 8, dtype=torch.float64, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        if sum(e.count for e in events if FLUSH_KERNEL in e.key) == iters:
            break
    else:
        raise SmokeFailure("%d profiler traces in a row lacked device "
                           "events (%d calls; launches per kernel: %s)"
                           % (attempts, iters, {e.key[:80]: e.count
                                                for e in events}))
    per = {e.key: e.self_device_time_total / iters / 1e3
           for e in events if FLUSH_KERNEL not in e.key}
    ms = sum(v for k, v in per.items() if match is None or match in k)
    check(ms > 0, "no device time for %r in %s" % (match, sorted(per)))
    return ms, per


def _demangle(names):
    """``name<args>`` of each mangled kernel name, through ``c++filt``
    (binutils, beside the host compiler nvcc drives), with the return
    type, the anonymous namespace and the parameters dropped; the names
    as given where c++filt is missing."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return list(names)
    return [d.replace("(anonymous namespace)::", "").removeprefix("void ")
            .split("(", 1)[0].replace(", ", ",") for d in out]


def ptxas_report(build):
    """Registers and spill bytes of every kernel, from the ``-Xptxas
    -v`` output kept beside each library; fails where ptxas serialised
    the wgmma pipeline (warnings C7514 / C7515)."""
    rows = []
    for name in build.SOURCES:
        log = build.build_log(name)
        check("C7514" not in log and "C7515" not in log,
              "ptxas serialised wgmma in %s:\n%s" % (name, log))
        for fn, body in re.findall(
                r"Compiling entry function '([^']+)'(.*?)(?=Compiling entry"
                r" function|\Z)", log, re.S):
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            rows.append((fn, regs and regs.group(1), spill and spill.group(1)))
    out = ["%s %s regs %s B spill" % (n, r, sp) for n, (_, r, sp) in
           zip(_demangle([fn for fn, _, _ in rows]), rows)]
    print("ptxas: " + "; ".join(sorted(out)))


def bound_ms(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 2: flash forward kernel vs plain _dense_with_lse
# ----------------------------------------------------------------------
def flash_phase(co, dev):
    gen = torch.Generator(device="cpu").manual_seed(1)
    H, Hkv, D = 32, 8, 128
    # (B, T, Tk, causal, q_off, k_off); the main path's two shapes are
    # checked where they are timed (flash_timing)
    cases = [(1, 128, 128, True, 0, 0), (1, 128, 128, False, 0, 0),
             (1, 512, 512, False, 0, 0),
             (1, 300, 300, True, 0, 0), (1, 300, 300, False, 0, 0),
             # a later ring step: rows 0..99 of q see no key at all
             (1, 300, 428, True, 28, 128)]
    err_o = err_l = 0.0
    for B, T, Tk, causal, qo, ko in cases:
        q = torch.randn(B, H, T, D, generator=gen).to(dev, torch.bfloat16)
        k = torch.randn(B, Hkv, Tk, D, generator=gen).to(dev, torch.bfloat16)
        v = torch.randn(B, Hkv, Tk, D, generator=gen).to(dev, torch.bfloat16)
        o, lse = co.flash_attention_with_lse(q, k, v, causal=causal,
                                             q_offset=qo, k_offset=ko)
        offs = [torch.tensor([x], dtype=torch.int32, device=dev)
                for x in (qo, ko)]
        o_p, lse_p = co._dense_with_lse(q, k, v, *offs, causal, D ** -0.5)
        torch.cuda.synchronize()
        masked = torch.isneginf(lse_p)
        check(torch.equal(torch.isneginf(lse), masked),
              "flash: -inf lse rows differ (T=%d causal=%s)" % (T, causal))
        check(bool((o[masked[..., None].expand_as(o)] == 0).all()),
              "flash: a fully masked row is not zero")
        eo = (o.float() - o_p.float()).abs().max().item()
        el = (lse[~masked] - lse_p[~masked]).abs().max().item()
        print("flash B=%d T=%d Tk=%d causal=%s q_off=%d k_off=%d: O err "
              "%.3e, lse err %.3e (max |kernel - plain|); masked rows %d"
              % (B, T, Tk, causal, qo, ko, eo, el, int(masked.sum())))
        check(eo <= FLASH_O_ATOL and el <= FLASH_LSE_ATOL,
              "flash kernel disagrees with plain: %.3e / %.3e (limits "
              "%.0e / %.0e)" % (eo, el, FLASH_O_ATOL, FLASH_LSE_ATOL))
        err_o, err_l = max(err_o, eo), max(err_l, el)

    shapes = flash_timing(co, dev)
    head = shapes[0]
    return {"name": "flash_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_ops.py:62",
            "max_abs_err": max([err_o] + [s["max_abs_err"] for s in shapes]),
            "max_abs_err_lse": max([err_l] + [s["max_abs_err_lse"]
                                              for s in shapes]),
            **{k: head[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms",
                                    "library_kernels")},
            "shapes": shapes}


# (B, H, Hkv, T, D, causal): the serving ladder's top rung, the training
# shape, and BERT-base's attention (12 heads of 64, non-causal)
FWD_SHAPES = [(1, 32, 8, 512, 128, True), (2, 32, 8, 1024, 128, True),
              (16, 12, 12, 512, 64, False)]


def _pairs(B, H, T, causal):
    """Score pairs the work needs: the visible ones when causal."""
    return B * H * (T * (T + 1) // 2 if causal else T * T)


def flash_timing(co, dev, shapes=FWD_SHAPES):
    """The flash forward at the main paths' shapes: held against plain,
    then timed -- the kernel's own device time, the event time of the
    whole wrapper call, the plain version and SDPA (its kernels' device
    time, names on record)."""
    out = []
    for i, (B, H, Hkv, T, D, causal) in enumerate(shapes):
        gen = torch.Generator(device="cpu").manual_seed(100 + i)
        q = torch.randn(B, H, T, D, generator=gen).to(dev, torch.bfloat16)
        k = torch.randn(B, Hkv, T, D, generator=gen).to(dev, torch.bfloat16)
        v = torch.randn(B, Hkv, T, D, generator=gen).to(dev, torch.bfloat16)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)
        o, lse = co.flash_attention_with_lse(q, k, v, causal=causal)
        o_p, lse_p = co._dense_with_lse(q, k, v, zero, zero, causal,
                                        D ** -0.5)
        eo = (o.float() - o_p.float()).abs().max().item()
        el = (lse - lse_p).abs().max().item()
        check(eo <= FLASH_O_ATOL and el <= FLASH_LSE_ATOL,
              "flash (%d,%d,%d,%d) disagrees with plain: %.3e / %.3e"
              % (B, H, T, D, eo, el))
        del o, lse, o_p, lse_p
        ms, _ = device_ms(lambda: co.flash_attention(q, k, v, causal=causal),
                          "flash_fwd")
        call_ms = time_ms(lambda: co.flash_attention(q, k, v, causal=causal))
        plain_ms = time_ms(lambda: co._dense_with_lse(
            q, k, v, zero, zero, causal, D ** -0.5), iters=5)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms, lib_k = device_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                               enable_gqa=Hkv != H))
        nbytes = 2 * (2 * B * H * T * D + 2 * B * Hkv * T * D) + 4 * B * H * T
        b_ms, b_by = bound_ms(nbytes, 4 * D * _pairs(B, H, T, causal))
        shape = "q(%d,%d,%d,%d) %s" % (B, H, T, D,
                                       "causal" if causal else "non-causal")
        print("flash timing %s: kernel %.4f ms (device), call %.4f ms "
              "(events), plain %.4f ms, SDPA %.4f ms (device; kernels %s), "
              "bound %.4f ms (%s); O err %.3e, lse err %.3e"
              % (shape, ms, call_ms, plain_ms, lib_ms,
                 ", ".join("%s %.4f" % kv for kv in lib_k.items()), b_ms,
                 b_by, eo, el))
        out.append({"shape": shape, "ms": ms, "call_ms": call_ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "library_kernels": lib_k, "bound_ms": b_ms,
                    "bound_by": b_by, "max_abs_err": eo,
                    "max_abs_err_lse": el})
        del q, k, v
    return out


# ----------------------------------------------------------------------
# phase 3: flash backward kernels vs plain _flash_bwd_dense
# ----------------------------------------------------------------------
def _bwd_inputs(co, gen, dev, B, H, Hkv, T, Tk, D, causal, qo, ko):
    """bf16 q/k/v/dO, the forward's O and lse, a random dlse, delta =
    rowsum(dO o O) - dlse, and the device offsets."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    q, k, v = rnd(B, H, T, D), rnd(B, Hkv, Tk, D), rnd(B, Hkv, Tk, D)
    do = rnd(B, H, T, D)
    offs = [torch.tensor([x], dtype=torch.int32, device=dev)
            for x in (qo, ko)]
    o, lse = co._flash_fwd_cuda(q, k, v, *offs, causal, D ** -0.5)
    dlse = torch.randn(B, H, T, generator=gen).to(dev)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    return q, k, v, do, o, lse, dlse, delta, offs


TRAIN_ATTN = (2, 32, 8, 1024, 128, True)     # (B, H, Hkv, T, D, causal)
BERT_ATTN = (16, 12, 12, 512, 64, False)


def flash_bwd_phase(co, dev, card):
    gen = torch.Generator(device="cpu").manual_seed(4)
    # (B, H, Hkv, T, Tk, causal, q_off, k_off, D); the last two are the
    # main paths' shapes: training, q (2,32,1024,128) causal over k/v
    # (2,8,1024,128), and BERT-base, q/k/v (16,12,512,64) non-causal
    cases = [(1, 32, 8, 128, 128, True, 0, 0, 128),
             (1, 32, 8, 128, 128, False, 0, 0, 128),
             (1, 32, 8, 300, 300, True, 0, 0, 128),
             (1, 32, 8, 300, 300, False, 0, 0, 128),
             (1, 32, 8, 1024, 1024, True, 0, 0, 128),
             (1, 32, 8, 1024, 1024, False, 0, 0, 128),
             # a later ring step: rows 0..99 of q see no key at all
             (1, 32, 8, 300, 428, True, 28, 128, 128),
             (1, 32, 8, 300, 300, True, 0, 0, 64),
             (2, 32, 8, 1024, 1024, True, 0, 0, 128),
             (16, 12, 12, 512, 512, False, 0, 0, 64)]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    abs_err = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    timed = {}
    for B, H, Hkv, T, Tk, causal, qo, ko, D in cases:
        inputs = _bwd_inputs(co, gen, dev, B, H, Hkv, T, Tk, D, causal, qo,
                             ko)
        q, k, v, do, o, lse, dlse, delta, offs = inputs
        # the forward's O and lse, which the backward takes, against plain
        o_p, lse_p = co._dense_with_lse(q, k, v, *offs, causal, D ** -0.5)
        masked = torch.isneginf(lse_p)
        check(torch.equal(torch.isneginf(lse), masked),
              "flash bwd: -inf lse rows of the forward differ")
        eo = (o.float() - o_p.float()).abs().max().item()
        el = (lse[~masked] - lse_p[~masked]).abs().max().item()
        check(eo <= FLASH_O_ATOL and el <= FLASH_LSE_ATOL,
              "flash bwd: the forward disagrees with plain: %.3e / %.3e "
              "(limits %.0e / %.0e)" % (eo, el, FLASH_O_ATOL, FLASH_LSE_ATOL))
        del o_p, lse_p
        want = co._flash_bwd_dense(q, k, v, do, lse, delta, *offs, causal,
                                   D ** -0.5)
        # delta computed inside the dq launch from O and dlse (the
        # training path), then given (the ring primitive's path)
        for how, extra in (("fused delta", dict(o=o, dlse=dlse)),
                           ("given delta", {})):
            got = co._flash_bwd_cuda(q, k, v, do, lse,
                                     None if extra else delta, *offs,
                                     causal, D ** -0.5, **extra)
            torch.cuda.synchronize()
            rel = {}
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w).abs().max().item()
                rel[name] = err / w.abs().max().item()
                abs_err[name] = max(abs_err[name], err)
                worst[name] = max(worst[name], rel[name])
            check(not got[0][masked[..., None].expand_as(got[0])].any(),
                  "flash bwd: dq of a fully masked row is not zero")
            print("flash bwd B=%d H=%d/%d T=%d Tk=%d causal=%s q_off=%d "
                  "k_off=%d D=%d, %s: forward O err %.3e, lse err %.3e; "
                  "max|d|/max|plain| dq %.3e dk %.3e dv %.3e, masked rows %d"
                  % (B, H, Hkv, T, Tk, causal, qo, ko, D, how, eo, el,
                     rel["dq"], rel["dk"], rel["dv"], int(masked.sum())))
            check(max(rel.values()) <= FLASH_BWD_TOL,
                  "flash bwd kernels disagree with plain (%s): %s (limit "
                  "%.0e)" % (how, rel, FLASH_BWD_TOL))
            del got
        del want
        shape = (B, H, Hkv, T, D, causal)
        if shape in (TRAIN_ATTN, BERT_ATTN) and T == Tk and qo == ko == 0:
            timed[shape] = inputs
        del inputs, q, k, v, do, o, lse, dlse, delta

    # timing on the main paths' inputs, the last two cases above
    ts = [bwd_timing(co, dev, card, shape, timed.pop(shape))
          for shape in (TRAIN_ATTN, BERT_ATTN)]
    for t in ts:
        others = sorted(k for k in t["backward_kernels"]
                        if "flash_bwd" not in k)
        check(not others, "the backward launched kernels besides dq and "
              "dk/dv (an eager delta pass?): %s" % others)
    t = ts[0]
    keys = ("plain_ms", "library_ms", "library_call_ms", "library_kernels",
            "backward_ms", "backward_call_ms", "backward_kernels",
            "delta_ms")
    common = {"route": "cuda", "source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
              **{k: t[k] for k in keys}}

    def shapes(kernel):
        return [dict({k: x[k] for k in ("shape",) + keys},
                     ms=x[kernel + "_ms"], call_ms=x[kernel + "_call"],
                     bound_ms=x[kernel + "_bound"][0],
                     bound_by=x[kernel + "_bound"][1]) for x in ts]
    return [dict(common, name="flash_bwd_dq",
                 replaces="mxnet_tpu/ops/pallas_ops.py:149",
                 max_abs_err=abs_err["dq"], max_rel_err=worst["dq"],
                 ms=t["dq_ms"], call_ms=t["dq_call"],
                 bound_ms=t["dq_bound"][0], bound_by=t["dq_bound"][1],
                 shapes=shapes("dq")),
            dict(common, name="flash_bwd_dkv",
                 replaces="mxnet_tpu/ops/pallas_ops.py:227",
                 max_abs_err=max(abs_err["dk"], abs_err["dv"]),
                 max_rel_err=max(worst["dk"], worst["dv"]),
                 ms=t["dkv_ms"], call_ms=t["dkv_call"],
                 bound_ms=t["dkv_bound"][0], bound_by=t["dkv_bound"][1],
                 shapes=shapes("dkv"))]


def bwd_timing(co, dev, card, shape=TRAIN_ATTN, inputs=None):
    """The backward at ``shape`` (B, H, Hkv, T, D, causal) over its
    inputs (made here unless given): each kernel's own device time and
    its call's event time; the whole port backward --
    ``torch.autograd.grad`` through ``flash_attention_with_lse`` with dO
    and a dlse cotangent, delta pass included wherever the tree does it
    -- by device time (all its kernels) and event time; SDPA's backward
    the same way; the eager delta pass and the plain version by event
    time.  Only calls that an earlier tree also has, so that this file
    copied into that tree's root times it the same way."""
    import inspect
    B, H, Hkv, T, D, causal = shape
    if inputs is None:
        gen = torch.Generator(device="cpu").manual_seed(104)
        inputs = _bwd_inputs(co, gen, dev, B, H, Hkv, T, T, D, causal, 0, 0)
    q, k, v, do, o, lse, dlse, delta, offs = inputs
    scale = D ** -0.5
    args = (q, k, v, do, lse, delta, *offs, causal, scale)
    if "o" in inspect.signature(co._flash_bwd_dq_cuda).parameters:
        scratch = torch.empty_like(delta)   # the dq launch writes delta

        def dq_fn():
            return co._flash_bwd_dq_cuda(q, k, v, do, lse, scratch, *offs,
                                         causal, scale, o=o, dlse=dlse)
    else:
        def dq_fn():
            return co._flash_bwd_dq_cuda(*args)
    dq_ms, _ = device_ms(dq_fn, "flash_bwd_dq")
    dkv_ms, _ = device_ms(lambda: co._flash_bwd_dkv_cuda(*args),
                          "flash_bwd_dkv")
    dq_call = time_ms(dq_fn)
    dkv_call = time_ms(lambda: co._flash_bwd_dkv_cuda(*args))
    delta_ms = time_ms(lambda: (do.float() * o.float()).sum(-1) - dlse)
    plain_ms = time_ms(lambda: co._flash_bwd_dense(*args), iters=5)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out, lse_g = co.flash_attention_with_lse(qg, kg, vg, causal=causal)

    def port_bwd():
        return torch.autograd.grad((out, lse_g), (qg, kg, vg), (do, dlse),
                                   retain_graph=True)
    port_ms, port_k = device_ms(port_bwd)
    port_call = time_ms(port_bwd)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ref = sdpa(qg, kg, vg, is_causal=causal, enable_gqa=Hkv != H)

    def sdpa_bwd():
        return torch.autograd.grad(ref, (qg, kg, vg), do, retain_graph=True)
    lib_ms, lib_k = device_ms(sdpa_bwd)
    lib_call = time_ms(sdpa_bwd)
    pairs = _pairs(B, H, T, causal)
    qd, kd = 2 * B * H * T * D, 2 * B * Hkv * T * D  # bytes of one q / k
    # dq: q, dO, O, k, v, lse and dlse read, dq and delta written
    dq_b = bound_ms(3 * qd + 2 * kd + 2 * 4 * B * H * T + qd + 4 * B * H * T,
                    6 * D * pairs)
    # dk/dv: q, dO, k, v, lse and delta read, dk and dv written
    dkv_b = bound_ms(2 * qd + 2 * kd + 2 * 4 * B * H * T + 2 * kd,
                     8 * D * pairs)
    name = "q(%d,%d,%d,%d) %s, kv (%d,%d,%d,%d)" % (
        B, H, T, D, "causal" if causal else "non-causal", B, Hkv, T, D)
    print("flash bwd timing %s: dq %.4f ms (device; call %.4f, bound %.4f, "
          "%s), dkv %.4f ms (device; call %.4f, bound %.4f, %s); whole port "
          "backward %.4f ms (device; call %.4f; kernels %s); SDPA backward "
          "%.4f ms (device; call %.4f; kernels %s); eager delta pass %.4f "
          "ms, plain %.4f ms (events) [%s]"
          % (name, dq_ms, dq_call, dq_b[0], dq_b[1], dkv_ms, dkv_call,
             dkv_b[0], dkv_b[1], port_ms, port_call,
             ", ".join("%s %.4f" % kv for kv in port_k.items()), lib_ms,
             lib_call, ", ".join("%s %.4f" % kv for kv in lib_k.items()),
             delta_ms, plain_ms, card))
    return {"shape": name, "dq_ms": dq_ms, "dq_call": dq_call,
            "dq_bound": dq_b, "dkv_ms": dkv_ms, "dkv_call": dkv_call,
            "dkv_bound": dkv_b, "backward_ms": port_ms,
            "backward_call_ms": port_call, "backward_kernels": port_k,
            "library_ms": lib_ms, "library_call_ms": lib_call,
            "library_kernels": lib_k, "delta_ms": delta_ms,
            "plain_ms": plain_ms}


# ----------------------------------------------------------------------
# phase 4: one training step of a small bf16 model, card vs CPU
# ----------------------------------------------------------------------
def parity_phase(mt, co, dev, card):
    """The same bf16 weights on CUDA (flash kernels) and on the CPU
    (plain versions): one forward + backward of the mean softmax-CE."""
    cfg = mt.models.LlamaConfig(vocab_size=32000, dim=1024, n_layers=2,
                                n_heads=8, n_kv_heads=2, hidden_dim=2816,
                                dtype="bfloat16")
    net = mt.models.TransformerLM(cfg, device=dev).initialize(
        torch.Generator(device=dev).manual_seed(5))
    cpu = mt.convert.load_params(mt.models.TransformerLM(cfg, device="cpu"),
                                 mt.convert.export_params(net))
    gen = torch.Generator().manual_seed(6)
    toks, labels = (torch.randint(0, cfg.vocab_size, (1, 256), generator=gen)
                    for _ in range(2))
    loss_fn = mt.gluon.loss.SoftmaxCELoss()
    losses = []
    co.reset_launch_counts()
    for model, d in ((net, dev), (cpu, "cpu")):
        logits = model(toks.to(d)).float()
        loss = loss_fn(logits.reshape(-1, cfg.vocab_size),
                       labels.to(d).reshape(-1)).mean()
        loss.backward()
        losses.append(loss.item())
    torch.cuda.synchronize()
    check(co.LAUNCHES["flash_bwd_dq"] == cfg.n_layers
          and co.LAUNCHES["flash_bwd_dkv"] == cfg.n_layers,
          "parity: the backward kernels did not run: %s" % co.LAUNCHES)
    rel = {}
    for (name, g), (_, p) in zip(net.named_parameters(),
                                 cpu.named_parameters()):
        gc, gp = g.grad.float().cpu(), p.grad.float()
        rel[name] = ((gc - gp).norm() / gp.norm()).item()
    for i in range(cfg.n_layers):
        for w in ("wq", "wk", "wv"):
            g = getattr(getattr(net, "layer%d" % i).attention, w).weight.grad
            check(g is not None and bool(g.any()),
                  "parity: layer%d %s has no gradient on CUDA" % (i, w))
    worst = max(rel, key=rel.get)
    print("parity (dim 1024, 8/2 heads, hidden 2816, 2 layers, vocab "
          "32000, T=256): loss cuda %.6f cpu %.6f; grad ||cuda-cpu||/||cpu||"
          " max %.3e (%s), median %.3e [%s]"
          % (losses[0], losses[1], rel[worst], worst,
             sorted(rel.values())[len(rel) // 2], card))
    check(abs(losses[0] - losses[1]) <= PARITY_LOSS_RTOL * abs(losses[1]),
          "parity: losses differ: %s" % losses)
    check(rel[worst] <= GRAD_REL_TOL, "parity: %s grad differs by %.3e "
          "(limit %.0e)" % (worst, rel[worst], GRAD_REL_TOL))
    return rel[worst]


# ----------------------------------------------------------------------
# phase 5: paged decode kernel vs plain _paged_dense
# ----------------------------------------------------------------------
def paged_phase(co, dev):
    """The paged decode kernel against plain at three shapes, each then
    timed: ``paged_phase`` (ragged lengths with an empty slot, one exactly
    full page and a full table), ``serve`` (the lengths of the served
    decode steps) and ``long`` (8 slots of 8192 tokens, 268 MB of K/V,
    where bytes really bound it)."""
    shapes = paged_timing(co, dev)
    head = shapes[1]
    return {"name": "paged_decode", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/paged_decode.cu",
            "replaces": "mxnet_tpu/ops/pallas_ops.py:621",
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            **{k: head[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            "library_ms": None, "shapes": shapes}


def paged_timing(co, dev):
    H, Hkv, D, psz = 32, 8, 128, 128
    cases = [("paged_phase", [0, 37, 128, 129, 300, 450, 531, 640], 5),
             ("serve", [51, 90, 128, 129, 200, 256, 300, 347], 5),
             ("long", [8192] * 8, 64)]
    out = []
    for i, (name, lens_h, MP) in enumerate(cases):
        gen = torch.Generator(device="cpu").manual_seed(200 + i)
        S = len(lens_h)
        P = S * MP + 1                         # page 0 is the trash page
        q = torch.randn(S, H, D, generator=gen).to(dev, torch.bfloat16)
        kp = torch.randn(P, Hkv, psz, D, generator=gen).to(dev,
                                                           torch.bfloat16)
        vp = torch.randn(P, Hkv, psz, D, generator=gen).to(dev,
                                                           torch.bfloat16)
        pt = (torch.randperm(P - 1, generator=gen) + 1).reshape(S, MP)
        pt = pt.to(dev, torch.int32)
        lens = torch.tensor(lens_h, dtype=torch.int32, device=dev)
        got = co.paged_attention(q, kp, vp, pt, lens)
        want = co._paged_dense(q, kp, vp, pt, lens, D ** -0.5)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        # the largest excess over the limit atol + rtol*|plain|, <= 0
        excess = (diff - PAGED_ATOL - PAGED_RTOL * want.float().abs()).max()
        check(excess.item() <= 0, "paged %s disagrees with plain: O err "
              "%.3e, over the limit by %.3e" % (name, err, excess.item()))
        for s, n in enumerate(lens_h):
            check(n > 0 or not got[s].any().item(),
                  "paged: an empty slot is not zero")
        del got, want, diff
        ms, _ = device_ms(lambda: co.paged_attention(q, kp, vp, pt, lens),
                          "paged_decode")
        call_ms = time_ms(lambda: co.paged_attention(q, kp, vp, pt, lens))
        plain_ms = time_ms(lambda: co._paged_dense(q, kp, vp, pt, lens,
                                                   D ** -0.5), iters=5)
        live = sum(lens_h)
        nbytes = 2 * live * Hkv * D * 2 + 2 * 2 * S * H * D + 4 * (S * MP + S)
        b_ms, b_by = bound_ms(nbytes, 4 * live * H * D)
        print("paged %s S=%d lengths %s: O err %.3e (limit %.0e + %.0e*"
              "|O|, exceeded by %.3e); kernel %.4f ms (device), call %.4f "
              "ms (events), plain %.4f ms, bound %.4f ms (%s)"
              % (name, S, lens_h if S <= 8 and MP < 64 else "%d x %d"
                 % (S, lens_h[0]), err, PAGED_ATOL, PAGED_RTOL,
                 excess.item(), ms, call_ms, plain_ms, b_ms, b_by))
        out.append({"shape": name, "lengths": lens_h, "ms": ms,
                    "call_ms": call_ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err})
        del q, kp, vp
        torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phase 6: serve a Llama-3-8B-width model through the port's Server
# ----------------------------------------------------------------------
def build_model(mt, dev, n_layers):
    cfg = mt.models.llama3_8b_config(dtype="bfloat16", n_layers=n_layers)
    net = mt.models.TransformerLM(cfg, device=dev)
    net.initialize(torch.Generator(device=dev).manual_seed(0), std=0.02)
    return net


def make_requests(vocab, seed=3):
    """16 requests, prompts of 20..500 tokens.  A, B and C share a
    256-token prefix: B prefills only its suffix (the chunk path), C is
    the prefix alone, so its last position lands in a cached page (COW).
    Two requests sample with fixed seeds; the rest are greedy."""
    gen = torch.Generator().manual_seed(seed)

    def toks(n):
        return torch.randint(1, vocab, (n,), generator=gen).tolist()

    shared = toks(256)
    reqs = [(shared + toks(44), None), (shared + toks(60), None),
            (shared, None)]
    for n in (20, 33, 64, 100, 127, 129, 200, 255, 300, 380, 450, 500):
        reqs.append((toks(n), None))
    reqs.append((toks(90), None))
    reqs[5] = (reqs[5][0], {"temperature": 0.8, "top_k": 50, "seed": 11})
    reqs[9] = (reqs[9][0], {"temperature": 1.0, "top_p": 0.9, "seed": 12})
    return reqs


def serve_phase(mt, co, net, dev, card, max_new=32, int8=False):
    """16 requests through the port's ``Server`` (bf16 weights, or the
    int8 path with ``int8=True``), whose warm pool serves them from CUDA
    graphs captured at start-up; returns (server, requests, results,
    launches of the serving run, counted per replay)."""
    tag = "serve int8" if int8 else "serve"
    scfg = mt.serve.ServeConfig(slots=8, page_size=128, pages=64,
                                ladder=(128, 256, 512), max_new=max_new,
                                int8=int8)
    torch.cuda.reset_peak_memory_stats()
    srv = mt.serve.Server(net, scfg)
    pool = srv.pool
    check(pool.stats["int8"] is int8, "%s: int8 %r" % (tag, pool.stats))
    check(pool.stats["programs"] == 1 + 2 * len(scfg.ladder),
          "%s: %d graphs captured, want %d" % (
              tag, pool.stats["programs"], 1 + 2 * len(scfg.ladder)))
    per_replay = {"decode": pool._decode.launches,
                  **{"prefill %d" % T: p.launches
                     for T, p in pool._prefill.items()},
                  **{"chunk %d" % T: p.launches
                     for T, p in pool._chunk.items()}}
    want = {"paged_decode": net.cfg.n_layers}
    want_pre = {"flash_fwd": net.cfg.n_layers}
    if int8:
        want["int8_linear"] = want_pre["int8_dequant"] = \
            7 * net.cfg.n_layers + 1
    check(per_replay["decode"] == want, "%s: the decode graph holds %s, "
          "want %s" % (tag, per_replay["decode"], want))
    check(per_replay["prefill 512"] == want_pre, "%s: a prefill graph "
          "holds %s, want %s" % (tag, per_replay["prefill 512"], want_pre))
    print("%s: KV pool %.3f GB; %d CUDA graphs captured in %.3f s; peak "
          "memory after capture %.2f GB; launches per replay %s [%s]"
          % (tag, pool.stats["pool_bytes"] / 1e9, pool.stats["programs"],
             pool.stats["capture_s"], torch.cuda.max_memory_allocated()
             / 1e9, per_replay, card))
    copies = []
    copy_page = pool.copy_page

    def counting_copy(src, dst):
        copies.append((src, dst))
        copy_page(src, dst)

    pool.copy_page = counting_copy
    reqs = make_requests(net.cfg.vocab_size)
    torch.cuda.synchronize()
    co.reset_launch_counts()
    t0 = time.monotonic()
    with srv:
        rids = [srv.submit(p, sampling=sp) for p, sp in reqs]
        res = [srv.result(r, timeout=600) for r in rids]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(co.LAUNCHES)
    for r in res:
        check(r is not None and r["state"] == "done"
              and len(r["tokens"]) == max_new,
              "request did not complete: %r" % (r and r.get("state"),))
    check(srv.sched.check_conservation() == [],
          "page conservation broken: %s" % srv.sched.check_conservation())
    check(srv.sched.check_refcounts() == [], "prefix refcounts broken")
    check(srv.sched.stats()["prefix_hits"] >= 2, "prefix cache never hit")
    check(len(copies) >= 1, "the COW page copy never ran")
    for name in ("flash_fwd", "paged_decode") + (
            ("int8_linear", "int8_dequant") if int8 else ()):
        check(launches[name] > 0, "kernel %s was not launched on the "
              "%s path" % (name, tag))
    steps = launches["paged_decode"] // net.cfg.n_layers
    if int8:
        check(launches["int8_linear"] == steps * want["int8_linear"],
              "%s: %d int8_linear launches over %d decode steps"
              % (tag, launches["int8_linear"], steps))
    ntok = sum(len(r["tokens"]) for r in res)
    ttft = sorted(r["t_first"] - r["t_submit"] for r in res)
    print("%s: %d requests, %d tokens in %.3f s = %.1f tokens/s; TTFT "
          "p50 %.1f ms; %d decode steps; launches (counted per replay) %s; "
          "COW copies %d; prefix hits %d; peak memory %.2f GB [%s]"
          % (tag, len(res), ntok, wall, ntok / wall,
             1e3 * ttft[len(ttft) // 2], steps, launches, len(copies),
             srv.sched.stats()["prefix_hits"],
             torch.cuda.max_memory_allocated() / 1e9, card))
    return srv, reqs, res, launches


def _replay_vs_eager(pool, program, run):
    """``run()`` (fill the static inputs, replay ``program``) against an
    eager call of the very function that was captured, from the same
    pools: whether the tokens and the K/V written are the same bits."""
    k0, v0 = pool.k_pages.clone(), pool.v_pages.clone()
    run()
    torch.cuda.synchronize()
    # page 0 is the trash page: padding tokens past true_len write there,
    # several to one slot where a chunk's padding outruns a page, in no
    # fixed order; no attended position reads it
    graphed = [t.clone() for t in (pool._dec_out, pool._pre_out,
                                   pool.k_pages[:, 1:], pool.v_pages[:, 1:])]
    pool.k_pages.copy_(k0)
    pool.v_pages.copy_(v0)
    with torch.no_grad():
        program.fn()
    torch.cuda.synchronize()
    eager = (pool._dec_out, pool._pre_out, pool.k_pages[:, 1:],
             pool.v_pages[:, 1:])
    check(not torch.equal(graphed[2], k0[:, 1:]), "the program wrote no K")
    return all(torch.equal(a, b) for a, b in zip(graphed, eager))


def graph_phase(srv, reqs, res, tag):
    """One decode replay, one prefill rung (512, a 500-token prompt) and
    one chunk rung (256: 44 tokens after 256 cached ones) against an
    eager call of the captured function on the same inputs, bit for
    bit: tokens and the K/V written into the pools."""
    import numpy as onp
    pool = srv.pool
    S, MP = pool.spec.slots, pool.spec.max_pages_per_slot
    table = onp.arange(1, 1 + S * MP, dtype=onp.int32).reshape(S, MP)
    lengths = onp.array([len(p) + 20 for p, _ in reqs[:S]], onp.int32)
    tokens = onp.array([r["tokens"][-1] for r in res[:S]], onp.int32)
    active = onp.ones(S, bool)
    sampling = [None] * S
    sampling[1] = {"seed": 7, "step": 5, "temperature": 0.8, "top_k": 50,
                   "top_p": 0.9}
    row = onp.arange(41, 41 + MP, dtype=onp.int32)
    prompt = onp.asarray(reqs[14][0], onp.int32)          # 500 tokens
    padded = onp.zeros(512, onp.int32)
    padded[:len(prompt)] = prompt
    chunk = onp.zeros(256, onp.int32)
    chunk[:44] = reqs[0][0][256:]
    cases = [
        ("decode", pool._decode, lambda: pool.run_decode(
            table, lengths, tokens, active, sampling=sampling)),
        ("prefill 512", pool._prefill[512], lambda: pool.run_prefill(
            padded, row, len(prompt))),
        ("chunk 256", pool._chunk[256], lambda: pool.run_prefill(
            chunk, row, 44, start=256,
            sampling={"seed": 3, "temperature": 0.7}))]
    for name, program, run in cases:
        check(_replay_vs_eager(pool, program, run), "%s: the %s graph's "
              "replay differs from the eager captured function"
              % (tag, name))
    print("%s: decode, prefill 512 and chunk 256 graph replays equal the "
          "eager captured functions bit for bit (tokens, K/V pools)" % tag)


def device_busy(fn, reps=5):
    """(host ms per call, device ms per call, top kernels, counts, {kernel
    name: (device ms, launches) per call}) of ``fn``: host time
    synchronized and unprofiled; device time the sum of the CUDA
    kernels' self time in a torch.profiler trace of the same calls;
    counts per call from that trace -- top-level aten ops, aten op
    events at every level, and device events (kernels, memcpy,
    memset)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.monotonic() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in kernels) / reps / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    aten = [e for e in prof.events() if e.device_type.name == "CPU"
            and e.name.startswith("aten::")]
    counts = {"top-level aten ops": sum(e.cpu_parent is None for e in aten),
              "aten op events": len(aten),
              "device events": sum(e.count for e in kernels)}
    counts = {k: v / reps for k, v in counts.items()}
    return host_ms, dev_ms, [(e.key[:40], e.self_device_time_total / reps
                              / 1e3) for e in top], counts, \
        {e.key: (e.self_device_time_total / reps / 1e3, e.count / reps)
         for e in kernels}


def step_timing(srv, reqs, res, card, tag="serve"):
    """Host time of one decode step (8 active slots at the lengths the
    served requests reached) and of one solo 500-token prefill (ladder
    rung 512) through the pool's CUDA graphs, each synchronized, beside
    the device time of their kernels from a profiler trace; then the
    same for an eager call of each captured function on the same
    inputs (what the graphs take off the host)."""
    import numpy as onp
    pool = srv.pool
    S, MP = pool.spec.slots, pool.spec.max_pages_per_slot
    table = onp.arange(1, 1 + S * MP, dtype=onp.int32).reshape(S, MP)
    lengths = onp.array([min(len(p) + 31, MP * 128 - 1)
                         for p, _ in reqs[:S]], onp.int32)
    tokens = onp.array([r["tokens"][-1] for r in res[:S]], onp.int32)
    active = onp.ones(S, bool)
    prompt = onp.asarray(reqs[14][0][:512], onp.int32)   # 500 tokens
    padded = onp.zeros(512, onp.int32)
    padded[:len(prompt)] = prompt
    row = onp.arange(41, 41 + MP, dtype=onp.int32)

    def eager(program, out):
        with torch.no_grad():
            program.fn()
        return out.cpu()

    out = {}
    for name, fn in (
            ("decode step", lambda: pool.run_decode(
                table, lengths, tokens, active).cpu()),
            ("decode step, eager", lambda: eager(pool._decode,
                                                 pool._dec_out)),
            ("prefill T=512", lambda: pool.run_prefill(
                padded, row, len(prompt))),
            ("prefill T=512, eager", lambda: eager(pool._prefill[512],
                                                   pool._pre_out))):
        ms, dev_ms, top, counts, _ = device_busy(fn)
        out[name] = (ms, dev_ms)
        print("%s %s: %.2f ms host, %.2f ms of kernels (device busy "
              "%.1f%%, host / kernels %.3f) [%s]; top kernels (ms per "
              "call): %s"
              % (tag, name, ms, dev_ms, 100 * dev_ms / ms, ms / dev_ms,
                 card, "; ".join("%s %.3f" % t for t in top)))
        ops = counts["top-level aten ops"]
        print("%s %s: per call %s; host us per top-level op %.2f"
              % (tag, name, ", ".join("%s %.1f" % kv
                                      for kv in counts.items()),
                 1e3 * ms / ops if ops else float("nan")))
    return out


# ----------------------------------------------------------------------
# phase 7: served tokens vs a full-sequence forward (teacher forced)
# ----------------------------------------------------------------------
def consistency_phase(net, reqs, res, dev, int8_layers=None):
    """Every greedy request's served tokens against a teacher-forced full
    forward of the same sequence: at every position the served token's
    logit is within SERVED_LOGIT_TOL of the full forward's largest, and
    at least SERVED_EXACT_MIN of the positions are its argmax.  With
    ``int8_layers`` (an int8 server's ``pool.int8``) the forward is the
    dequantized model's."""
    from mxnet_tpu_torch.contrib.quantization import int8_weights
    tag = "consistency int8" if int8_layers else "consistency"
    exact = checked = 0
    worst = (0.0, None)
    with torch.no_grad(), int8_weights(int8_layers or {}, "prefill"):
        for i, (prompt, sp) in enumerate(reqs):
            if sp is not None:
                continue
            served = list(res[i]["tokens"])
            seq = torch.tensor([prompt + served[:-1]], device=dev)
            logits = net(seq)[0, len(prompt) - 1:].float()
            got = logits.gather(1, torch.tensor(served, device=dev)[:, None])
            deficit = (logits.amax(dim=-1) - got[:, 0]).tolist()
            for pos, d in enumerate(deficit):
                checked += 1
                exact += d == 0.0
                if d > worst[0]:
                    worst = (d, (i, pos))
                check(d <= SERVED_LOGIT_TOL, "request %d position %d: the "
                      "served token is %.4f below the full forward's top "
                      "logit (limit %.2f)" % (i, pos, d, SERVED_LOGIT_TOL))
    print("%s: %d positions of %d greedy requests; served token "
          "= full-forward argmax at %d (%.1f%%); largest shortfall %.4f "
          "(request, position %s), limit %.2f"
          % (tag, checked, sum(sp is None for _, sp in reqs), exact,
             100 * exact / checked, worst[0], worst[1], SERVED_LOGIT_TOL))
    check(exact >= SERVED_EXACT_MIN * checked, "%s: only %d of %d "
          "served tokens are the full forward's argmax"
          % (tag, exact, checked))


# ----------------------------------------------------------------------
# the int8 decode product (W8A16) vs its plain version
# ----------------------------------------------------------------------
# limit on max|kernel - plain| / max|plain|: bf16 output rounding (one
# step is 2^-8 of the value) against cuBLAS's rounding and order;
# float32 summation order only
INT8_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# the decode's products at Llama-3-8B width: (name, K, N, launches per
# decode step of 32 layers)
INT8_SHAPES = [("wq, wo", 4096, 4096, 64), ("wk, wv", 4096, 1024, 64),
               ("w1, w3", 4096, 14336, 64), ("w2", 14336, 4096, 32),
               ("output", 4096, 128256, 1)]


def int8_kernel_phase(co, dev, card):
    """The int8 weight path's two kernels against their plain versions at
    the decode's five shapes and at an odd K and N, in bf16 and float32,
    each twice (same bits): ``int8_linear`` (``F.linear`` of the
    dequantized weight; at M = 1, 8 and 17 rows, limit INT8_TOL) and
    ``int8_dequant`` (``q * scale``, bit for bit).  Then, in bf16, each
    one's own device time (:func:`graph_ms`, a CUDA graph of the call
    replayed: torch.profiler dropped device records from traces of
    these kernels) beside its bound (bytes over 3.35 TB/s) and the plain
    version's event time.  Library: for ``int8_linear`` (M = 8) the
    dequantize + ``torch.matmul`` (no single PyTorch call computes it:
    the two calls, replayed as one graph), with a bf16 weight's product
    at the same shape (cuBLAS) for the record; for ``int8_dequant`` the
    one PyTorch call ``q * scale``.  Returns their kernels-line
    records."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.int8 import (dequantize, dequantize_plain,
                                          int8_linear, int8_linear_plain)
    gen = torch.Generator(device=dev).manual_seed(40)
    scale = 8e-4                   # N(0, 0.02) weights: max ~0.1 / 127
    errs, shapes, deq_shapes = {}, [], []
    for name, K, N, per_step in INT8_SHAPES + [("odd K, N", 4099, 1001,
                                                0)]:
        q = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                          dtype=torch.int8)
        for dt in INT8_TOL:
            check(torch.equal(dequantize(q, scale, dt),
                              dequantize_plain(q, scale, dt)),
                  "int8_dequant %s %s differs from plain" % (name, dt))
            for M in (1, 8, 17):
                x = torch.randn(M, K, generator=gen, device=dev).to(dt)
                got = int8_linear(x, q, scale)
                want = int8_linear_plain(x, q, scale)
                err = (got.float() - want.float()).abs().max().item()
                ref = want.float().abs().max().item()
                check(err <= INT8_TOL[dt] * ref, "int8_linear %s M=%d %s: "
                      "max|d| %.3e over %.0e * max|plain| %.3e"
                      % (name, M, dt, err, INT8_TOL[dt], ref))
                check(torch.equal(got, int8_linear(x, q, scale)),
                      "int8_linear %s M=%d %s: two calls differ"
                      % (name, M, dt))
                old = errs.get(dt, (0.0, 0.0))
                errs[dt] = (max(old[0], err), max(old[1], err / ref))
        if per_step:
            bf16 = torch.bfloat16
            x = torch.randn(8, K, generator=gen, device=dev).to(bf16)
            ms = graph_ms(lambda: int8_linear(x, q, scale))
            call_ms = time_ms(lambda: int8_linear(x, q, scale))
            plain_ms = time_ms(lambda: int8_linear_plain(x, q, scale),
                               iters=5)
            # the plain dequantize's product, with its scale made once
            # (a host-to-device copy cannot be captured)
            st = torch.tensor(scale, dtype=bf16, device=dev)
            lib_ms = graph_ms(lambda: torch.matmul(x, (q * st).t()))
            w16 = q * st
            bf16_ms = graph_ms(lambda: F.linear(x, w16))
            del w16
            b_ms, b_by = bound_ms(N * K + 2 * 8 * K + 2 * 8 * N,
                                  2 * 8 * N * K)
            print("int8_linear %s (M=8, K=%d, N=%d, bf16): kernel %.4f ms "
                  "(device), call %.4f ms, plain %.4f ms, bound %.4f ms "
                  "(%s), %.1f%% of it; library (dequantize + matmul) "
                  "%.4f ms; a bf16 weight's product %.4f ms [%s]"
                  % (name, K, N, ms, call_ms, plain_ms, b_ms, b_by,
                     100 * b_ms / ms, lib_ms, bf16_ms, card))
            shapes.append({"shape": name, "M": 8, "K": K, "N": N,
                           "per_decode_step": per_step, "ms": ms,
                           "call_ms": call_ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": lib_ms, "bf16_weight_ms": bf16_ms})
            d_ms = graph_ms(lambda: dequantize(q, scale, bf16))
            d_call = time_ms(lambda: dequantize(q, scale, bf16))
            d_plain = time_ms(lambda: dequantize_plain(q, scale, bf16))
            d_lib = graph_ms(lambda: q * st)
            d_bound, d_by = bound_ms(3 * N * K, N * K)
            print("int8_dequant %s (%d x %d, bf16): kernel %.4f ms "
                  "(device), call %.4f ms, plain %.4f ms, bound %.4f ms "
                  "(%s), %.1f%% of it; library (q * scale) %.4f ms [%s]"
                  % (name, N, K, d_ms, d_call, d_plain, d_bound, d_by,
                     100 * d_bound / d_ms, d_lib, card))
            deq_shapes.append({"shape": name, "N": N, "K": K,
                               "per_prefill": per_step, "ms": d_ms,
                               "call_ms": d_call, "plain_ms": d_plain,
                               "bound_ms": d_bound, "bound_by": d_by,
                               "library_ms": d_lib})
        del q
        torch.cuda.empty_cache()
    step = {k: sum(sh[k] * sh["per_decode_step"] for sh in shapes)
            for k in ("ms", "bound_ms", "library_ms", "bf16_weight_ms")}
    pre = {k: sum(sh[k] * sh["per_prefill"] for sh in deq_shapes)
           for k in ("ms", "bound_ms", "library_ms")}
    print("int8_linear: max|d| / max|plain| %s (limits %s); a decode "
          "step's 225 products %.3f ms of kernel, bound %.3f ms, library "
          "%.3f ms, bf16 weights %.3f ms; int8_dequant bit for bit, a "
          "prefill's 225 %.3f ms, bound %.3f ms, library %.3f ms [%s]"
          % ({str(k)[6:]: "%.2e" % v[1] for k, v in errs.items()},
             {str(k)[6:]: v for k, v in INT8_TOL.items()}, step["ms"],
             step["bound_ms"], step["library_ms"], step["bf16_weight_ms"],
             pre["ms"], pre["bound_ms"], pre["library_ms"], card))
    head, dhead = shapes[2], deq_shapes[2]          # w1, w3: the largest
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return [{"name": "int8_linear", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/int8_linear.cu",
             "replaces": "mxnet_tpu/serve.py:930",
             "max_abs_err": max(e[0] for e in errs.values()),
             **{k: head[k] for k in keys}, "decode_step": step,
             "shapes": shapes},
            {"name": "int8_dequant", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/int8_linear.cu",
             "replaces": "mxnet_tpu/serve.py:930", "max_abs_err": 0.0,
             **{k: dhead[k] for k in keys}, "prefill": pre,
             "shapes": deq_shapes}]


# ----------------------------------------------------------------------
# phase 8: train an 8-layer Llama-3-8B-width model (the slice-2 path)
# ----------------------------------------------------------------------
TRAIN_LAYERS = 8   # 32 layers need ~96 GB of AdamW state: > the 80 GB card


def train_phase(mt, co, dev, card, B=2, T=1024):
    """3 AdamW ``TrainStep`` steps, then one Gluon ``Trainer`` step, of
    ``llama3_8b_config(n_layers=8)`` on one batch; returns the launch
    counts of that run."""
    net = build_model(mt, dev, TRAIN_LAYERS)
    cfg = net.cfg
    V = cfg.vocab_size
    print("train model: llama3_8b_config widths (dim %d, %d/%d heads, "
          "hidden %d, vocab %d), depth cut to %d of 32 layers (AdamW keeps "
          "12 B/param: 32 layers need ~96 GB, the card has 80): %.3f B "
          "params" % (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.hidden_dim,
                      V, TRAIN_LAYERS, net.num_params() / 1e9))
    gen = torch.Generator(device=dev).manual_seed(7)
    toks, labels = (torch.randint(0, V, (B, T), device=dev, generator=gen)
                    for _ in range(2))
    loss_fn = mt.gluon.loss.SoftmaxCELoss()

    def fwd(model, tokens, lab):
        logits = model(tokens).float()
        return loss_fn(logits.reshape(-1, V), lab.reshape(-1)).mean()
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in net.named_parameters()}
    step = mt.parallel.TrainStep(net, None,
                                 mt.optimizer.AdamW(learning_rate=1e-3),
                                 forward_fn=fwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.reset_launch_counts()
    t0 = time.monotonic()
    losses = [step(toks, labels).item() for _ in range(3)]
    torch.cuda.synchronize()
    wall3 = time.monotonic() - t0
    with mt.autograd.record():
        loss = loss_fn(net(toks).float().reshape(B, T, V), labels)
    mt.autograd.backward(loss)
    del step                      # its AdamW state: the Trainer has its own
    trainer = mt.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 1e-3})
    trainer.step(B)
    torch.cuda.synchronize()
    launches = dict(co.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    gluon_loss = loss.mean().item()
    losses.append(gluon_loss)
    print("train losses (3 TrainStep steps, then the Gluon loop) %s"
          % losses)
    check(all(x == x and abs(x) != float("inf") for x in losses),
          "train: a loss is not finite: %s" % losses)
    check(losses[2] < losses[0], "train: the loss did not fall: %s"
          % losses)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == 4 * TRAIN_LAYERS,
              "train: %s launched %d times in 4 steps, want %d per step"
              % (name, launches[name], TRAIN_LAYERS))
    opt_per = check_opt_launches("train", launches, "multi_adam", 4,
                                 net.parameters())
    unchanged = [n for n, p in net.named_parameters()
                 if torch.equal(p.detach().cpu(), before[n])]
    check(not unchanged, "train: parameters did not change: %s" % unchanged)
    del before, trainer, loss
    torch.cuda.empty_cache()

    params = list(net.parameters())
    fb_ms, fb_dev, _, _, _ = device_busy(
        lambda: torch.autograd.grad(fwd(net, toks, labels), params), reps=2)
    step = mt.parallel.TrainStep(net, None,
                                 mt.optimizer.AdamW(learning_rate=1e-3),
                                 forward_fn=fwd)
    ms, dev_ms, top, counts, per = device_busy(
        lambda: step(toks, labels).item(), reps=2)
    opt_ms, opt_n = opt_cost(per)
    # useful model flops: 6 per matmul weight per token (the embedding
    # is a gather), attention 4 * D per visible pair forward, 8 * D back
    pairs = B * cfg.n_heads * T * (T + 1) // 2
    flops = 6 * (net.num_params() - V * cfg.dim) * B * T \
        + TRAIN_LAYERS * 12 * (cfg.dim // cfg.n_heads) * pairs
    print("train step (B=%d, T=%d, %d layers): %.1f ms host (3 steps in "
          "%.2f s), %.1f ms of kernels (device busy %.1f%%), %.0f tokens/s, "
          "%.1f model TFLOP/s (%.1f%% of 989), peak memory %.2f GB [%s]; "
          "top kernels (ms per step): %s"
          % (B, T, TRAIN_LAYERS, ms, wall3, dev_ms, 100 * dev_ms / ms,
             B * T / ms * 1e3, flops / ms / 1e9, flops / ms / 9.89e9,
             peak / 1e9, card, "; ".join("%s %.3f" % t for t in top)))
    print("train step: forward + backward alone %.1f ms host, %.1f ms of "
          "kernels; the rest of the step (AdamW over %.3f B params) %.1f ms "
          "of kernels, of which the multi_adam kernel %.2f ms in %g "
          "launches (%d per step by the table) [%s]"
          % (fb_ms, fb_dev, net.num_params() / 1e9, dev_ms - fb_dev, opt_ms,
             opt_n, opt_per, card))
    print("train step: per step %s" % ", ".join("%s %.1f" % kv
                                                for kv in counts.items()))
    lm = lm_adamw_timing(co, net, step._states, dev, card)
    return launches, lm


# ----------------------------------------------------------------------
# phase 9: ResNet-50 (__graft_entry__.entry()'s model) through the zoo
# ----------------------------------------------------------------------
RESNET_B, RESNET_TRAIN_B, RESNET_TRAIN_STEPS = 32, 128, 3
# Limits on ||a - b|| / ||b|| of the logits.  A replayed graph runs the
# eager call's kernels.  NHWC and NCHW may run different cuDNN kernels
# in bf16 (each rounding to bf16, a relative step of 2^-8).  The fp32
# card forward (TF32 off) against the CPU sums in another order only.
# Measured on an H100: replay and eager bitwise equal in both layouts;
# NHWC and NCHW bitwise equal (cuDNN transposes NCHW to NHWC and runs
# the same kernels); card vs CPU 1.08e-06.
RESNET_HYB_REL = 1e-3
RESNET_LAYOUT_REL = 1e-2
RESNET_CPU_REL = 1e-5
COPY_KERNEL = re.compile(r"copy|nchwToNhwc|nhwcToNchw|transpose", re.I)


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _resnet50(mt, dev, layout="NCHW"):
    """``resnet50_v1`` at full width, 1000 classes, its weights drawn
    from seed 0 on the card at the first forward."""
    net = mt.gluon.model_zoo.vision.resnet50_v1(layout=layout)
    return net.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(0))


def _ohwi(params):
    """NCHW zoo weights -> NHWC: conv weights OIHW -> OHWI."""
    import numpy as onp
    return {k: onp.ascontiguousarray(v.transpose(0, 2, 3, 1))
            if v.ndim == 4 else v for k, v in params.items()}


def resnet_phase(mt, co, dev, card):
    """ResNet-50 inference at ``__graft_entry__.entry()``'s shape (B=32,
    3x224x224, every parameter bf16), eager and hybridized, NCHW and
    NHWC, on the same weights; a B=2 float32 forward on the card against
    the CPU; then 3 training steps at B=128 in each layout.  Returns the
    launch counts of the training steps (both layouts)."""
    vision = mt.gluon.model_zoo.vision
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(RESNET_B, 3, 224, 224, generator=gen, device=dev).to(
        torch.bfloat16)
    nets = {"NCHW": _resnet50(mt, dev).cast("bfloat16")}
    inputs = {"NCHW": x, "NHWC": x.permute(0, 2, 3, 1).contiguous()}
    with mt.autograd.pause():
        eager = {"NCHW": nets["NCHW"](x)}
        params = mt.convert.export_params(nets["NCHW"])
        nets["NHWC"] = mt.convert.load_params(
            vision.resnet50_v1(layout="NHWC").initialize(device=dev).cast(
                "bfloat16"), _ohwi(params))
        eager["NHWC"] = nets["NHWC"](inputs["NHWC"])
        lay = _rel(eager["NHWC"], eager["NCHW"])
        print("resnet50 NHWC vs NCHW (same bf16 weights, B=%d): logits "
              "||d||/||NCHW|| %.3e (limit %.0e), max|d| %.4f of max|logit| "
              "%.4f" % (RESNET_B, lay, RESNET_LAYOUT_REL,
                        (eager["NHWC"].float() - eager["NCHW"].float()).abs()
                        .max().item(), eager["NCHW"].float().abs().max()
                        .item()))
        check(lay <= RESNET_LAYOUT_REL, "resnet50: NHWC disagrees with NCHW "
              "by %.3e" % lay)
    rows = []
    for layout in ("NCHW", "NHWC"):
        net, inp = nets[layout], inputs[layout]
        for mode in ("eager", "hybridized"):
            net.hybridize(mode == "hybridized")
            # MXNet's ``net.hybridize(); net(x)``: outside any record()
            # autograd is not recording, so no scope is needed to replay;
            # the eager forward runs under pause() to keep no tape
            scope = contextlib.nullcontext() if mode == "hybridized" \
                else mt.autograd.pause()
            with scope:
                if mode == "hybridized":
                    net(inp)                    # eager once, then capture
                    out = net(inp)              # replay
                    check(len(net._graphs) == 1 and not out.requires_grad,
                          "resnet50: no graph was captured")
                    rel = _rel(out, eager[layout])
                    print("resnet50 %s hybridized vs eager: bitwise equal "
                          "%s, ||d||/||eager|| %.3e (limit %.0e)"
                          % (layout, torch.equal(out, eager[layout]), rel,
                             RESNET_HYB_REL))
                    check(rel <= RESNET_HYB_REL, "resnet50 %s: hybridized "
                          "disagrees with eager by %.3e" % (layout, rel))
                host, dev_ms, top, counts, per = device_busy(
                    lambda: net(inp), reps=10)
                copies = ["%s: %.4f ms in %g launches" % (k[:60], ms, n)
                          for k, (ms, n) in per.items()
                          if COPY_KERNEL.search(k)]
                print("resnet50 %s %s forward (B=%d bf16): %.0f images/s, "
                      "%.2f ms host, %.2f ms of kernels (device busy %.1f%%),"
                      " %.1f device events per call; copy / layout kernels "
                      "per call: %s; top kernels %s [%s]"
                      % (layout, mode, RESNET_B, RESNET_B / host * 1e3, host,
                         dev_ms, 100 * dev_ms / host,
                         counts["device events"], "; ".join(copies) or "none",
                         "; ".join("%s %.3f" % t for t in top), card))
                rows.append((layout, mode, host))
        net.hybridize(False)
    print("resnet50 forward host ms, same run: %s"
          % ", ".join("%s %s %.2f" % r for r in rows))
    del nets, eager, inputs
    gc.collect()
    torch.cuda.empty_cache()
    resnet_cpu_check(mt, dev, params, x[:2].float())
    del params
    launches = {}
    for layout in ("NCHW", "NHWC"):
        for k, v in resnet_train(mt, co, dev, card, layout).items():
            launches[k] = launches.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def resnet_cpu_check(mt, dev, params, x):
    """The same weights in float32 on the card (cuDNN with TF32 off, the
    float32 matmul at full precision) and on the CPU: a B=2 forward."""
    vision = mt.gluon.model_zoo.vision
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with mt.autograd.pause():
            card = mt.convert.load_params(
                vision.resnet50_v1().initialize(device=dev), params)(x)
            cpu = mt.convert.load_params(
                vision.resnet50_v1().initialize(device="cpu"),
                params)(x.cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rel = _rel(card.cpu(), cpu)
    print("resnet50 float32 B=2, card (TF32 off) vs CPU: logits "
          "||d||/||cpu|| %.3e, max|d| %.3e (limit %.0e)"
          % (rel, (card.cpu() - cpu).abs().max().item(), RESNET_CPU_REL))
    check(rel <= RESNET_CPU_REL, "resnet50: the card disagrees with the CPU "
          "by %.3e" % rel)


def resnet_train(mt, co, dev, card, layout):
    """3 SGD steps (lr 0.05, momentum 0.9, wd 1e-4) at B=128 in
    ``layout``, BatchNorm in training mode, the softmax CE, then the
    steps timed.  Convolution and dense weights are bf16; BatchNorm's
    gains and statistics stay float32, as mixed precision keeps them (a
    bf16 running variance near 1 cannot take a step below half its
    2^-8 spacing)."""
    B = RESNET_TRAIN_B
    net = _resnet50(mt, dev, layout).cast("bfloat16")
    for m in net.modules():
        if isinstance(m, mt.gluon.nn.BatchNorm):
            m.cast("float32")
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(B, 3, 224, 224, generator=gen, device=dev).to(
        torch.bfloat16)
    if layout == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()
    labels = torch.randint(0, 1000, (B,), generator=gen, device=dev)
    with mt.autograd.pause():
        net(x[:2])                               # materialise the weights
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in net.named_parameters()}
    # lr 0.1 per 256 images (the linear scaling rule of ResNet training)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9,
                                "wd": 1e-4})
    loss_fn = mt.gluon.loss.SoftmaxCELoss()

    def step():
        with mt.autograd.record():
            loss = loss_fn(net(x).float(), labels)
        mt.autograd.backward(loss)
        trainer.step(B)
        return loss.mean().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.reset_launch_counts()
    t0 = time.monotonic()
    losses = [step() for _ in range(RESNET_TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(co.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    opt_per = check_opt_launches("resnet50 %s train" % layout, launches,
                                 "multi_sgd", RESNET_TRAIN_STEPS,
                                 net.parameters())
    check(all(math.isfinite(v) for v in losses), "resnet50 %s train: a loss "
          "is not finite: %s" % (layout, losses))
    unchanged = [n for n, p in net.named_parameters()
                 if torch.equal(p.detach().cpu(), before[n])]
    check(not unchanged, "resnet50 %s train: unchanged: %s"
          % (layout, unchanged))
    stats = sum("running" in n for n in before)
    del before
    ms, dev_ms, top, counts, per = device_busy(step, reps=2)
    opt_ms, opt_n = opt_cost(per)
    print("resnet50 train (B=%d, %s, SGD lr 0.05 momentum 0.9 wd 1e-4): "
          "losses %s;"
          " every one of %d trainable tensors and %d BatchNorm statistics "
          "changed; %d steps in %.2f s; step %.1f ms host, %.1f ms of "
          "kernels (device busy %.1f%%), %.0f images/s, peak memory %.2f GB "
          "[%s]; the multi_sgd kernel %.3f ms in %g launches per step (%d by "
          "the table); top kernels (ms per step): %s"
          % (B, layout, losses,
             sum(p.requires_grad for p in net.parameters()),
             stats, RESNET_TRAIN_STEPS, wall, ms, dev_ms, 100 * dev_ms / ms,
             B / ms * 1e3, peak / 1e9, card, opt_ms, opt_n, opt_per,
             "; ".join("%s %.3f" % t for t in top)))
    return launches


# ----------------------------------------------------------------------
# phase 10: BERT-base pretraining steps through the flash kernels
# ----------------------------------------------------------------------
BERT_B, BERT_T, BERT_STEPS = 16, 512, 3


def bert_batch(cfg, dev, B, T, seed):
    """Random tokens, two segments, MLM labels at every position and
    NSP labels."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device=dev)
    types = (torch.arange(T, device=dev) >= T // 2).long().expand(B, T)
    mlm = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev)
    nsp = torch.randint(0, 2, (B,), generator=gen, device=dev)
    return toks, types, mlm, nsp


def bert_loss(mt, net, toks, types, mlm, nsp):
    """Mean MLM + NSP softmax CE on float32 logits."""
    ce = mt.gluon.loss.SoftmaxCELoss()
    mlm_logits, nsp_logits = net(toks, types)
    V = mlm_logits.shape[-1]
    return ce(mlm_logits.float().reshape(-1, V), mlm.reshape(-1)).mean() \
        + ce(nsp_logits.float(), nsp).mean()


def bert_parity(mt, co, dev, card):
    """A small head_dim-64 BERT (hidden 256, 4 heads, 2 layers), the
    same bf16 weights on the card (flash kernels) and on the CPU (plain
    versions), dropout off: the loss and every grad, as ``parity_phase``
    compares them."""
    cfg = mt.models.bert_tiny_config(hidden_size=256, num_heads=4,
                                     intermediate_size=1024,
                                     dtype="bfloat16", dropout=0.0)
    net = mt.models.BERTForPretrain(cfg).initialize(
        device=dev, generator=torch.Generator(device=dev).manual_seed(5))
    cpu = mt.convert.load_params(
        mt.models.BERTForPretrain(cfg).initialize(device="cpu"),
        mt.convert.export_params(net))
    batch = bert_batch(cfg, "cpu", 2, 128, 6)
    losses = []
    co.reset_launch_counts()
    for model, d in ((net, dev), (cpu, "cpu")):
        with mt.autograd.record():
            loss = bert_loss(mt, model, *(t.to(d) for t in batch))
        mt.autograd.backward(loss)
        losses.append(loss.item())
    torch.cuda.synchronize()
    check(co.LAUNCHES["flash_fwd"] == co.LAUNCHES["flash_bwd_dq"]
          == co.LAUNCHES["flash_bwd_dkv"] == cfg.num_layers,
          "bert parity: the flash kernels did not run: %s" % co.LAUNCHES)
    rel = {}
    for (name, g), (_, p) in zip(net.named_parameters(),
                                 cpu.named_parameters()):
        gc_, gp = g.grad.float().cpu(), p.grad.float()
        rel[name] = ((gc_ - gp).norm() / gp.norm()).item()
    worst = max(rel, key=rel.get)
    print("bert parity (hidden 256, 4 heads of 64, 2 layers, vocab %d, "
          "B=2, T=128): loss cuda %.6f cpu %.6f; grad ||cuda-cpu||/||cpu|| "
          "max %.3e (%s), median %.3e [%s]"
          % (cfg.vocab_size, losses[0], losses[1], rel[worst], worst,
             sorted(rel.values())[len(rel) // 2], card))
    check(abs(losses[0] - losses[1]) <= PARITY_LOSS_RTOL * abs(losses[1]),
          "bert parity: losses differ: %s" % losses)
    check(rel[worst] <= GRAD_REL_TOL, "bert parity: %s grad differs by "
          "%.3e (limit %.0e)" % (worst, rel[worst], GRAD_REL_TOL))


def bert_phase(mt, co, dev, card):
    """``BERTForPretrain(bert_base_config())`` with bf16 weights, B=16,
    T=512, no ``valid_length`` (the flash path): 3 AdamW steps through
    the Gluon ``Trainer`` on one batch.  Returns the launch counts of
    those steps."""
    bert_parity(mt, co, dev, card)
    cfg = mt.models.bert_base_config(dtype="bfloat16")
    net = mt.models.BERTForPretrain(cfg).initialize(
        device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    nparams = sum(p.numel() for p in net.parameters())
    batch = bert_batch(cfg, dev, BERT_B, BERT_T, 7)
    before = {n: p.detach().to("cpu", copy=True)
              for n, p in net.named_parameters()}
    trainer = mt.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 2e-5, "wd": 0.01})

    def step():
        with mt.autograd.record():
            loss = bert_loss(mt, net, *batch)
        mt.autograd.backward(loss)
        trainer.step(1)
        return loss.item()
    torch.cuda.manual_seed(8)     # dropout's masks: the same every run
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.reset_launch_counts()
    t0 = time.monotonic()
    losses = [step() for _ in range(BERT_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(co.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print("bert-base train losses (%d AdamW steps, B=%d, T=%d) %s; launches "
          "%s" % (BERT_STEPS, BERT_B, BERT_T, losses, launches))
    check(all(math.isfinite(v) for v in losses), "bert: a loss is not "
          "finite: %s" % losses)
    check(losses[-1] < losses[0], "bert: the loss did not fall: %s" % losses)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == cfg.num_layers * BERT_STEPS,
              "bert: %s launched %d times in %d steps, want %d per step"
              % (name, launches[name], BERT_STEPS, cfg.num_layers))
    opt_per = check_opt_launches("bert", launches, "multi_adam", BERT_STEPS,
                                 net.parameters())
    unchanged = [n for n, p in net.named_parameters()
                 if torch.equal(p.detach().cpu(), before[n])]
    check(not unchanged, "bert: parameters did not change: %s" % unchanged)
    del before
    ms, dev_ms, top, counts, per = device_busy(step, reps=2)
    opt_ms, opt_n = opt_cost(per)
    print("bert-base train step (%.1f M params, bf16, B=%d, T=%d, dropout "
          "0.1): %d steps in %.2f s; step %.1f ms host, %.1f ms of kernels "
          "(device busy %.1f%%), %.1f samples/s, peak memory %.2f GB [%s]; "
          "the multi_adam kernel %.3f ms in %g launches per step (%d by the "
          "table); %s; top kernels (ms per step): %s"
          % (nparams / 1e6, BERT_B, BERT_T, BERT_STEPS, wall, ms, dev_ms,
             100 * dev_ms / ms, BERT_B / ms * 1e3, peak / 1e9, card, opt_ms,
             opt_n, opt_per, ", ".join("%s %.1f" % kv
                                       for kv in counts.items()),
             "; ".join("%s %.3f" % t for t in top)))
    return launches


# ----------------------------------------------------------------------
# phase 11: the general kernels, every dtype, head_dim and GQA ratio
# ----------------------------------------------------------------------
#: max |kernel - plain| / max |plain| per tensor against the plain
#: version on the same card inputs, TF32 off.  float32 and float64 differ
#: by the order of their sums only; a float16 / bf16 forward also by the
#: plain version rounding P to the input type before P V, where the
#: kernel keeps it in float32, and by one rounding of the output.  The
#: backward sums in float32 (float64) on both sides from the same
#: inputs, lse and delta, so every dtype is held to its accumulation
#: type's limit; the tensor-core kernels' float32 products are 3xTF32
#: (about 2^-22 of each product) summed in float32.  Measured on an H100
#: over the cases below: the tensor-core forward O 1.1e-6, lse 1.9e-7
#: (float32), O 8.1e-4 (float16), 4.8e-3 (bf16); the general forward
#: 2.8e-16 (float64), 4.6e-3 (bf16 at D 256); paged 4.3e-8 (bf16),
#: 7.8e-7 (float32), 5.4e-16 (float64); the general backward 8.8e-7, the
#: tensor-core backward 1.6e-6 (float32), 9.2e-7 (float16), 6.4e-7
#: (bf16).
GENERAL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5,
               torch.float16: 4e-3, torch.bfloat16: 2e-2}
_F16, _BF16, _F32, _F64 = (torch.float16, torch.bfloat16, torch.float32,
                           torch.float64)
# (B, H, Hkv, T, Tk, causal, q_off, k_off, D, dtype): fp16, fp32, fp64
# and bf16 at D 256; D 12, 16, 20, 32, 96, 256; GQA groups 1, 2, 3, 4
# and 32; causal and not, with ring-step offsets whose first rows see no
# key.  The forward and backward of the fp16 / bf16 / fp32 cases up to D
# 128 with 16-byte rows run the tensor-core kernels, of the others (fp64,
# D 256, fp16 D 12 and bf16 D 20 with 24- and 40-byte rows) the general
# ones (_flash_route), so every dtype is held on both routes.
GENERAL_FLASH_CASES = [
    (2, 8, 2, 200, 200, True, 0, 0, 16, _F16),
    (2, 8, 2, 130, 300, True, 170, 0, 16, _F32),
    (1, 4, 4, 257, 257, False, 0, 0, 32, _F32),
    (1, 32, 1, 128, 128, True, 0, 0, 32, _F16),
    (1, 32, 1, 96, 160, True, 0, 40, 96, _F32),
    (1, 8, 8, 100, 140, True, 10, 60, 96, _F64),
    (1, 8, 2, 160, 160, True, 0, 0, 256, _BF16),
    (1, 8, 2, 160, 160, False, 0, 0, 256, _F32),
    (1, 4, 1, 70, 70, True, 0, 0, 256, _F64),
    (2, 12, 12, 512, 512, False, 0, 0, 64, _F32),
    (1, 6, 2, 90, 130, True, 40, 0, 12, _F32),
    (1, 8, 2, 150, 150, True, 0, 0, 96, _BF16),
    (1, 8, 2, 120, 150, True, 0, 30, 12, _F16),
    (1, 6, 3, 100, 100, False, 0, 0, 20, _BF16),
]
# (S, H, Hkv, D, psz, MP, lengths, dtype): rep 16 and 32, page sizes 1,
# 7, 24 and 128, lengths of 0 and past the table, head_dim 256; the
# page-7 rep-32 case's splits of 32 keys cross pages
GENERAL_PAGED_CASES = [
    (3, 32, 2, 128, 16, 8, [0, 100, 128], _BF16),
    (2, 32, 1, 64, 24, 6, [1, 144], _F32),
    (2, 4, 2, 16, 1, 50, [50, 0], _F32),
    (2, 8, 2, 256, 128, 3, [200, 384], _BF16),
    (2, 8, 8, 96, 24, 4, [60, 0], _F64),
    (3, 8, 4, 32, 7, 5, [34, 5, 7], _F16),
    (8, 32, 8, 128, 128, 3, [51, 90, 128, 129, 200, 256, 300, 347], _F32),
    (3, 32, 1, 64, 7, 40, [0, 131, 300], _F32),
]


@contextlib.contextmanager
def exact_fp32():
    """The plain oracle in full float32: TF32 off for matmuls and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _rel_err(got, want):
    """(max |got - want|, that over max |want|)."""
    err = (got.double() - want.double()).abs().max().item()
    return err, err / max(want.double().abs().max().item(), 1e-300)


def _general_check(co, dev, errs):
    """Each general kernel, and the tensor-core forward and backward,
    against its plain version over the cases above, each flash case on
    the route ``_flash_route`` gives it; fills ``errs`` {kernel: (max
    abs err, max rel err)}."""
    gen = torch.Generator(device="cpu").manual_seed(11)

    def note(kernel, name, dt, got, want, tol):
        err, rel = _rel_err(got, want)
        a, r = errs.get(kernel, (0.0, 0.0))
        errs[kernel] = (max(a, err), max(r, rel))
        check(rel <= tol, "%s %s (%s) disagrees with plain: %.3e of max"
              "|plain| (limit %.0e)" % (kernel, name, dt, rel, tol))
        return rel

    for B, H, Hkv, T, Tk, causal, qo, ko, D, dt in GENERAL_FLASH_CASES:
        def rnd(*shape):
            return torch.randn(*shape, generator=gen,
                               dtype=torch.float64).to(dev, dt)
        q, k, v, do = rnd(B, H, T, D), rnd(B, Hkv, Tk, D), \
            rnd(B, Hkv, Tk, D), rnd(B, H, T, D)
        offs = [torch.tensor([x], dtype=torch.int32, device=dev)
                for x in (qo, ko)]
        scale = D ** -0.5
        route = co._route_of(q, k, v, do)
        fwd = "flash_fwd_" + co.FWD_ROUTES[route][1]
        before = dict(co.LAUNCHES)
        o, lse = co._flash_fwd_cuda(q, k, v, *offs, causal, scale)
        o2, lse2 = co._flash_fwd_cuda(q, k, v, *offs, causal, scale)
        o_p, lse_p = co._dense_with_lse(q, k, v, *offs, causal, scale)
        masked = torch.isneginf(lse_p)
        check(torch.equal(torch.isneginf(lse), masked) and not o[
            masked[..., None].expand_as(o)].any(),
            "general flash: rows that see no key differ")
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              "%s (%s): two calls differ" % (fwd, dt))
        tol = GENERAL_TOL[dt]
        r_o = note(fwd, "O", dt, o, o_p, tol)
        r_l = note(fwd, "lse", dt, lse[~masked], lse_p[~masked],
                   max(tol, 2 ** -23))
        dlse = torch.randn(B, H, T, generator=gen).to(dev)
        delta = co._delta(do, o_p, dlse)
        want = co._flash_bwd_dense(q, k, v, do, lse_p, delta, *offs, causal,
                                   scale)
        btol = GENERAL_TOL[_F64 if dt == _F64 else _F32]
        check(co._route_of(q, k, v, do, o_p) == route,
              "general flash: the forward and backward routes differ")
        suffix = "_" + co.BWD_ROUTES[route][1]
        rels = {}
        for how, kw in (("fused delta", dict(o=o_p, dlse=dlse)),
                        ("given delta", {})):
            got = co._flash_bwd_cuda(q, k, v, do, lse_p,
                                     None if kw else delta, *offs, causal,
                                     scale, **kw)
            again = co._flash_bwd_cuda(q, k, v, do, lse_p,
                                       None if kw else delta, *offs, causal,
                                       scale, **kw)
            for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
                kern = "flash_bwd_%s%s" % ("dq" if name == "dq" else "dkv",
                                           suffix)
                check(torch.equal(g, g2), "%s %s (%s): two calls differ"
                      % (kern, name, dt))
                rels[name] = max(rels.get(name, 0.0),
                                 note(kern, "%s, %s" % (name, how), dt, g, w,
                                      btol))
        torch.cuda.synchronize()
        for kern, n in ((fwd, 2), ("flash_bwd_dq" + suffix, 4),
                        ("flash_bwd_dkv" + suffix, 4)):
            check(co.LAUNCHES[kern] == before[kern] + n,
                  "general flash: %s did not run" % kern)
        print("general flash %s B=%d H=%d/%d T=%d Tk=%d D=%d causal=%s "
              "q_off=%d k_off=%d, on %s: max|d|/max|plain| O %.2e lse %.2e "
              "(limit %.0e); backward: dq %.2e dk %.2e dv %.2e (limit %.0e), "
              "bitwise repeatable; rows seeing no key %d"
              % (str(dt)[6:], B, H, Hkv, T, Tk, D, causal, qo, ko, route,
                 r_o, r_l, tol, rels["dq"], rels["dk"], rels["dv"], btol,
                 int(masked.sum())))
        del q, k, v, do, o, lse, o2, lse2, o_p, lse_p, got, again, want
    for S, H, Hkv, D, psz, MP, lens_h, dt in GENERAL_PAGED_CASES:
        P = S * MP + 1
        q = torch.randn(S, H, D, generator=gen, dtype=torch.float64).to(
            dev, dt)
        kp, vp = (torch.randn(P, Hkv, psz, D, generator=gen,
                              dtype=torch.float64).to(dev, dt)
                  for _ in range(2))
        pt = (torch.randperm(P - 1, generator=gen) + 1).reshape(S, MP).to(
            dev, torch.int32)
        lens = torch.tensor(lens_h, dtype=torch.int32, device=dev)
        before = co.LAUNCHES["paged_decode_general"]
        got = co.paged_attention(q, kp, vp, pt, lens)
        again = co.paged_attention(q, kp, vp, pt, lens)
        torch.cuda.synchronize()
        check(co.LAUNCHES["paged_decode_general"] == before + 2,
              "general paged: the kernel did not run")
        check(torch.equal(got, again), "general paged: two calls differ")
        for s, n in enumerate(lens_h):
            check(n > 0 or not got[s].any().item(),
                  "general paged: an empty slot is not zero")
        rel = note("paged_decode_general", "O", dt, got,
                   co._paged_dense(q, kp, vp, pt, lens, D ** -0.5),
                   GENERAL_TOL[dt])
        nsplit, kps, _ = co.paged_general_plan(S, H, Hkv, MP, psz)
        print("general paged %s S=%d H=%d/%d (rep %d) D=%d page %d, lengths "
              "%s, %d splits of %d keys: max|d|/max|plain| %.2e (limit "
              "%.0e), bitwise repeatable"
              % (str(dt)[6:], S, H, Hkv, H // Hkv, D, psz, lens_h, nsplit,
                 kps, rel, GENERAL_TOL[dt]))
        del q, kp, vp, got, again


TF32_FLOPS_PER_S = 495e12       # H100 SXM dense TF32 tensor cores


def general_timing(co, dev, card):
    """The kernels of BERT-base's float32 attention, q/k/v (16, 12, 512,
    64) non-causal: the tensor-core forward, dq and dk/dv (the route the
    path takes) and the whole backward by device time; the general
    (SIMT) forward, dq and dk/dv on the same inputs through their
    launchers (no public route reaches them at float32); SDPA on the
    same float32 inputs as the library call; the plain versions by
    event time; paged decode at the serving shape (8 slots, 32/8 heads
    of 128, pages of 128) in float32.  The paged and SIMT bounds use the
    float32 rate outside the tensor cores; the bound of a tensor-core
    kernel is its 3xTF32 floor, three passes of its flops at the
    published dense TF32 rate (the float32 one beside it as
    ``bound_fp32_ms``)."""
    B, H, Hkv, T, D, causal = BERT_ATTN
    gen = torch.Generator(device="cpu").manual_seed(12)
    q, k, v, do = (torch.randn(B, n, T, D, generator=gen).to(dev)
                   for n in (H, Hkv, Hkv, H))
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    scale = D ** -0.5
    o, lse = co._flash_fwd_cuda(q, k, v, zero, zero, causal, scale)
    dlse = torch.zeros_like(lse)
    delta = co._delta(do, o, dlse)
    check(co._route_of(q, k, v, do, o) == "mma", "BERT's float32 forward "
          "and backward do not route to the tensor cores")
    fwd_ms = {}
    fwd_ms["mma"], _ = device_ms(lambda: co.flash_attention(q, k, v),
                                 "fwd_mma")
    fwd_call = time_ms(lambda: co.flash_attention(q, k, v))
    # the earlier design on the same inputs, through its launcher
    fwd_ms["simt"], _ = device_ms(lambda: co._flash_fwd_general(
        q, k, v, zero, zero, causal, scale, "simt"), "fwd_general")
    scratch = torch.empty_like(delta)
    dq_ms, dkv_ms = {}, {}
    dq_ms["mma"], _ = device_ms(lambda: co._flash_bwd_dq_cuda(
        q, k, v, do, lse, scratch, zero, zero, causal, scale, o=o,
        dlse=dlse), "dq_mma")
    dkv_ms["mma"], _ = device_ms(lambda: co._flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, zero, zero, causal, scale), "dkv_mma")
    # the earlier design on the same inputs, through its launcher
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dq_ms["simt"], _ = device_ms(lambda: co._launch_bwd_general(
        "flash_bwd_dq", (q, k, v, do, o, lse, dlse, scratch, zero, zero, dq),
        q, k, causal, scale, "simt"), "dq_general")
    dkv_ms["simt"], _ = device_ms(lambda: co._launch_bwd_general(
        "flash_bwd_dkv", (q, k, v, do, lse, delta, zero, zero, dk, dv), q,
        k, causal, scale, "simt"), "dkv_general")
    with exact_fp32():
        fwd_plain = time_ms(lambda: co._dense_with_lse(
            q, k, v, zero, zero, causal, scale), iters=5)
        bwd_plain = time_ms(lambda: co._flash_bwd_dense(
            q, k, v, do, lse, delta, zero, zero, causal, scale), iters=5)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = co.flash_attention(qg, kg, vg)
    bwd_ms, bwd_k = device_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd, lib_fk = device_ms(lambda: sdpa(q, k, v))
    ref = sdpa(qg, kg, vg)
    lib_bwd, lib_bk = device_ms(lambda: torch.autograd.grad(
        ref, (qg, kg, vg), do, retain_graph=True))
    pairs = _pairs(B, H, T, causal)
    qd = 4 * B * H * T * D                      # bytes of one float32 q
    fwd_b = bound_ms(4 * qd + 4 * B * H * T, 4 * D * pairs, FP32_FLOPS_PER_S)
    fwd_floor = bound_ms(4 * qd + 4 * B * H * T, 3 * 4 * D * pairs,
                         TF32_FLOPS_PER_S)
    # (bytes, flops per pair and head-dim element) of dq, dk/dv and both
    work = {"dq": (6 * qd + 3 * 4 * B * H * T, 6),
            "dkv": (6 * qd + 2 * 4 * B * H * T, 8),
            "bwd": (8 * qd + 2 * 4 * B * H * T, 14)}
    fp32_b = {n: bound_ms(nb, f * D * pairs, FP32_FLOPS_PER_S)
              for n, (nb, f) in work.items()}
    floor = {n: bound_ms(nb, 3 * f * D * pairs, TF32_FLOPS_PER_S)
             for n, (nb, f) in work.items()}
    shape = "q/k/v (%d,%d,%d,%d) float32 non-causal" % (B, H, T, D)
    print("general flash timing %s: tensor-core forward %.4f ms (device; "
          "call %.4f; general %.4f; float32 bound %.4f, %s; 3xTF32 floor "
          "%.4f; plain %.4f; SDPA %.4f, kernels %s); tensor-core "
          "dq %.4f ms, dk/dv %.4f ms (general: %.4f, %.4f; float32 bound "
          "%.4f, %.4f; 3xTF32 floor %.4f, %.4f), whole backward %.4f ms "
          "(device; kernels %s; float32 bound %.4f; 3xTF32 floor %.4f; "
          "general pair %.4f; plain %.4f; SDPA backward %.4f, kernels %s) "
          "[%s]"
          % (shape, fwd_ms["mma"], fwd_call, fwd_ms["simt"], fwd_b[0],
             fwd_b[1], fwd_floor[0], fwd_plain, lib_fwd,
             ", ".join("%s %.4f" % kv for kv in lib_fk.items()),
             dq_ms["mma"], dkv_ms["mma"], dq_ms["simt"], dkv_ms["simt"],
             fp32_b["dq"][0], fp32_b["dkv"][0], floor["dq"][0],
             floor["dkv"][0], bwd_ms,
             ", ".join("%s %.4f" % kv for kv in bwd_k.items()),
             fp32_b["bwd"][0], floor["bwd"][0],
             dq_ms["simt"] + dkv_ms["simt"], bwd_plain,
             lib_bwd, ", ".join("%s %.4f" % kv for kv in lib_bk.items()),
             card))
    del q, k, v, do, o, qg, kg, vg, out, ref, dq, dk, dv
    torch.cuda.empty_cache()
    # paged decode at the serving shape, float32
    S, Hq, Hk, Dp, psz, MP = 8, 32, 8, 128, 128, 3
    lens_h = [51, 90, 128, 129, 200, 256, 300, 347]
    P = S * MP + 1
    qp = torch.randn(S, Hq, Dp, generator=gen).to(dev)
    kp, vp = (torch.randn(P, Hk, psz, Dp, generator=gen).to(dev)
              for _ in range(2))
    pt = (torch.randperm(P - 1, generator=gen) + 1).reshape(S, MP).to(
        dev, torch.int32)
    lens = torch.tensor(lens_h, dtype=torch.int32, device=dev)
    pg_ms, _ = device_ms(lambda: co.paged_attention(qp, kp, vp, pt, lens),
                         "paged_general")
    pg_call = time_ms(lambda: co.paged_attention(qp, kp, vp, pt, lens))
    with exact_fp32():
        pg_plain = time_ms(lambda: co._paged_dense(qp, kp, vp, pt, lens,
                                                   Dp ** -0.5), iters=5)
    live = sum(lens_h)
    pg_b = bound_ms(2 * live * Hk * Dp * 4 + 2 * 4 * S * Hq * Dp
                    + 4 * (S * MP + S), 4 * live * Hq * Dp, FP32_FLOPS_PER_S)
    pshape = "S=%d H=%d/%d D=%d page %d float32, lengths %s" % (
        S, Hq, Hk, Dp, psz, lens_h)
    print("general paged timing %s: %.4f ms (device; call %.4f; bound %.4f, "
          "%s; plain %.4f) [%s]" % (pshape, pg_ms, pg_call, pg_b[0], pg_b[1],
                                    pg_plain, card))
    common = {"shape": shape, "library_kernels_forward": lib_fk,
              "library_kernels_backward": lib_bk, "backward_ms": bwd_ms,
              "backward_kernels": bwd_k,
              "backward_bound_ms": floor["bwd"][0],
              "backward_bound_fp32_ms": fp32_b["bwd"][0],
              "backward_plain_ms": bwd_plain, "backward_library_ms": lib_bwd}
    bwd = {}
    for route, (_, tag) in co.BWD_ROUTES.items():
        for kern, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
            b = floor[kern] if route == "mma" else fp32_b[kern]
            extra = {"bound_fp32_ms": fp32_b[kern][0]} if route == "mma" \
                else {}
            bwd["flash_bwd_%s_%s" % (kern, tag)] = dict(
                common, ms=ms[route], plain_ms=bwd_plain, bound_ms=b[0],
                bound_by=b[1], library_ms=lib_bwd, **extra)
    return {"flash_fwd_mma": dict(
                common, ms=fwd_ms["mma"], call_ms=fwd_call,
                plain_ms=fwd_plain, bound_ms=fwd_floor[0],
                bound_by=fwd_floor[1], bound_fp32_ms=fwd_b[0],
                library_ms=lib_fwd),
            "flash_fwd_general": dict(
                common, ms=fwd_ms["simt"], plain_ms=fwd_plain,
                bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=lib_fwd),
            **bwd,
            "paged_decode_general": dict(
                shape=pshape, ms=pg_ms, call_ms=pg_call, plain_ms=pg_plain,
                bound_ms=pg_b[0], bound_by=pg_b[1], library_ms=None)}


def general_kernel_phase(co, dev, card):
    """The four general kernels and the three tensor-core kernels
    against their plain versions, then timed; returns their records for
    the kernels line."""
    errs = {}
    with exact_fp32():
        _general_check(co, dev, errs)
    timing = general_timing(co, dev, card)
    pallas = "mxnet_tpu/ops/pallas_ops.py:"
    # name -> (TPU kernel it replaces, source)
    kernels = {"flash_fwd_general": ("62", "flash_general"),
               "flash_bwd_dq_general": ("149", "flash_general"),
               "flash_bwd_dkv_general": ("227", "flash_general"),
               "paged_decode_general": ("621", "paged_general"),
               "flash_fwd_mma": ("62", "flash_fwd_mma"),
               "flash_bwd_dq_mma": ("149", "flash_bwd_mma"),
               "flash_bwd_dkv_mma": ("227", "flash_bwd_mma")}
    return [dict({"name": name, "route": "cuda",
                  "source": "mxnet_tpu_torch/csrc/%s.cu" % src,
                  "replaces": pallas + line, "max_abs_err": errs[name][0],
                  "max_rel_err": errs[name][1]}, **timing[name])
            for name, (line, src) in kernels.items()]


# ----------------------------------------------------------------------
# phase 12: BERT-base at its default float32: the tensor-core forward
# and backward
# ----------------------------------------------------------------------
def bert_fp32_phase(mt, co, dev, card):
    """``BERTForPretrain(bert_base_config())`` at its default float32,
    B=16, T=512, no ``valid_length``: 3 AdamW steps through the Gluon
    ``Trainer``, attention on the tensor-core forward and
    backward.  Returns the launch counts of those steps."""
    cfg = mt.models.bert_base_config()
    check(cfg.dtype == "float32", "bert_base_config is not float32: %s"
          % cfg.dtype)
    net = mt.models.BERTForPretrain(cfg).initialize(
        device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    nparams = sum(p.numel() for p in net.parameters())
    batch = bert_batch(cfg, dev, BERT_B, BERT_T, 7)
    trainer = mt.gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": 2e-5, "wd": 0.01})

    def step():
        with mt.autograd.record():
            loss = bert_loss(mt, net, *batch)
        mt.autograd.backward(loss)
        trainer.step(1)
        return loss.item()
    torch.cuda.manual_seed(9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.reset_launch_counts()
    t0 = time.monotonic()
    losses = [step() for _ in range(BERT_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(co.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses), "bert fp32: a loss is not "
          "finite: %s" % losses)
    for name, per_step in (("flash_fwd_mma", cfg.num_layers),
                           ("flash_fwd_general", 0),
                           ("flash_bwd_dq_mma", cfg.num_layers),
                           ("flash_bwd_dkv_mma", cfg.num_layers),
                           ("flash_bwd_dq_general", 0),
                           ("flash_bwd_dkv_general", 0)):
        check(launches[name] == per_step * BERT_STEPS,
              "bert fp32: %s launched %d times in %d steps, want %d per step"
              % (name, launches[name], BERT_STEPS, per_step))
    opt_per = check_opt_launches("bert fp32", launches, "multi_adam",
                                 BERT_STEPS, net.parameters())
    ms, dev_ms, top, counts, per = device_busy(step, reps=2)
    opt_ms, opt_n = opt_cost(per)
    print("bert-base float32 train (%.1f M params, B=%d, T=%d, dropout 0.1, "
          "%d AdamW steps): losses %s; launches per step %s; step %.1f ms "
          "host (%d steps in %.2f s), %.1f ms of kernels (device busy "
          "%.1f%%), %.1f samples/s, peak memory %.2f GB [%s]; the "
          "multi_adam kernel %.3f ms in %g launches per step (%d by the "
          "table); top kernels (ms per step): %s"
          % (nparams / 1e6, BERT_B, BERT_T, BERT_STEPS, losses,
             {k: v / BERT_STEPS for k, v in launches.items() if v}, ms,
             BERT_STEPS, wall, dev_ms, 100 * dev_ms / ms, BERT_B / ms * 1e3,
             peak / 1e9, card, opt_ms, opt_n, opt_per,
             "; ".join("%s %.3f" % t for t in top)))
    return launches


# ----------------------------------------------------------------------
# phase 13: the float32 tiny models on the card against the CPU
# ----------------------------------------------------------------------
# tiny_config losses over 3 AdamW steps, card vs CPU: the same float32
# weights and batch, sums taken in another order only (measured on an
# H100: 9.9e-8).
TINY_LOSS_RTOL = 1e-4
# bert_tiny_config (float32, head_dim 32): the loss and each grad,
# ||card - cpu|| / ||cpu|| (measured: loss 6.2e-8, grads 1.3e-5).
TINY_GRAD_REL = 1e-4


def tiny_fp32_phase(mt, co, dev, card):
    """``tiny_config()`` (float32, head_dim 16): greedy serving through
    ``Server`` and 3 AdamW ``TrainStep`` steps, card against CPU;
    ``bert_tiny_config()`` (float32, head_dim 32): the loss and grads,
    card against CPU.  Returns the launch counts of the card runs."""
    cfg = mt.models.tiny_config()
    check(cfg.dtype == "float32" and cfg.dim // cfg.n_heads == 16,
          "tiny_config is not float32 at head_dim 16")
    nets = {"cuda": mt.models.TransformerLM(cfg, device=dev).initialize(
        torch.Generator(device=dev).manual_seed(0), std=0.1)}
    nets["cpu"] = mt.convert.load_params(
        mt.models.TransformerLM(cfg, device="cpu"),
        mt.convert.export_params(nets["cuda"]))
    gen = torch.Generator().manual_seed(13)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (5, 11, 23, 30)]
    toks, labels = (torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
                    for _ in range(2))
    loss_fn = mt.gluon.loss.SoftmaxCELoss()

    def fwd(model, t, lab):
        return loss_fn(model(t).reshape(-1, cfg.vocab_size),
                       lab.reshape(-1)).mean()
    served, losses = {}, {}
    co.reset_launch_counts()
    with exact_fp32():
        for name, d in (("cuda", dev), ("cpu", "cpu")):
            scfg = mt.serve.ServeConfig(slots=3, page_size=8, pages=24,
                                        ladder=(16, 32), max_new=8)
            with mt.serve.Server(nets[name], scfg) as srv:
                rids = [srv.submit(p) for p in prompts]
                served[name] = [srv.result(r, timeout=300)["tokens"]
                                for r in rids]
            step = mt.parallel.TrainStep(
                nets[name], None, mt.optimizer.AdamW(learning_rate=1e-2),
                forward_fn=fwd)
            losses[name] = [step(toks.to(d), labels.to(d)).item()
                            for _ in range(3)]
        # then 3 LAMB steps from there (the optimizer's two LAMB kernels)
        lamb = {}
        for name, d in (("cuda", dev), ("cpu", "cpu")):
            step = mt.parallel.TrainStep(
                nets[name], None, mt.optimizer.LAMB(learning_rate=1e-2),
                forward_fn=fwd)
            lamb[name] = [step(toks.to(d), labels.to(d)).item()
                          for _ in range(3)]
        torch.cuda.synchronize()
        launches = dict(co.LAUNCHES)
        for kernel in ("multi_adam", "multi_lamb_phase1",
                       "multi_lamb_phase2"):
            check_opt_launches("tiny", launches, kernel, 3,
                               nets["cuda"].parameters())
        bcfg = mt.models.bert_tiny_config()
        check(bcfg.dtype == "float32", "bert_tiny_config is not float32")
        bnet = mt.models.BERTForPretrain(bcfg).initialize(
            device=dev, generator=torch.Generator(device=dev).manual_seed(5))
        bcpu = mt.convert.load_params(
            mt.models.BERTForPretrain(bcfg).initialize(device="cpu"),
            mt.convert.export_params(bnet))
        bbatch = bert_batch(bcfg, "cpu", 2, 64, 6)
        blosses = []
        before = dict(co.LAUNCHES)
        for model, d in ((bnet, dev), (bcpu, "cpu")):
            with mt.autograd.record(train_mode=False):   # dropout off
                loss = bert_loss(mt, model, *(t.to(d) for t in bbatch))
            mt.autograd.backward(loss)
            blosses.append(loss.item())
        torch.cuda.synchronize()
    for k, v in co.LAUNCHES.items():
        launches[k] += v - before[k]
    grel = max(_rel(g.grad.cpu(), p.grad) for g, p in
               zip(bnet.parameters(), bcpu.parameters()) if p.grad is not None)
    lrel = [abs(a - b) / abs(b) for a, b in zip(
        losses["cuda"] + lamb["cuda"], losses["cpu"] + lamb["cpu"])]
    print("tiny_config float32 (head_dim 16) card vs CPU: served tokens "
          "equal %s (%d requests, %d tokens); AdamW then LAMB losses card %s "
          "%s cpu %s %s, max rel diff %.2e (limit %.0e); bert_tiny_config "
          "float32 (head_dim 32): loss card %.8f cpu %.8f, max grad "
          "||d||/||cpu|| %.2e (limit %.0e); launches %s [%s]"
          % (served["cuda"] == served["cpu"], len(prompts),
             sum(map(len, served["cpu"])), losses["cuda"], lamb["cuda"],
             losses["cpu"], lamb["cpu"], max(lrel), TINY_LOSS_RTOL,
             blosses[0], blosses[1], grel, TINY_GRAD_REL,
             {k: v for k, v in launches.items() if v}, card))
    check(served["cuda"] == served["cpu"], "tiny: served tokens differ: %s "
          "vs %s" % (served["cuda"], served["cpu"]))
    check(max(lrel) <= TINY_LOSS_RTOL, "tiny: losses differ: %s %s"
          % (losses, lamb))
    check(abs(blosses[0] - blosses[1]) <= TINY_GRAD_REL * abs(blosses[1])
          and grel <= TINY_GRAD_REL, "bert tiny: card and CPU differ: "
          "losses %s, grads %.2e" % (blosses, grel))
    for name in ("flash_fwd_mma", "flash_bwd_dq_mma",
                 "flash_bwd_dkv_mma", "paged_decode_general"):
        check(launches[name] > 0, "tiny: %s did not run" % name)
    return launches


# ----------------------------------------------------------------------
# phase 14: __graft_entry__.entry() in its MXNet spelling
# ----------------------------------------------------------------------
def entry_phase(mt, co, dev, card):
    """``entry()`` as ``__graft_entry__.py:16-43`` writes it, through
    ``import mxnet_tpu_torch as mx``: seed, ``resnet50_v1()``,
    ``initialize()``, a (1, 3, 32, 32) forward of ``mx.np.ones``, every
    float32 parameter cast to bf16 through ``p.data()``, then
    ``net.forward(NDArray(x))`` at x (32, 3, 224, 224) bf16, eager and
    hybridized, against the torch-tensor path on the same weights (bit
    for bit).  Then an imperative SGD loop at B=32 with ``attach_grad``,
    ``record``, ``loss.backward()`` and ``lr_mult=0`` on one parameter,
    and ``npx.flash_attention`` on NDArrays, bf16 at head_dim 128 and
    float32 at 64, forward and ``backward()``.  Returns the launch
    counts of the phase."""
    mx = mt
    from mxnet_tpu_torch.ndarray.ndarray import NDArray
    from mxnet_tpu_torch.gluon.model_zoo import vision
    co.reset_launch_counts()
    mx.np.random.seed(0)
    net = vision.resnet50_v1()
    net.initialize()
    net(mx.np.ones((1, 3, 32, 32)))          # materialize deferred shapes
    for p in net.collect_params().values():
        d = p.data()
        if d.dtype == mx.np.float32:
            bf = d.astype("bfloat16")
            p.cast("bfloat16")
            p.set_data(bf)
    check(all(p.dtype == torch.bfloat16 for p in net.parameters()),
          "entry: a parameter is not bf16")
    x = torch.ones((RESNET_B, 3, 224, 224), dtype=torch.bfloat16, device=dev)
    rows = []
    with mx.autograd.pause():
        for mode in ("eager", "hybridized"):
            net.hybridize(mode == "hybridized")
            if mode == "eager":
                def mxnet(): return net.forward(NDArray(x))
            else:
                def mxnet(): return net(NDArray(x))
            out = mxnet()
            out = mxnet()                       # a replay when hybridized
            ref = net(x)
            check(isinstance(out, NDArray) and out.shape == (RESNET_B, 1000)
                  and bool(torch.isfinite(out._data).all()),
                  "entry %s: bad logits" % mode)
            same = torch.equal(out._data, ref)
            check(same, "entry %s: MXNet-spelling logits differ from the "
                  "torch-tensor path's" % mode)
            mx_host, _, _, _, _ = device_busy(mxnet, reps=10)
            t_host, _, _, _, _ = device_busy(lambda: net(x), reps=10)
            rows.append("%s: MXNet spelling %.0f images/s, torch tensors "
                        "%.0f images/s, logits bitwise equal %s"
                        % (mode, RESNET_B / mx_host * 1e3,
                           RESNET_B / t_host * 1e3, same))
        net.hybridize(False)
    print("entry (resnet50_v1, B=%d, 224x224, bf16): %s [%s]"
          % (RESNET_B, "; ".join(rows), card))
    # the imperative training loop
    for m in net.modules():
        if isinstance(m, mx.gluon.nn.BatchNorm):
            m.cast("float32")
    params = net.collect_params()
    frozen = "output.weight"
    params[frozen].lr_mult = 0.0
    before = {k: p.data().asnumpy() for k, p in params.items()}
    xb = mx.np.random.uniform(size=(RESNET_B, 3, 224, 224)).astype("bfloat16")
    labels = mx.np.random.randint(0, 1000, size=(RESNET_B,))
    xb.attach_grad()
    trainer = mx.gluon.Trainer(params, "sgd", {"learning_rate": 0.05,
                                               "momentum": 0.9})
    loss_fn = mx.gluon.loss.SoftmaxCELoss()
    losses = []
    co.reset_launch_counts()
    for _ in range(3):
        with mx.autograd.record():
            loss = loss_fn(net(xb).astype("float32"), labels)
        loss.backward()
        trainer.step(RESNET_B)
        losses.append(float(loss.mean()))
    check_opt_launches("entry", co.LAUNCHES, "multi_sgd", 3,
                       params.values())
    import numpy as onp
    changed = {k: not onp.array_equal(p.data().asnumpy(), before[k])
               for k, p in params.items()}
    check(not changed[frozen], "entry: the lr_mult=0 parameter changed")
    moved = sum(changed[k] for k, p in params.items()
                if p.requires_grad and k != frozen)
    check(moved == sum(p.requires_grad for p in params.values()) - 1,
          "entry: some trainable parameters did not change")
    check(all(math.isfinite(v) for v in losses) and xb.grad is not None and
          bool(torch.isfinite(xb.grad._data).all()),
          "entry: bad losses or input grad: %s" % losses)
    print("entry imperative loop (B=%d, SGD, 3 steps): losses %s; %s "
          "(lr_mult 0) unchanged, the other %d trainable parameters "
          "changed; x.grad finite, |x.grad| max %.3e"
          % (RESNET_B, losses, frozen, moved,
             float(abs(xb.grad).max())))
    del net, trainer, xb, before
    gc.collect()
    torch.cuda.empty_cache()
    # npx.flash_attention on NDArrays: both kernel routes
    for dt, D in (("bfloat16", 128), ("float32", 64)):
        q, k, v = (mx.np.random.normal(size=(2, 8, 256, D)).astype(dt)
                   for _ in range(3))
        for t in (q, k, v):
            t.attach_grad()
        with mx.autograd.record():
            o = mx.npx.flash_attention(q, k, v, causal=True)
        o.backward()
        with exact_fp32():
            zero = torch.zeros(1, dtype=torch.int32, device=dev)
            want = co._dense_with_lse(q._data, k._data, v._data, zero, zero,
                                      True, D ** -0.5)[0]
        err, rel = _rel_err(o._data, want)
        tol = GENERAL_TOL[torch.bfloat16 if dt == "bfloat16"
                          else torch.float32]
        check(rel <= tol and all(bool(torch.isfinite(t.grad._data).all())
                                 for t in (q, k, v)),
              "entry: npx.flash_attention %s disagrees: %.3e" % (dt, rel))
        print("entry npx.flash_attention %s D=%d causal: O max|d|/max|plain| "
              "%.2e (limit %.0e), grads finite" % (dt, D, rel, tol))
    torch.cuda.synchronize()
    launches = dict(co.LAUNCHES)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_fwd_mma", "flash_bwd_dq_mma",
                 "flash_bwd_dkv_mma"):
        check(launches[name] == 1, "entry: npx.flash_attention launched %s "
              "%d times, want 1" % (name, launches[name]))
    return launches


# ----------------------------------------------------------------------
# phase 15: the optimizer's multi-tensor kernels (csrc/multi_tensor.cu)
# ----------------------------------------------------------------------
# Each kernel against its plain version (ops/multi_tensor.py) on cloned
# card inputs.  float32 weights and states: max|kernel - plain| per
# tensor within OPT_REL of max|plain| -- the two differ only by FMA
# contraction and the order of a few operations.  float16 / bfloat16
# weights: every element within one step of its dtype (at the larger of
# the two values), since each is the rounding of float32 values that
# agree to OPT_REL; the share of unequal elements is printed.  LAMB's
# trust ratios within OPT_REL (the kernel sums squares in float64 per
# chunk, the plain version in float32).
OPT_REL = 1e-6
MANTISSA = {torch.float16: 10, torch.bfloat16: 7}
OPT_KERNELS = {"multi_sgd": "sgd_kernel", "multi_adam": "adam_kernel",
               "multi_lamb_phase1": "lamb1_kernel",
               "multi_lamb_phase2": "lamb2_kernel"}
OPT_REPLACES = {"multi_sgd": "mxnet_tpu/optimizer/optimizer.py:135",
                "multi_adam": "mxnet_tpu/optimizer/optimizer.py:135",
                "multi_lamb_phase1": "mxnet_tpu/ndarray/op_updates.py:268",
                "multi_lamb_phase2": "mxnet_tpu/ndarray/op_updates.py:287"}
RAGGED = [0, 1, 3, 4097, 16, 40000, 2 * 16384 + 5]
RAGGED_UNALIGNED = 4        # a view offset by one element


def opt_tables(params):
    """Launches of one list update over ``params``: ceil(tensors / TABLE)
    for each weight dtype (the optimizer's groups)."""
    from mxnet_tpu_torch.ops import multi_tensor as mtk
    counts = {}
    for p in params:
        if p.requires_grad:
            counts[p.dtype] = counts.get(p.dtype, 0) + 1
    return sum(-(-n // mtk.TABLE) for n in counts.values())


def check_opt_launches(tag, launches, kernel, steps, params):
    per = opt_tables(params)
    check(launches[kernel] == steps * per, "%s: %s launched %d times in %d "
          "steps, want %d per step (ceil(tensors / table) per dtype)"
          % (tag, kernel, launches[kernel], steps, per))
    return per


def opt_cost(per_kernel):
    """(ms, launches) per call of the optimizer kernels in a device_busy
    per-kernel dict."""
    rows = [v for k, v in per_kernel.items()
            if any(n in k for n in OPT_KERNELS.values())]
    return sum(ms for ms, _ in rows), sum(n for _, n in rows)


def _opt_groups(dev, shapes, dtypes, n_states, gen, mp=False,
                unaligned=None):
    """Groups (w, g, states..., w32 or None) on the card: N(0, 1) weights,
    N(0, 9) gradients, momentum / mean N(0, 0.01), variance U(0.1, 1.1);
    ``dtypes[i]`` = (weight dtype, grad dtype)."""
    def put(x, dtype, offset):
        if offset:
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
            buf[1:].copy_(x.reshape(-1))
            return buf[1:].view(x.shape)
        return x.to(dev, dtype)
    out = []
    for i, (shape, (wdt, gdt)) in enumerate(zip(shapes, dtypes)):
        off = i == unaligned
        w = torch.randn(shape, generator=gen)
        states = [put(torch.randn(shape, generator=gen) * 0.1,
                      torch.float32, off)]
        if n_states == 2:
            states.append(put(torch.rand(shape, generator=gen) + 0.1,
                              torch.float32, off))
        out.append((put(w, wdt, off),
                    put(torch.randn(shape, generator=gen) * 3, gdt, off),
                    *states, put(w, torch.float32, off) if mp else None))
    return out


def _clone_like(t):
    """A copy of ``t`` at the same offset from a 16-byte boundary (the
    kernels take the vector path only where every pointer is aligned,
    and the two paths may contract their FMAs differently)."""
    if t is None:
        return None
    off = t.data_ptr() % 16 // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    out = buf[off:].view(t.shape)
    out.copy_(t)
    return out


def _opt_clone(groups):
    return [tuple(_clone_like(t) for t in grp) for grp in groups]


def _opt_compare(tag, got, want):
    """Weights, states and masters of ``got`` (kernel) against ``want``
    (plain): (max |d| and max |d| / max |plain| over float32 tensors,
    the share of unequal 16-bit elements); fails past the limits."""
    err = rel = 0.0
    diff = total = 0
    for grp_k, grp_p in zip(got, want):
        for j, (a, b) in enumerate(zip(grp_k, grp_p)):
            if a is None or j == 1 or not a.numel():
                continue
            if a.dtype in MANTISSA:
                top = torch.maximum(a.float().abs(), b.float().abs())
                step = torch.exp2(torch.floor(torch.log2(
                    top.clamp(min=2.0 ** -14))) - MANTISSA[a.dtype])
                d = (a.float() - b.float()).abs()
                check(bool((d <= step).all()), "%s: a %s weight is more "
                      "than one step from plain" % (tag, a.dtype))
                diff += int((d > 0).sum())
                total += a.numel()
            else:
                e, r = _rel_err(a, b)
                err, rel = max(err, e), max(rel, r)
    check(rel <= OPT_REL, "%s: kernel vs plain %.3e of max|plain| (limit "
          "%.0e)" % (tag, rel, OPT_REL))
    return err, rel, (diff / total if total else 0.0)


def _opt_run(co, mtk, kind, groups, kw, tag):
    """The kernel on ``groups`` and on a clone (the same bits twice), the
    plain version on another clone, compared; LAMB's trust ratios too.
    Returns (max |d|, max rel, share of unequal 16-bit elements)."""
    again, plain = _opt_clone(groups), _opt_clone(groups)
    fn = {"sgd": (mtk.multi_sgd, mtk.multi_sgd_plain),
          "adam": (mtk.multi_adam, mtk.multi_adam_plain),
          "lamb": (mtk.multi_lamb, mtk.multi_lamb_plain)}[kind]
    kw = dict(kw)
    ratios = None
    if kind == "lamb":
        ratios = [torch.ones(len(groups), device=groups[0][0].device)
                  for _ in range(3)]
    names = {"sgd": ["multi_sgd"], "adam": ["multi_adam"],
             "lamb": ["multi_lamb_phase1", "multi_lamb_phase2"]}[kind]
    before = [co.LAUNCHES[n] for n in names]
    for k, (grps, f) in enumerate(((groups, fn[0]), (again, fn[0]),
                                   (plain, fn[1]))):
        if ratios is not None:
            kw["ratios"] = ratios[k]
        f(grps, **kw)
    torch.cuda.synchronize()
    check(all(co.LAUNCHES[n] > b for n, b in zip(names, before)),
          "%s: the kernel did not launch" % tag)
    same = all(torch.equal(a, b) for ga, gb in zip(groups, again)
               for a, b in zip(ga, gb) if a is not None)
    check(same, "%s: two kernel calls gave different bits" % tag)
    out = _opt_compare(tag, groups, plain)
    if ratios is not None:
        check(torch.equal(ratios[0], ratios[1]), "%s: ratios differ" % tag)
        r_rel = ((ratios[0] - ratios[2]).abs() / ratios[2].abs()).max()
        check(r_rel.item() <= OPT_REL, "%s: trust ratio %.3e from plain "
              "(limit %.0e)" % (tag, r_rel.item(), OPT_REL))
    return out


def _opt_edge_cases(co, mtk, dev):
    """Ragged lists (0, 1, 3, 4097 elements, past a chunk, an offset
    view off the vector path), float32 / bf16 / float16 under
    multi_precision, per-tensor lr / wd / t, clip on and off, rescale
    0.5; and 1500 tiny tensors, which need ceil(1500 / TABLE) launches."""
    gen = torch.Generator().manual_seed(21)
    n = len(RAGGED)
    per = dict(lrs=[0.01 * (k + 1) for k in range(n)],
               wds=[0.01 * k for k in range(n)])
    steps = [1 + 3 * k for k in range(n)]
    errs = {k: [0.0, 0.0, 0.0] for k in OPT_KERNELS}
    for wdt, gdt, mp in ((torch.float32, torch.float32, False),
                         (torch.bfloat16, torch.bfloat16, False),
                         (torch.bfloat16, torch.float32, False),
                         (torch.float16, torch.float16, True)):
        dts = [(wdt, gdt)] * n
        for clip in (None, 1.0):
            cases = [
                ("multi_sgd", "sgd", 1, dict(per, momentum=0.9,
                                             nesterov=False)),
                ("multi_sgd", "sgd", 1, dict(per, momentum=0.9,
                                             nesterov=True)),
                ("multi_sgd", "sgd", 0, dict(per)),
                ("multi_adam", "adam", 2, dict(per, steps=steps,
                                               decoupled=True)),
                ("multi_adam", "adam", 2, dict(
                    per, steps=steps, etas=[1.0 + k for k in range(n)],
                    decoupled=False)),
                ("multi_adam", "adam", 2, dict(per, decoupled=True,
                                               bias_correction=False)),
                ("multi_lamb_phase2", "lamb", 2, dict(per, steps=steps)),
                ("multi_lamb_phase2", "lamb", 2, dict(
                    per, steps=steps, lower_bound=0.5, upper_bound=4.0))]
            for name, kind, n_states, kw in cases:
                groups = _opt_groups(dev, [(x,) for x in RAGGED], dts,
                                     max(n_states, 1), gen, mp,
                                     RAGGED_UNALIGNED)
                if n_states == 0:
                    groups = [(w, g, None, w32) for w, g, _, w32 in groups]
                tag = "%s %s/%s%s clip %s %s" % (
                    name, str(wdt)[6:], str(gdt)[6:], " mp" if mp else "",
                    clip, {k: v for k, v in kw.items()
                           if k not in ("lrs", "wds", "steps", "etas")})
                e = _opt_run(co, mtk, kind, groups,
                             dict(kw, rescale=0.5, clip=clip), tag)
                keys = [name] if kind != "lamb" else ["multi_lamb_phase1",
                                                      "multi_lamb_phase2"]
                for key in keys:
                    errs[key] = [max(a, b) for a, b in zip(errs[key], e)]
    tiny = [(1 + (k * 37) % 300,) for k in range(1500)]
    for kind, name, n_states, kw in (
            ("adam", "multi_adam", 2, dict(steps=[2] * 1500,
                                           decoupled=True)),
            ("sgd", "multi_sgd", 1, dict(momentum=0.9)),
            ("lamb", "multi_lamb_phase1", 2, dict(steps=[2] * 1500))):
        groups = _opt_groups(dev, tiny, [(torch.bfloat16,) * 2] * 1500,
                             n_states, gen)
        before = co.LAUNCHES[name]
        e = _opt_run(co, mtk, kind, groups,
                     dict(kw, lrs=[1e-3] * 1500, wds=[0.01] * 1500), "%s "
                     "1500 tiny tensors" % name)
        want = -(-1500 // mtk.TABLE)
        check(co.LAUNCHES[name] - before == 2 * want, "%s: 1500 tensors "
              "took %d launches a call, want %d" % (
                  name, (co.LAUNCHES[name] - before) // 2, want))
        errs[name] = [max(a, b) for a, b in zip(errs[name], e)]
    print("optimizer kernels vs plain, edge cases (ragged %s, an offset "
          "view, float32 / bf16 / float16-mp, clip on and off, rescale 0.5, "
          "1500 tiny tensors in %d launches): %s; bitwise repeatable"
          % (RAGGED, -(-1500 // mtk.TABLE), "; ".join(
              "%s max|d| %.3e, %.3e of max|plain| (limit %.0e), 16-bit "
              "elements unequal %.4f%%" % (k, e[0], e[1], OPT_REL,
                                           100 * e[2])
              for k, e in errs.items())))
    return errs


def _opt_bytes(groups, kind, phase=None):
    """Bytes the update must move: each operand read once, each result
    written once (a master replaces the weight's read)."""
    total = 0
    for grp in groups:
        w, g, w32 = grp[0], grp[1], grp[-1]
        n, ws, gs = w.numel(), w.element_size(), g.element_size()
        wio = (8 + ws) if w32 is not None else 2 * ws   # read, write
        states = sum(8 for s in grp[2:-1] if s is not None)
        if kind == "lamb":
            wr = 4 if w32 is not None else ws
            total += n * ((wr + gs + states + 4) if phase == 1
                          else (wio + 4))
        else:
            total += n * (wio + gs + states)
    return total


def graph_ms(fn, iters=20):
    """Device ms of ``fn()`` captured once as a CUDA graph and replayed
    (:func:`time_ms`: L2 flushed before each replay, events around it):
    the kernels' own time with no host work between them; the capture
    also shows that the call records no host synchronisation.  The
    port's capture helper warms it up on the one shared side stream
    (a fresh stream per call would keep a cuBLAS workspace each)."""
    from mxnet_tpu_torch.ops import cuda_ops
    graph, _, _ = cuda_ops.capture_graph(fn, warmup=1)
    return time_ms(graph.replay, iters, warmup=1)


def opt_list_timing(co, mtk, kind, groups, kw, tag, card, library=None):
    """One list's update timed: each kernel's own device time (CUDA graph
    replay, L2 flushed: :func:`graph_ms`), the wrapper call's event time
    (host preparation included), the plain version's, and one PyTorch
    call (``library``) where there is one; the bound is the bytes over
    3.35 TB/s."""
    fn = {"sgd": (mtk.multi_sgd, mtk.multi_sgd_plain),
          "adam": (mtk.multi_adam, mtk.multi_adam_plain),
          "lamb": (mtk.multi_lamb, mtk.multi_lamb_plain)}[kind]
    if kind == "lamb":     # each phase in a graph of its own
        codes, dev, launches = mtk.lamb_launches(groups, **kw)
        own = {name: graph_ms(lambda name=name: [
            mtk._launch(name, tab, s, codes, dev) for tab, s, _ in launches])
            for name in ("multi_lamb_phase1", "multi_lamb_phase2")}
    else:
        own = {"multi_" + kind: graph_ms(lambda: fn[0](groups, **kw))}
    call_ms = time_ms(lambda: fn[0](groups, **kw))
    plain_ms = time_ms(lambda: fn[1](groups, **kw), iters=3, warmup=1)
    lib_ms = library() if library is not None else None
    n = sum(g[0].numel() for g in groups)
    out = {}
    for i, (name, ms) in enumerate(own.items()):
        nbytes = _opt_bytes(groups, kind, i + 1)
        b_ms, b_by = bound_ms(nbytes, 20 * n, FP32_FLOPS_PER_S)
        out[name] = {"shape": tag, "ms": ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                     "tensors": len(groups), "params": n}
    print("optimizer timing %s (%d tensors, %.1f M params): %s; call %.4f "
          "ms (events), plain %.4f ms%s [%s]" % (
              tag, len(groups), n / 1e6, "; ".join(
                  "%s %.4f ms (device) of bound %.4f (%.1f%%, %.2f GB)"
                  % (k, v["ms"], v["bound_ms"], 100 * v["bound_ms"] / v["ms"],
                     v["bytes"] / 1e9) for k, v in out.items()),
              call_ms, plain_ms, "" if lib_ms is None
              else ", library %.4f ms (device)" % lib_ms, card))
    return out


def _fused_adamw_ms(groups, lr, wd, beta1=0.9, beta2=0.999, eps=1e-8):
    """Device ms (:func:`graph_ms`) of ``torch._fused_adamw_`` (PyTorch's
    own fused AdamW, the same function up to rounding) on a float32
    list: the library yardstick; the port never calls it."""
    ps, gs, ms, vs = ([grp[i].clone() for grp in groups] for i in range(4))
    steps = [torch.ones((), device=ps[0].device) for _ in ps]
    try:     # the yardstick only: a torch without it leaves library_ms null
        ms_ = graph_ms(lambda: torch._fused_adamw_(
            ps, gs, ms, vs, [], steps, lr=lr, beta1=beta1, beta2=beta2,
            weight_decay=wd, eps=eps, amsgrad=False, maximize=False))
    except (AttributeError, RuntimeError, TypeError) as e:
        print("torch._fused_adamw_ not timed: %s" % e)
        return None
    return ms_


def _param_list(params, grad_dtype=None):
    """(shapes, (weight dtype, grad dtype)) of the trainable ``params``."""
    ps = [p for p in params if p.requires_grad]
    return ([tuple(p.shape) for p in ps],
            [(p.dtype, grad_dtype or p.dtype) for p in ps])


def optimizer_phase(mt, co, dev, card):
    """The four multi-tensor kernels against their plain versions at the
    edges of their design and at the main paths' parameter lists
    (BERT-base in bf16 and float32 under AdamW, ResNet-50 under SGD with
    momentum), then timed at those lists; returns their kernels-line
    records (the LM list is timed in the training phase)."""
    from mxnet_tpu_torch.ops import multi_tensor as mtk
    errs = _opt_edge_cases(co, mtk, dev)
    gen = torch.Generator().manual_seed(22)
    lists = {}
    for dt in ("bfloat16", "float32"):
        net = mt.models.BERTForPretrain(mt.models.bert_base_config(
            dtype=dt)).initialize(device=dev)
        lists["bert-base %s" % dt] = _param_list(net.parameters())
        del net
    net = _resnet50(mt, dev).cast("bfloat16")
    for m in net.modules():
        if isinstance(m, mt.gluon.nn.BatchNorm):
            m.cast("float32")
    with mt.autograd.pause():
        net(torch.zeros(1, 3, 64, 64, device=dev, dtype=torch.bfloat16))
    lists["resnet-50 bf16 + float32 BatchNorm"] = _param_list(
        net.parameters())
    del net
    gc.collect()
    torch.cuda.empty_cache()
    timing = {k: [] for k in OPT_KERNELS}
    profiled = False
    for tag, (shapes, dts) in lists.items():
        n = len(shapes)
        lrs = [2e-5 * (1 + (k % 3)) for k in range(n)]
        wds = [0.01 * (k % 2) for k in range(n)]
        runs = [("adam", 2, dict(lrs=[1.0] * n, wds=wds, etas=lrs,
                                 steps=[3] * n, decoupled=True,
                                 rescale=1.0, f32_scalars=True))]
        if tag.startswith("resnet"):
            runs = [("sgd", 1, dict(lrs=lrs, wds=wds, momentum=0.9,
                                    rescale=1 / 128))]
        if tag == "bert-base float32":
            runs.append(("lamb", 2, dict(lrs=lrs, wds=wds, steps=[3] * n,
                                         rescale=1.0, f32_scalars=True)))
        for kind, n_states, kw in runs:
            # the optimizer's groups: one call per weight dtype
            for dt in sorted({d for d, _ in dts}, key=str):
                idx = [k for k, d in enumerate(dts) if d[0] == dt]
                groups = _opt_groups(dev, [shapes[k] for k in idx],
                                     [dts[k] for k in idx], n_states, gen)
                sub = {k: ([v[i] for i in idx] if isinstance(v, list)
                           else v) for k, v in kw.items()}
                name = "%s %s list, %s weights" % (tag, kind, str(dt)[6:])
                _opt_run(co, mtk, kind, groups, sub, name)
                lib = None
                if kind == "adam" and dt == torch.float32 and \
                        tag == "bert-base float32":
                    def lib():
                        return _fused_adamw_ms(groups, 2e-5, 0.01)
                for k, rec in opt_list_timing(co, mtk, kind, groups, sub,
                                              name, card, lib).items():
                    timing[k].append(rec)
                if kind == "adam" and not profiled:
                    # whether torch.profiler sees these launches (their
                    # 22 KB parameter): the step lines' optimizer ms
                    # come from its traces
                    profiled = True
                    try:
                        ms, _ = device_ms(lambda: mtk.multi_adam(groups,
                                                                 **sub),
                                          "adam_kernel", attempts=2)
                        print("optimizer profiler check %s: multi_adam "
                              "%.4f ms by torch.profiler" % (name, ms))
                    except SmokeFailure as e:
                        print("optimizer profiler check %s: %s" % (name, e))
                del groups
                gc.collect()
                torch.cuda.empty_cache()
    records = []
    for name, recs in timing.items():
        # multi_adam's head: BERT-base float32, where a library call exists
        head = next((r for r in recs if r["library_ms"] is not None),
                    recs[0])
        records.append({"name": name, "route": "cuda",
                        "source": "mxnet_tpu_torch/csrc/multi_tensor.cu",
                        "replaces": OPT_REPLACES[name],
                        "max_abs_err": errs[name][0],
                        "max_rel_err": errs[name][1],
                        "unequal_16bit_share": errs[name][2],
                        **{k: head[k] for k in ("ms", "call_ms", "plain_ms",
                                                "bound_ms", "bound_by",
                                                "library_ms")},
                        "shapes": recs})
    return records


def lm_adamw_timing(co, net, states, dev, card):
    """The LM's AdamW update timed in place over its 2.80 B parameters
    (its weights, fresh gradients of their dtype, the TrainStep's
    float32 m and v), one record per weight dtype (the optimizer's
    groups): clones would not fit beside the model, so the kernel and
    the plain version each run on the live list."""
    from mxnet_tpu_torch.ops import multi_tensor as mtk
    gen = torch.Generator(device=dev).manual_seed(23)
    params = [(n, p) for n, p in net.collect_params().items()
              if p.requires_grad]
    recs = []
    for dt in sorted({p.dtype for _, p in params}, key=str):
        groups = [(p.detach(), torch.randn(p.shape, generator=gen,
                                           device=dev, dtype=p.dtype),
                   *states[n], None) for n, p in params if p.dtype == dt]
        n = len(groups)
        recs.append(opt_list_timing(
            co, mtk, "adam", groups, dict(lrs=[1.0] * n, wds=[0.0] * n,
                                          etas=[1e-3] * n, steps=[5] * n,
                                          decoupled=True, f32_scalars=True),
            "LM llama3_8b widths 8 layers AdamW list, %s weights"
            % str(dt)[6:], card)["multi_adam"])
        del groups
    check(all(bool(torch.isfinite(p).all()) for _, p in params),
          "LM AdamW timing: a weight is not finite")
    return recs


def _short_names(obj, width=48):
    """``obj`` with every dict key cut to ``width`` characters (the times
    of kernels whose names then coincide summed): the kernels line keeps
    the library's kernel names by their heads (the phase lines above
    print them in full), so it stays well inside the 24,000 bytes of
    output a caller may keep."""
    if isinstance(obj, list):
        return [_short_names(v, width) for v in obj]
    if not isinstance(obj, dict):
        return obj
    out = {}
    for k, v in obj.items():
        v = _short_names(v, width)
        if k[:width] in out and isinstance(v, float):
            v += out[k[:width]]
        out[k[:width]] = v
    return out


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import cuda_ops as co
    t_start = time.monotonic()
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %s x%d"
          % (torch.__version__, torch.version.cuda,
             torch.cuda.get_device_name(0), torch.cuda.device_count()))
    t0 = time.monotonic()
    _build.build_all()
    print("kernel build %.2f s (nvcc, one process per source)"
          % (time.monotonic() - t0))
    if argv[1:] == ["--kernel-timing"]:
        # only the kernels' timing, for comparing two trees in one
        # call: copy this file into the other tree's root
        print(json.dumps({"kernel_timing": {
            "tree": root, "card": card, "flash_fwd": flash_timing(co, dev),
            "flash_bwd": [bwd_timing(co, dev, card, shape)
                          for shape in (TRAIN_ATTN, BERT_ATTN)],
            "paged_decode": paged_timing(co, dev)}}))
        return 0
    check(len(argv) == 1, "usage: chip_smoke.py [--kernel-timing]")
    ptxas_report(_build)

    flash = flash_phase(co, dev)
    flash_bwd = flash_bwd_phase(co, dev, card)
    parity_phase(mt, co, dev, card)
    paged = paged_phase(co, dev)
    general = general_kernel_phase(co, dev, card)
    optim = optimizer_phase(mt, co, dev, card)
    int8 = int8_kernel_phase(co, dev, card)
    tiny_launches = tiny_fp32_phase(mt, co, dev, card)

    n_layers = 32
    net = build_model(mt, dev, n_layers)
    print("model: llama3_8b_config widths, %d layers, %.2f GB of bf16 "
          "weights" % (n_layers, sum(p.numel() for p in net.parameters())
                       * 2 / 1e9))
    srv, reqs, res, serve_launches = serve_phase(mt, co, net, dev, card)
    consistency_phase(net, reqs, res, dev)
    graph_phase(srv, reqs, res, "serve")
    step_timing(srv, reqs, res, card)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    srv, reqs, res, serve_int8_launches = serve_phase(mt, co, net, dev, card,
                                                      int8=True)
    consistency_phase(net, reqs, res, dev, srv.pool.int8)
    graph_phase(srv, reqs, res, "serve int8")
    step_timing(srv, reqs, res, card, "serve int8")
    del srv, net                  # free the serving model for training
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, lm_adamw = train_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    resnet_launches = resnet_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    bert_launches = bert_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    bert_fp32_launches = bert_fp32_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    entry_launches = entry_phase(mt, co, dev, card)

    for k in optim:
        if k["name"] == "multi_adam":
            k["shapes"] += lm_adamw
    kernels = [flash] + flash_bwd + [paged] + general + optim + int8
    paths = {"serve": serve_launches, "serve_int8": serve_int8_launches,
             "train": train_launches,
             "bert": bert_launches, "tiny_fp32": tiny_launches,
             "bert_fp32": bert_fp32_launches, "entry": entry_launches,
             "resnet": resnet_launches}
    for k in kernels:
        by_path = {path: counts[k["name"]] for path, counts in paths.items()}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    print("total %.1f s" % (time.monotonic() - t_start))
    print(card)
    print(json.dumps({"kernels": _short_names(kernels)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
