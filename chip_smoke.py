"""Chip smoke test of mxnet_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``mxnet_tpu_torch/csrc``
(printing each kernel's registers and spills, and failing where ptxas
serialised its wgmma pipeline), holds each against its plain PyTorch
version on the card, checks one training step of a small bf16 model on
the card against the CPU, serves a Llama-3-8B-width ``TransformerLM``
(random weights from a seed) through the port's ``Server`` -- its
decode, prefill and chunk programs CUDA graphs captured at start-up,
each replay held bit for bit against an eager call of the captured
function -- in bf16 and through the int8 weight path (the W8A16
``int8_linear`` kernel, held against its plain version at the decode's
shapes), checks the served tokens against a full-sequence forward (of
the dequantized model for int8), trains an 8-layer Llama-3-8B-width
model through ``TrainStep`` and the Gluon ``Trainer``, runs ResNet-50
from the Gluon zoo (inference at ``__graft_entry__.entry()``'s shape,
eager and hybridized, NCHW and NHWC, then training) and trains BERT-base
through the flash kernels at head_dim 64. The general kernels (every
dtype, head_dim and GQA ratio the Hopper ones do not take) and the
tensor-core forward and backward (float16 / bfloat16 / float32 up to
head_dim 128) are held against their plain versions and timed at BERT's
float32 shape; the float32 ``tiny_config`` and ``bert_tiny_config`` run
on the card against the CPU; BERT-base trains at its default float32;
and ``entry()`` runs in its MXNet spelling (``import mxnet_tpu_torch as
mx``). The optimizer's multi-tensor kernels (SGD / NAG, Adam / AdamW,
LAMB's two phases) are held against their plain versions at the edges of
their design and at the BERT-base, ResNet-50 and LM parameter lists, and
timed there; every training path updates through them. Then four ranks
on the one card (children of this script: ``--ring-rank R DIR``, gloo
through a ``FileStore``, started once every kernel is built) run the
ring attention at Llama-3-8B attention widths over 4*8192 tokens, flat
and two-level, striped, round-robin and non-causal, forward and
backward, against one flash call over the whole sequence (and against
plain at 4*1024), and one full-width MoE layer with its experts over
``ep=4`` against the unsharded call; the same children then train a
2-layer Llama-3-8B-width model 3 AdamW steps on ``dp=2, tp=2`` with
ZeRO-1 and on ``tp=4`` against the unsharded step (the flash kernels on
each rank's local heads, ``multi_adam`` on the shards), run
``pipeline_vjp`` over ``pp=4`` with one full-width block a stage under
1f1b and interleaved against the blocks in sequence, and drive a
``dist_sync`` kvstore (exact pushpull sums, and a Trainer with
``update_on_kvstore`` against one process on the whole batch); a
4-layer, 8-expert MoE LM of Llama-3-8B widths trains 3 steps, a float32
tiny MoE runs card against CPU, the 8-layer step with ``remat=True``
runs against the plain one, and a checkpoint resumes bit for bit.
Between the serve phases and training, the serving control plane runs
on the bf16 server (its telemetry gauges and SLO sketches, a transient
decode fault replayed bit for bit, an elastic drain, a two-replica
``ReplicaGroup`` failing over from a killed engine, the flight
recorder), and ``Server(mesh=create_mesh(tp=2))`` serves 8 requests
in bf16 and int8 on 2 gloo ranks sharing the card (``--serve-tp-rank R
DIR BACKEND WORLD`` children), its tokens held against the one-rank
server's and a teacher-forced forward. Low precision (after ``entry()``):
the all-finite, int8 quantize and int8 convolution kernels against their
plain versions bit for bit at their edges and at ResNet-50's shapes,
and timed there; int8
post-training quantization of ResNet-50 (``bench.py``'s int8 config:
B=32, one naive calibration batch) eager and as CUDA graphs beside the
float32 and bf16 nets, and entropy calibration on a batch of 8; float16
AMP training of BERT-base and ResNet-50 with dynamic loss scaling, and a
``GradGuard`` skipping an injected NaN step. Then the rest of the
vision zoo: a capture that fails (a host sync) and leaves the process
usable (an unseeded ``torch.randn``, a fresh graph replayed);
AlexNet, VGG-16-BN, SqueezeNet 1.1, MobileNet 1.0 / v2 1.0 and
DenseNet-121 at B=32 x 3 x 224^2 and Inception v3 at 299^2, bf16,
eager and hybridized, each float32 net on the card against the CPU; 3
SGD steps of MobileNet v2 and Inception v3; int8 MobileNet v2 through
``quantize_net`` (its 17 depthwise layers on K3's depthwise route, every
distinct K2 / K3 input against plain, the depthwise shapes timed on the
route and on the general kernel beside cuDNN's bf16 depthwise
convolution) and int8 MobileNet 1.0 (13 depthwise layers);
``save_parameters`` / ``load_parameters`` of ResNet-50, ``export`` ->
``SymbolBlock.imports`` of the int8 ResNet-50 (K2 and K3 launched by the
program's ``mxnet_tpu_torch::`` ops) and of the bf16 MobileNet v2, bit
for bit against their nets, and BERT-base's export refused. Each
path that runs kernels does so with the launch counts reset before it
and read after it, and fails unless every kernel it goes through was
launched.
Last, ``mx.monitor`` on BERT-base bf16 training (3 steps monitored
against the same 3 unmonitored, bit for bit; a NaN located at its
layer) and on a hybridized ResNet-50 (the capture queues nothing, the
replay is bit for bit), then the analysis gates (``verify --smoke``,
``racecheck --smoke``, ``lint`` and ``race`` against their baselines);
``python3 chip_smoke.py --analysis`` runs that phase alone.
Then the data pipeline (``--data`` alone), and the imperative surface
(``--imperative`` alone): ResNet-50 spelled in legacy ``mx.nd`` against
``net(x)`` bit for bit, ``mx.np.linalg`` / ``mx.nd.linalg`` at 4096^2
float32 held by residuals in float64, ``mx.np.fft`` round trips on the
ResNet-50 batch, ``mx.nd.image`` on 128 images against the CPU, a sparse
logistic regression at avazu-app's 1,000,000 features (``LibSVMIter``
CSR batches, a row_sparse push to a kvstore updating through
``multi_sgd``) against scipy in float64, SSD-300's MultiBox chain against
the CPU, and ``mx.nd.save`` / ``load`` of BERT-base bit for bit.
The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.  Without a CUDA device it exits non-zero at once.

A kernel's time is its own device time, summed from a torch.profiler
trace of its calls with the L2 cache flushed before each
(:func:`device_ms`), or for the optimizer's kernels the replay of a
CUDA graph of the call (:func:`graph_ms`: torch.profiler was seen to
drop a device record from their traces); the event time of the whole
wrapper call is kept beside it as ``call_ms``.  ``python3
chip_smoke.py --ring-nccl`` (4 cards) runs only the rank children's
phases with one NCCL rank a card, then the tensor-parallel server at
tp=2 and tp=4 with its collectives inside the captured graphs.
``python3 chip_smoke.py --kernel-timing`` runs only the forward,
backward and paged kernels' timing; copied into another checkout's
root, it times that tree's kernels the same way, so two trees compare
in one call.
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


def dump_json(path, obj):
    """Write ``obj`` as JSON through a temporary file and ``os.replace``,
    so a reader never sees a half-written report."""
    tmp = "%s.tmp%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


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
        # the decode: one launch a block for wq, wk, wv and one for w1,
        # w3 (they read the same input), one each for wo and w2, and the
        # head's; the prefill dequantizes each weight
        want["int8_linear"] = 4 * net.cfg.n_layers + 1
        want_pre["int8_dequant"] = 7 * net.cfg.n_layers + 1
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
    return srv, reqs, res, launches, wall


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
        ms, dev_ms, top, counts, per = device_busy(fn)
        out[name] = (ms, dev_ms)
        lin = [sum(v[i] for k, v in per.items() if "int8_linear" in k)
               for i in (0, 1)]
        print("%s %s: %.2f ms host, %.2f ms of kernels (device busy "
              "%.1f%%, host / kernels %.3f) [%s]; top kernels (ms per "
              "call): %s%s"
              % (tag, name, ms, dev_ms, 100 * dev_ms / ms, ms / dev_ms,
                 card, "; ".join("%s %.3f" % t for t in top),
                 "; int8_linear %.3f ms in %g launches" % tuple(lin)
                 if lin[1] else ""))
        ops = counts["top-level aten ops"]
        print("%s %s: per call %s; host us per top-level op %.2f"
              % (tag, name, ", ".join("%s %.1f" % kv
                                      for kv in counts.items()),
                 1e3 * ms / ops if ops else float("nan")))
    return out


# ----------------------------------------------------------------------
# phase 7: served tokens vs a full-sequence forward (teacher forced)
# ----------------------------------------------------------------------
def consistency_phase(net, reqs, res, dev, int8_layers=None, tag=None):
    """Every greedy request's served tokens against a teacher-forced full
    forward of the same sequence: at every position the served token's
    logit is within SERVED_LOGIT_TOL of the full forward's largest, and
    at least SERVED_EXACT_MIN of the positions are its argmax.  With
    ``int8_layers`` (an int8 server's ``pool.int8``) the forward is the
    dequantized model's."""
    from mxnet_tpu_torch.contrib.quantization import int8_weights
    tag = tag or ("consistency int8" if int8_layers else "consistency")
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
# the decode's int8 launches at Llama-3-8B width: (name, K, the rows of
# each weight stacked in one launch, launches per decode step of 32
# layers); wq | wk | wv and w1 | w3 read the same input
INT8_SHAPES = [("wq|wk|wv", 4096, (4096, 1024, 1024), 32),
               ("wo", 4096, (4096,), 32), ("w1|w3", 4096, (14336, 14336), 32),
               ("w2", 14336, (4096,), 32), ("output", 4096, (128256,), 1)]
# their rank-local blocks under tensor parallelism (wq, wk, wv, w1, w3
# split by rows, wo and w2 by columns), held against plain: (name, K,
# rows)
INT8_TP_SHAPES = [("tp%d %s" % (tp, name), K // (tp if by_k else 1),
                   tuple(n // (1 if by_k else tp) for n in rows))
                  for tp in (2, 4)
                  for name, K, rows, _ in INT8_SHAPES[:4]
                  for by_k in [name in ("wo", "w2")]]
# distinct weights a back-to-back timing reads: past the 50 MB L2
CHAIN_BYTES = 100 * 2 ** 20


def int8_kernel_phase(co, dev, card):
    """The int8 weight path's two kernels against their plain versions at
    the decode's launches (INT8_SHAPES: wq | wk | wv and w1 | w3 stacked,
    each weight with its own scale), their tp=2 / tp=4 blocks and an odd
    K and N, in bf16 and float32, each twice (same bits):
    ``int8_linear_group`` (each weight's ``F.linear`` of its dequantized
    weight; at M = 1, 8 and 17 rows, limit INT8_TOL of that weight's
    max|plain|) and ``int8_dequant`` (``q * scale``, bit for bit).  Then,
    in bf16, each launch's own device time (:func:`graph_ms`, a CUDA
    graph of the call replayed: torch.profiler dropped device records
    from traces of these kernels) and back to back over distinct weights
    (:func:`chain_ms`) beside its bound (bytes over 3.35 TB/s) and the
    plain version's event time, and each weight's dequantize as the
    prefill runs it.  Library: for ``int8_linear`` (M = 8) the
    dequantize + ``torch.matmul`` (no single PyTorch call computes it:
    the two calls, replayed as one graph), with a bf16 weight's product
    at the same shape (cuBLAS) for the record; for ``int8_dequant`` the
    one PyTorch call ``q * scale``.  Returns their kernels-line
    records."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.int8 import (dequantize, dequantize_plain,
                                          int8_linear_group,
                                          int8_linear_group_plain,
                                          int8_linear_plan)
    gen = torch.Generator(device=dev).manual_seed(40)
    scale = 8e-4                   # N(0, 0.02) weights: max ~0.1 / 127
    errs, shapes, deq_shapes = {}, [], []
    for name, K, rows, per_step in INT8_SHAPES + [
            (n, K, r, 0) for n, K, r in INT8_TP_SHAPES] + [
            ("odd K, N", 4099, (1001,), 0)]:
        N = sum(rows)
        scales = [scale * (1 + 0.25 * i) for i in range(len(rows))]
        q = torch.randint(-127, 128, (N, K), generator=gen, device=dev,
                          dtype=torch.int8)
        for dt in INT8_TOL:
            check(torch.equal(dequantize(q, scale, dt),
                              dequantize_plain(q, scale, dt)),
                  "int8_dequant %s %s differs from plain" % (name, dt))
            for M in (1, 8, 17):
                x = torch.randn(M, K, generator=gen, device=dev).to(dt)
                got = int8_linear_group(x, q, rows, scales)
                want = int8_linear_group_plain(x, q, rows, scales)
                for i, (y, w) in enumerate(zip(got, want)):
                    err = (y.float() - w.float()).abs().max().item()
                    ref = w.float().abs().max().item()
                    check(err <= INT8_TOL[dt] * ref, "int8_linear %s "
                          "(weight %d) M=%d %s: max|d| %.3e over %.0e * "
                          "max|plain| %.3e"
                          % (name, i, M, dt, err, INT8_TOL[dt], ref))
                    old = errs.get(dt, (0.0, 0.0))
                    errs[dt] = (max(old[0], err), max(old[1], err / ref))
                again = int8_linear_group(x, q, rows, scales)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      "int8_linear %s M=%d %s: two calls differ"
                      % (name, M, dt))
        if per_step:
            bf16 = torch.bfloat16
            x = torch.randn(8, K, generator=gen, device=dev).to(bf16)

            def run(w, x=x, rows=rows, scales=scales):
                return int8_linear_group(x, w, rows, scales)
            ms = graph_ms(lambda: run(q))
            n_chain = max(2, -(-CHAIN_BYTES // (N * K)))
            qs = [q] + [torch.randint(-127, 128, (N, K), generator=gen,
                                      device=dev, dtype=torch.int8)
                        for _ in range(n_chain - 1)]
            chain = chain_ms([lambda w=w: run(w) for w in qs])
            del qs
            call_ms = time_ms(lambda: run(q))
            plain_ms = time_ms(lambda: int8_linear_group_plain(
                x, q, rows, scales), iters=5)
            # the plain dequantize's product, each row's scale made once
            # (a host-to-device copy cannot be captured)
            st = torch.cat([torch.full((r, 1), s, dtype=bf16, device=dev)
                            for r, s in zip(rows, scales)])
            lib_ms = graph_ms(lambda: torch.matmul(x, (q * st).t()))
            w16 = q * st
            bf16_ms = graph_ms(lambda: F.linear(x, w16))
            del w16
            b_ms, b_by = bound_ms(N * K + 2 * 8 * K + 2 * 8 * N,
                                  2 * 8 * N * K)
            print("int8_linear %s (M=8, K=%d, rows %s, bf16): kernel %.4f "
                  "ms (device; %.4f ms a launch back to back over %d "
                  "distinct weights, %.1f%% of the bound), call %.4f ms, "
                  "plain %.4f ms, bound %.4f ms (%s), %.1f%% of it; library "
                  "(dequantize + matmul) %.4f ms; a bf16 weight's product "
                  "%.4f ms; plan %s [%s]"
                  % (name, K, rows, ms, chain, n_chain, 100 * b_ms / chain,
                     call_ms, plain_ms, b_ms, b_by, 100 * b_ms / ms, lib_ms,
                     bf16_ms, int8_linear_plan(8, N, K), card))
            shapes.append({"shape": name, "M": 8, "K": K, "N": N,
                           "rows": rows, "per_decode_step": per_step,
                           "ms": ms, "chain_ms": chain,
                           "call_ms": call_ms, "plain_ms": plain_ms,
                           "bound_ms": b_ms, "bound_by": b_by,
                           "library_ms": lib_ms, "bf16_weight_ms": bf16_ms})
            # the prefill dequantizes each weight on its own
            s0 = torch.tensor(scale, dtype=bf16, device=dev)
            r0 = 0
            for wname, r in zip(name.split("|"), rows):
                qw = q[r0:r0 + r]
                r0 += r
                d_ms = graph_ms(lambda: dequantize(qw, scale, bf16))
                d_call = time_ms(lambda: dequantize(qw, scale, bf16))
                d_plain = time_ms(lambda: dequantize_plain(qw, scale, bf16))
                d_lib = graph_ms(lambda: qw * s0)
                d_bound, d_by = bound_ms(3 * r * K, r * K)
                print("int8_dequant %s (%d x %d, bf16): kernel %.4f ms "
                      "(device), call %.4f ms, plain %.4f ms, bound %.4f ms "
                      "(%s), %.1f%% of it; library (q * scale) %.4f ms [%s]"
                      % (wname, r, K, d_ms, d_call, d_plain, d_bound, d_by,
                         100 * d_bound / d_ms, d_lib, card))
                deq_shapes.append({"shape": wname, "N": r, "K": K,
                                   "per_prefill": per_step, "ms": d_ms,
                                   "call_ms": d_call, "plain_ms": d_plain,
                                   "bound_ms": d_bound, "bound_by": d_by,
                                   "library_ms": d_lib})
        del q
        torch.cuda.empty_cache()
    step = {k: sum(sh[k] * sh["per_decode_step"] for sh in shapes)
            for k in ("ms", "chain_ms", "bound_ms", "library_ms",
                      "bf16_weight_ms")}
    pre = {k: sum(sh[k] * sh["per_prefill"] for sh in deq_shapes)
           for k in ("ms", "bound_ms", "library_ms")}
    print("int8_linear: max|d| / max|plain| %s (limits %s) at the decode "
          "launches, their tp=2 / tp=4 blocks and an odd K, N; a decode "
          "step's %d launches %.3f ms of kernel (%.3f back to back), "
          "bound %.3f ms, library %.3f ms, bf16 weights %.3f ms; "
          "int8_dequant bit for bit, a prefill's %d %.3f ms, bound %.3f "
          "ms, library %.3f ms [%s]"
          % ({str(k)[6:]: "%.2e" % v[1] for k, v in errs.items()},
             {str(k)[6:]: v for k, v in INT8_TOL.items()},
             sum(sh["per_decode_step"] for sh in shapes), step["ms"],
             step["chain_ms"], step["bound_ms"], step["library_ms"],
             step["bf16_weight_ms"],
             sum(sh["per_prefill"] for sh in deq_shapes), pre["ms"],
             pre["bound_ms"], pre["library_ms"], card))
    # the records' own numbers: w1 | w3, the largest launch, and w1
    head = next(sh for sh in shapes if sh["shape"] == "w1|w3")
    dhead = next(sh for sh in deq_shapes if sh["shape"] == "w1")
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
    return launches, lm, lm_finite_timing(net, dev, card)


def lm_finite_timing(net, dev, card):
    """K1 over the LM's gradient list: fresh gradients of every
    trainable parameter's shape and dtype (the TrainStep's)."""
    from mxnet_tpu_torch.ops import multi_tensor as mtk
    gen = torch.Generator(device=dev).manual_seed(24)
    grads = [torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype)
             for p in net.parameters() if p.requires_grad]
    rec = finite_list_timing(mtk, grads, "LM llama3_8b widths 8 layers "
                             "grads", card)
    del grads
    torch.cuda.empty_cache()
    return rec


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
    """||a - b|| / ||b||, in float32 (float64 for float64 inputs)."""
    dt = torch.float64 if torch.float64 in (a.dtype, b.dtype) else \
        torch.float32
    return ((a.to(dt) - b.to(dt)).norm() / b.to(dt).norm()).item()


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
# phase 14b: low precision -- the all-finite, quantize and int8
# convolution kernels (slice 14)
# ----------------------------------------------------------------------
# The H100 SXM's dense int8 tensor-core peak (NVIDIA data sheet; only
# wgmma reaches it, the kernel's mma.sync issues below it).
INT8_OPS_PER_S = 1979e12
# (name, N, C, H, W, O, kernel, stride, pad): five ResNet-50 shapes at
# B=32, the last the 1000-way Dense as a 1 x 1 convolution of (32, 2048)
INT8_CONV_TIMED = [("stem 7x7/2 3->64 224^2", 32, 3, 224, 224, 64, 7, 2, 3),
                   ("1x1 256->64 56^2", 32, 256, 56, 56, 64, 1, 1, 0),
                   ("3x3 64->64 56^2", 32, 64, 56, 56, 64, 3, 1, 1),
                   ("3x3 512->512 7^2", 32, 512, 7, 7, 512, 3, 1, 1),
                   ("dense 2048->1000", 32, 2048, 1, 1, 1000, 1, 1, 0)]
# (N, C, H, W, O, kernel, stride, pad, dilation, groups): the edges
INT8_CONV_EDGES = [(2, 3, 31, 29, 64, 7, 2, 3, 1, 1),     # stem, C = 3
                   (1, 37, 13, 11, 45, 3, 2, 0, 2, 1),    # odd C, O; batch 1
                   (3, 24, 9, 9, 40, 3, 1, 1, 1, 2),      # groups 2
                   (2, 32, 9, 9, 32, 3, 2, 1, 1, 32),     # depthwise
                   # depthwise: C % 4 and C % 16 != 0 (4-byte loads),
                   # multiplier 2, 5 x 5, dilation 2, a ragged channel
                   # block
                   (2, 7, 9, 9, 7, 3, 1, 1, 1, 7),
                   (1, 6, 13, 11, 12, 3, 2, 0, 1, 6),
                   (1, 40, 17, 15, 40, 5, 1, 2, 1, 40),
                   (2, 20, 16, 16, 40, 3, 1, 2, 2, 20),
                   (1, 64, 8, 40, 64, 5, 2, 2, 1, 64),
                   (2, 100, 10, 10, 70, 1, 1, 0, 1, 1),   # K not 16 / 32
                   # C a multiple of 32 (the hopper route of 52 of
                   # ResNet-50's 53 convolutions) with 3x3 taps, padding,
                   # an image boundary inside a 128-row tile, M and O not
                   # multiples of the tile, a split depth (2, 4 and 8
                   # CTAs) and 7^2 rows that cross images; then stride and
                   # dilation; C = 96 (taps straddle the 128-byte stages)
                   (2, 64, 12, 10, 64, 3, 1, 1, 1, 1),
                   (2, 128, 11, 13, 96, 3, 2, 2, 2, 1),
                   (2, 512, 7, 7, 512, 3, 1, 1, 1, 1),
                   (3, 96, 9, 7, 70, 3, 2, 1, 1, 1),
                   # the Dense: M = 4, 1, 17 (operands swapped, 32 rows)
                   # and 33 (64 rows), depth split 8 ways
                   (4, 2048, 1, 1, 1000, 1, 1, 0, 1, 1),
                   (1, 2048, 1, 1, 1000, 1, 1, 0, 1, 1),
                   (17, 2048, 1, 1, 1000, 1, 1, 0, 1, 1),
                   (33, 2048, 1, 1, 1000, 1, 1, 0, 1, 1)]
INT8_RESNET_B, INT8_ENTROPY_B = 32, 8
# the int8 ResNet-50's logits against the float32 net's on a second
# batch: ||int8 - fp32|| / ||fp32|| (the reference's own quantize_net
# test holds its small CNN to 0.25 of max|logit|)
INT8_RESNET_REL = 0.25
AMP_BERT_STEPS, AMP_RESNET_B, AMP_RESNET_STEPS = 6, 128, 3
AMP_RESNET_TRIES = 20    # 2^16 halves to its floor of 1 in 16 overflows
# the float16 AMP BERT-base against the float32 model on the same batch
# and weights, dropout off.  With random weights the MLM + NSP loss sits
# near ln(30522) + ln(2) whatever the forward computes, so the loss is
# held tightly (its first reading on the H100 was 2.1e-5 relative) and
# the MLM logits of two sequences are held as well: ||d|| / ||fp32||,
# where float16's rounding (2^-11 an operation, 12 layers) gives about
# 1e-3, and a layer whose residual branch is lost or wrong moves it by
# that branch's share of the hidden state, about 0.3 at this init
AMP_LOSS_RTOL = 1e-3
AMP_LOGIT_REL = 1e-2


def _int8_conv_inputs(i8, dev, gen, N, C, H, W, O, k, g, dtype):
    x = torch.randn(N, C, H, W, generator=gen, device=dev).to(dtype)
    wq = torch.randint(-127, 128, (O, C // g, k, k), generator=gen,
                       device=dev, dtype=torch.int8)
    return x, i8.pack_conv_weight(wq, g), wq


def finite_list_timing(mtk, grads, tag, card):
    """K1 over one gradient list: held against its plain version (clean,
    then with the last element NaN), then timed: own device ms (a CUDA
    graph of one launch), the wrapper call, the plain version, and
    ``torch._amp_foreach_non_finite_check_and_unscale_`` at inverse scale
    1 (the library's check, which also multiplies every gradient by the
    scale and writes it back); the bound is the gradients' bytes over
    3.35 TB/s."""
    dev = grads[0].device
    check(mtk.multi_all_finite(grads).item() ==
          mtk.multi_all_finite_plain(grads).item() == 1.0,
          "multi_all_finite %s: a clean list is not finite" % tag)
    last = grads[-1].view(-1)
    keep = last[-1].clone()
    last[-1] = float("nan")
    check(mtk.multi_all_finite(grads).item() ==
          mtk.multi_all_finite_plain(grads).item() == 0.0,
          "multi_all_finite %s: a NaN went unseen" % tag)
    last[-1] = keep
    flag = torch.ones(1, device=dev)
    ms = graph_ms(lambda: mtk.multi_all_finite(grads, flag))
    call_ms = time_ms(lambda: mtk.multi_all_finite(grads, flag))
    plain_ms = time_ms(lambda: mtk.multi_all_finite_plain(grads), iters=3,
                       warmup=1)
    found, inv = torch.zeros(1, device=dev), torch.ones(1, device=dev)
    try:
        lib_ms = graph_ms(
            lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                grads, found, inv))
    except (AttributeError, RuntimeError, TypeError) as e:
        print("torch._amp_foreach_non_finite_check_and_unscale_ not timed: "
              "%s" % e)
        lib_ms = None
    nbytes = sum(g.numel() * g.element_size() for g in grads)
    b_ms, b_by = bound_ms(nbytes, sum(g.numel() for g in grads),
                          FP32_FLOPS_PER_S)
    launches = -(-len(grads) // mtk.TABLE)
    print("multi_all_finite %s (%d tensors, %.1f M elements, %.3f GB, %d "
          "launch): kernel %.4f ms (device), call %.4f ms, plain %.4f ms, "
          "bound %.4f ms (%s), %.1f%% of it; library "
          "(_amp_foreach_non_finite_check_and_unscale_, writes the grads "
          "back) %s ms [%s]"
          % (tag, len(grads), sum(g.numel() for g in grads) / 1e6,
             nbytes / 1e9, launches, ms, call_ms, plain_ms, b_ms, b_by,
             100 * b_ms / ms, "none" if lib_ms is None else "%.4f" % lib_ms,
             card))
    return {"shape": tag, "tensors": len(grads), "bytes": nbytes, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


# K2's tiled design's edges: (shape, groups) -- P = 49 and P % 4 != 0,
# channels past the tile (200 = a 128-byte line and 72 bytes; 37 -> 40),
# the stem's 3, groups, Dense inputs, whole 64- and 16-byte rows
K2_EDGES = [((2, 512, 7, 7), 1), ((3, 64, 5, 7), 1), ((1, 200, 9, 11), 1),
            ((2, 37, 6, 6), 1), ((2, 3, 17, 19), 1), ((1, 12, 5, 7), 3),
            ((2, 64, 14, 14), 2), ((5, 37), 1), ((32, 2048), 1),
            ((2, 256, 28, 28), 1), ((1, 16, 33, 3), 1)]
# the im2col mode: (N, C, H, W, kernel, stride, pad, dilation)
K2_IM2COL_EDGES = [(2, 3, 224, 224, 7, 2, 3, 1), (1, 3, 17, 19, 3, 1, 3, 2),
                   (2, 12, 9, 7, 3, 2, 1, 1), (3, 4, 8, 8, 1, 1, 0, 1),
                   (1, 20, 12, 12, 10, 1, 4, 1)]


def _quant_edges(dev, scale):
    """float32 values where K2's rounding is at stake for ``scale``: the
    halves k + .5 of it and their neighbours, +-127.5 of it, zeros,
    denormals, huge values, inf and NaN, then quotients spread over the
    int8 range."""
    s = torch.tensor(scale, dtype=torch.float32, device=dev)
    k = torch.arange(-130, 130, device=dev, dtype=torch.float32) + 0.5
    halves = torch.cat([k * s, torch.tensor([127.5, -127.5],
                                            device=dev) * s])
    up, down = (torch.nextafter(halves, torch.full_like(halves, v))
                for v in (float("inf"), float("-inf")))
    special = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1e-40, -3e-39, 3e38,
                            -3e38, float("inf"), float("-inf"),
                            float("nan")], device=dev)
    spread = torch.linspace(-140, 140, 4093, device=dev) * s
    return torch.cat([halves, up, down, special, spread])


def k2_edge_checks(i8, dev, gen):
    """K2 (both modes) against its plain version, bit for bit, at the
    edges of the tiled design and of the quotient's fast path; the number
    of cases."""
    n = 0
    for dt in (torch.float16, torch.bfloat16, torch.float32, torch.int8):
        for shape, g in K2_EDGES:
            numel = math.prod(shape)
            if dt == torch.int8:
                flat = torch.randint(-128, 128, (numel + 1,), generator=gen,
                                     device=dev, dtype=dt)
                flat[:8] = -128
                scales = (1.0,)
            else:
                flat = (torch.randn(numel + 1, generator=gen, device=dev)
                        * 3).to(dt)
                scales = (0.0123, 0.5)
            # aligned, then one element in: no vector loads
            for x in (flat[:numel].view(shape), flat[1:].view(shape)):
                for s in scales:
                    check(torch.equal(i8.int8_quantize(x, s, g),
                                      i8.int8_quantize_plain(x, s, g)),
                          "int8_quantize %s %s g=%d scale %g (offset %d) "
                          "differs from plain"
                          % (dt, shape, g, s, x.storage_offset()))
                    n += 1
        for (N, C, H, W, k, st, p, d) in K2_IM2COL_EDGES:
            if dt == torch.int8:
                x = torch.randint(-128, 128, (N, C, H, W), generator=gen,
                                  device=dev, dtype=dt)
                s = 1.0
            else:
                x = (torch.randn(N, C, H, W, generator=gen, device=dev)
                     * 3).to(dt)
                s = 0.0123
            geo = ((k, k), (st, st), (p, p), (d, d))
            check(torch.equal(i8.int8_quantize_im2col(x, s, *geo),
                              i8.int8_quantize_im2col_plain(x, s, *geo)),
                  "int8_quantize im2col %s %s differs from plain"
                  % (dt, (N, C, H, W, k, st, p, d)))
            n += 1
    for scale in (0.0123, 0.5, 1 / 3, 1e-30, 1e-39, 3e38):
        v = _quant_edges(dev, scale)
        m = v.numel() // 64 * 64
        for x in (v[:m].reshape(2, 32, m // 64),
                  v[:m].reshape(2, 16, 2, -1)):
            check(torch.equal(i8.int8_quantize(x, scale),
                              i8.int8_quantize_plain(x, scale)),
                  "int8_quantize: edge values at scale %g differ from "
                  "plain" % scale)
            n += 1
        x = v[:m].reshape(1, 2, 8, m // 16)
        geo = ((3, 3), (1, 1), (1, 1), (1, 1))
        check(torch.equal(i8.int8_quantize_im2col(x, scale, *geo),
                          i8.int8_quantize_im2col_plain(x, scale, *geo)),
              "int8_quantize im2col: edge values at scale %g differ from "
              "plain" % scale)
        n += 1
    return n


def low_precision_kernel_phase(co, dev, card):
    """K1 ``multi_all_finite``, K2 ``int8_quantize`` and K3 ``int8_conv``
    against their plain versions, bit for bit, at the edges of their
    design; then K2 and K3, again held against their plain versions
    (K3 in both epilogues), timed at ResNet-50's shapes (B=32): own device
    ms (a CUDA graph of the call, L2 flushed), bound, plain, cuDNN's bf16
    channels-last convolution of the same shape (``bf16_ms``) and, for
    the Dense, ``torch._int_mm`` (``library_ms``).  K1's timing comes
    from the gradient lists of the training and AMP phases.  Returns the
    kernels-line records: K1, K2 (NHWC, im2col), K3 on each route (K1's,
    K2's and K3 depthwise's shapes filled in later)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import int8 as i8
    from mxnet_tpu_torch.ops import multi_tensor as mtk
    gen = torch.Generator(device=dev).manual_seed(60)
    # K1: mixed dtypes, every bad value in every position, > 256 tensors
    kinds = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
    ts = [torch.randn(n, generator=gen, device=dev).to(kinds[i % 4])
          for i, n in enumerate((1, 7, 16384 + 3, 40000, 8, 33))]
    ts.append(torch.randn(9, device=dev)[1:])          # unaligned
    for bad in (float("inf"), float("-inf"), float("nan")):
        for j in range(len(ts)):
            u = [t.clone() for t in ts]
            u[j].view(-1)[j % u[j].numel()] = bad
            check(mtk.multi_all_finite(u).item() ==
                  mtk.multi_all_finite_plain(u).item() == 0.0,
                  "multi_all_finite: %s in tensor %d unseen" % (bad, j))
    many = [torch.ones(5, device=dev) for _ in range(600)]
    many[599][4] = float("nan")
    check(mtk.multi_all_finite(many).item() == 0.0 and
          mtk.multi_all_finite(many[:599]).item() == 1.0,
          "multi_all_finite: 600 tensors (3 launches) misjudged")
    print("multi_all_finite vs plain: inf / -inf / NaN in every tensor of a "
          "float16 / bfloat16 / float32 / float64 list (one launch), 600 "
          "tensors (3 launches): equal")
    # K2: every input dtype, .5 ties, C = 3, groups, a Dense input
    n2 = 0
    for dt in (torch.float16, torch.bfloat16, torch.float32, torch.int8):
        for shape, g in (((2, 3, 31, 29), 1), ((1, 12, 5, 7), 3),
                         ((5, 37), 1), ((32, 2048), 1), ((2, 64, 14, 14), 2)):
            if dt == torch.int8:
                x = torch.randint(-128, 128, shape, generator=gen,
                                  device=dev, dtype=dt)
                scales = (1.0,)
            else:
                x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dt)
                x.view(-1)[:8] = ((torch.arange(8, device=dev) + 0.5)
                                  * 0.5).to(dt)
                scales = (0.0123, 0.5, 1 / 3)
            for s in scales:
                check(torch.equal(i8.int8_quantize(x, s, g),
                                  i8.int8_quantize_plain(x, s, g)),
                      "int8_quantize %s %s g=%d scale %g differs from plain"
                      % (dt, shape, g, s))
                n2 += 1
    print("int8_quantize vs plain: %d cases (float16 / bfloat16 / float32 / "
          "int8, .5 ties, C=3, groups 2 and 3, Dense inputs) bit for bit"
          % n2)
    n2 = k2_edge_checks(i8, dev, gen)
    print("int8_quantize vs plain, tiles and im2col: %d cases (each tile "
          "width and the row kernel at P = 49, P %% 4 != 0, channels past "
          "the tile, "
          "groups, aligned and unaligned x, int8 -128 kept; the values "
          "where the quotient's rounding decides: halves of the scale and "
          "their neighbours, +-127.5 of it, denormals, inf, NaN, scales "
          "whose reciprocal is not normal; the im2col mode at the stem, "
          "dilation, odd padding, 12 channels and a 1 x 1) bit for bit"
          % n2)
    # K3: the edges, both epilogues, three output dtypes, on each route
    # that takes the shape (hopper or depthwise where int8_conv_route
    # gives it, and the general kernel)
    n3 = {"hopper": 0, "general": 0, "depthwise": 0}
    for (N, C, H, W, O, k, s, p, d, g) in INT8_CONV_EDGES:
        for dt in (torch.float16, torch.bfloat16, torch.float32):
            x, wpk, _ = _int8_conv_inputs(i8, dev, gen, N, C, H, W, O, k, g,
                                          dt)
            xq = i8.int8_quantize(x, 0.02, g)
            scale = torch.rand(O, generator=gen, device=dev) * 1e-3
            bias = torch.randn(O, generator=gen, device=dev)
            bi = torch.randint(-999, 999, (O,), generator=gen, device=dev,
                               dtype=torch.int32)
            geo = ((k, k), (s, s), (p, p), (d, d), g)
            own = i8.int8_conv_route(*xq.shape[:3], i8.group_bytes(C, g), g)
            routes = dict.fromkeys((own, "general"))
            for kw in (dict(out_dtype=torch.int32, bias_i32=bi),
                       dict(out_dtype=torch.int32, channels_last=True),
                       dict(scale=scale, bias=bias, relu=True, out_dtype=dt),
                       dict(scale=scale, bias=bias, out_dtype=dt),
                       dict(scale=scale, out_dtype=dt, channels_last=True)):
                want = i8.int8_conv_plain(xq, wpk, *geo, **kw)
                for route in routes:
                    got = i8._int8_conv(xq, wpk, *geo, route=route, **kw)
                    check(torch.equal(got, want), "int8_conv %s %s %s "
                          "differs from plain: %d elements"
                          % (route, (N, C, H, W, O, k, s, p, d, g),
                             sorted(kw), int((got != want).sum())))
                    n3[route] += 1
    print("int8_conv vs plain: %d cases on the hopper route, %d on the "
          "depthwise, %d on the general (C=3 7x7 stem, odd C and O, stride "
          "2, dilation 2, padding 0/1/2/3, groups 2, depthwise with C = 6 / "
          "7 / 20 / 32 / 40 / 64, multiplier 2, 5x5, batch 1, 3x3 with C a "
          "multiple of 32, image boundaries inside tiles, depth split 2 / "
          "4 / 8 ways, the Dense at M = 1, 4, 17, 33; raw int32 with and "
          "without bias, NCHW and NHWC, float with bias +- relu, "
          "float16 / bfloat16 / float32) bit for bit"
          % (n3["hopper"], n3["depthwise"], n3["general"]))
    # timing at ResNet-50's shapes, each on its route and on the general
    # kernel (the earlier design on the hopper shapes); K2's
    # rows come from the int8 forward's own inputs (int8_resnet_phase)
    c_rows = []
    for name, N, C, H, W, O, k, s, p in INT8_CONV_TIMED:
        x, wpk, wq = _int8_conv_inputs(i8, dev, gen, N, C, H, W, O, k, 1,
                                       torch.float32)
        if k == 1 and H == 1:
            x = x.reshape(N, C)
        scale = torch.full((O,), 1e-4, device=dev)
        bias = torch.zeros(O, device=dev)
        xq = i8.int8_quantize(x, 0.02)
        xq4 = xq.reshape(N, H, W, -1)
        geo = ((k, k), (s, s), (p, p))
        route = i8.int8_conv_route(N, H, W, xq4.shape[3], 1)
        routes = (route, "general") if route == "hopper" else (route,)
        # held against the plain version at this shape first: K2, then K3
        # in both epilogues and the three float dtypes (random scales and
        # biases) on each route
        check(torch.equal(xq, i8.int8_quantize_plain(x, 0.02)),
              "int8_quantize %s (B=%d) differs from plain" % (name, N))
        rs = torch.rand(O, generator=gen, device=dev) * 1e-3
        rb = torch.randn(O, generator=gen, device=dev)
        bi = torch.randint(-999, 999, (O,), generator=gen, device=dev,
                           dtype=torch.int32)
        for kw in (dict(out_dtype=torch.int32, bias_i32=bi),
                   dict(scale=rs, bias=rb, relu=True),
                   dict(scale=rs, bias=rb, out_dtype=torch.float16),
                   dict(scale=rs, out_dtype=torch.bfloat16,
                        channels_last=True)):
            want = i8.int8_conv_plain(xq4, wpk, *geo, **kw)
            for r in routes:
                got = i8._int8_conv(xq4, wpk, *geo, route=r, **kw)
                check(torch.equal(got, want), "int8_conv %s %s (B=%d) %s "
                      "differs from plain: %d elements"
                      % (r, name, N, sorted(kw), int((got != want).sum())))
                del got
            del want
        OH = (H + 2 * p - k) // s + 1
        OW = (W + 2 * p - k) // s + 1
        macs = N * OH * OW * O * C * k * k
        ms = {r: graph_ms(lambda r=r: i8._int8_conv(
            xq4, wpk, *geo, scale=scale, bias=bias, route=r))
            for r in routes}
        call_ms = time_ms(lambda: i8.int8_conv(xq4, wpk, *geo, scale=scale,
                                               bias=bias))
        plain_ms = time_ms(lambda: i8.int8_conv_plain(
            xq4, wpk, *geo, scale=scale, bias=bias), iters=3, warmup=1)
        nbytes = xq4.numel() + wpk.numel() + 4 * N * O * OH * OW + 8 * O
        b_ms, b_by = bound_ms(nbytes, 2 * macs, INT8_OPS_PER_S)
        xb = x.to(torch.bfloat16)
        wb = wq.to(torch.bfloat16)
        if x.dim() == 4:
            xb = xb.contiguous(memory_format=torch.channels_last)
            wb = wb.contiguous(memory_format=torch.channels_last)
            bf16_ms = graph_ms(lambda: F.conv2d(xb, wb, None, s, p))
            lib_ms = None
        else:
            wb = wb.reshape(O, C)
            bf16_ms = graph_ms(lambda: F.linear(xb, wb))
            xi, wi = xq[:, :C].contiguous(), wq.reshape(O, C).t()
            try:    # the yardstick only
                lib_ms = graph_ms(lambda: torch._int_mm(xi, wi))
            except (AttributeError, RuntimeError) as e:
                print("torch._int_mm not timed: %s" % e)
                lib_ms = None
        plan = (i8.int8_conv_plan(N * OH * OW, O, wpk.shape[2])
                if route == "hopper" else None)
        print("int8_conv %s (B=%d): %s route kernel %.4f ms (device)%s, "
              "call %.4f ms, plain %.4f ms, bound %.4f ms (%s: %.2f GMAC, "
              "int8 peak 1979 TOP/s), %.1f%% of it, %.1f TOP/s; cuDNN bf16 "
              "%s %.4f ms%s; plan %s [%s]"
              % (name, N, route, ms[route], "" if route == "general" else
                 ", general kernel %.4f ms" % ms["general"], call_ms,
                 plain_ms, b_ms, b_by, macs / 1e9, 100 * b_ms / ms[route],
                 2 * macs / ms[route] / 1e9,
                 "channels-last conv" if x.dim() == 4 else "linear",
                 bf16_ms, "" if lib_ms is None
                 else "; torch._int_mm %.4f ms" % lib_ms, plan, card))
        c_rows.append({"shape": name, "route": route, "ms": ms[route],
                       "general_ms": ms["general"], "call_ms": call_ms,
                       "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "library_ms": lib_ms,
                       "bf16_ms": bf16_ms, "macs": macs, "plan": plan})
        if name.startswith("stem"):
            stem = stem_routes(i8, x, wpk, wq, geo, scale, bias, ms, card)
        del x, wpk, wq, xq, xq4, xb, wb
        torch.cuda.empty_cache()
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    hopper = [r for r in c_rows if r["route"] == "hopper"]
    general = [dict(r, route="general", ms=r["general_ms"],
                    call_ms=r["call_ms"] if r["route"] == "general" else None)
               for r in c_rows]
    head = hopper[1]                            # 3x3 64->64 at 56^2
    hopper.insert(0, stem["hopper_row"])
    return [{"name": "multi_all_finite", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/multi_tensor.cu",
             "replaces": "mxnet_tpu/ndarray/op_updates.py:631",
             "max_abs_err": 0.0, "shapes": []},
            {"name": "int8_quantize", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/int8_conv.cu",
             "replaces": "mxnet_tpu/contrib/quantization.py:115",
             "max_abs_err": 0.0, "shapes": []},
            {"name": "int8_quantize_im2col", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/int8_conv.cu",
             "replaces": "mxnet_tpu/contrib/quantization.py:115",
             "max_abs_err": 0.0, "shapes": [], "stem": stem["summary"]},
            {"name": "int8_conv_hopper", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/int8_conv.cu",
             "replaces": "mxnet_tpu/contrib/quantization.py:197",
             "max_abs_err": 0.0, **{k: head[k] for k in keys},
             "bf16_ms": head["bf16_ms"], "general_ms": head["general_ms"],
             "shapes": hopper},
            {"name": "int8_conv_general", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/int8_conv.cu",
             "replaces": "mxnet_tpu/contrib/quantization.py:197",
             "max_abs_err": 0.0, **{k: general[0][k] for k in keys},
             "bf16_ms": general[0]["bf16_ms"], "shapes": general},
            {"name": "int8_conv_depthwise", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/int8_conv.cu",
             "replaces": "mxnet_tpu/contrib/quantization.py:197",
             "max_abs_err": 0.0, "shapes": []}]


def stem_routes(i8, x, wpk, wq, geo, scale, bias, ms, card):
    """The stem (B=32 float32 NCHW, scale 0.02) on both routes: its im2col
    rows through the hopper route's 1 x 1 (this slice's path) against
    the NHWC quantize and the general kernel (the earlier path), bit for bit in
    each epilogue, then timed: each kernel's own device ms (graph_ms),
    the pair in one graph, and each by the profiler (L2 flushed).  The
    pair's bound is x read once and the float32 output written once; the
    rows' own floor adds the im2col rows written and read."""
    geo4 = geo[:3] + ((1, 1),)
    cols = i8.int8_quantize_im2col(x, 0.02, *geo4)
    check(torch.equal(cols, i8.int8_quantize_im2col_plain(x, 0.02, *geo4)),
          "int8_quantize im2col: the stem's rows differ from plain")
    xq = i8.int8_quantize(x, 0.02)
    for kw in (dict(out_dtype=torch.int32), dict(scale=scale, bias=bias,
                                                 relu=True),
               dict(scale=scale, out_dtype=torch.bfloat16,
                    channels_last=True)):
        got = i8.quantized_conv(x, 0.02, wpk, *geo4, **kw)
        want = i8._int8_conv(xq, wpk, *geo, route="general", **kw)
        check(torch.equal(got, want), "the stem's hopper route differs "
              "from the general route: %d elements (%s)"
              % (int((got != want).sum()), sorted(kw)))
        del got, want
    fns = {"im2col": lambda: i8.int8_quantize_im2col(x, 0.02, *geo4),
           "hopper 1x1": lambda: i8.int8_conv(cols, wpk, (1, 1),
                                              scale=scale, bias=bias),
           "pair": lambda: i8.quantized_conv(x, 0.02, wpk, *geo4,
                                             scale=scale, bias=bias),
           "nhwc": lambda: i8.int8_quantize(x, 0.02),
           "general pair": lambda: i8._int8_conv(
               i8.int8_quantize(x, 0.02), wpk, *geo, scale=scale,
               bias=bias, route="general")}
    g = {k: graph_ms(f) for k, f in fns.items()}
    g["general"] = ms["general"]
    dv = {k: profiled_ms(fns[k]) for k in ("im2col", "hopper 1x1", "pair",
                                            "general pair")}
    call = time_ms(fns["pair"])
    plain = time_ms(lambda: i8.int8_conv_plain(
        i8.int8_quantize_im2col_plain(x, 0.02, *geo4), wpk, (1, 1),
        scale=scale, bias=bias), iters=3, warmup=1)
    N, O = x.shape[0], wpk.shape[1]
    M, kc = cols.shape[0] * cols.shape[1] * cols.shape[2], cols.shape[3]
    out_bytes = 4 * M * O
    macs = M * O * 3 * 49
    pair_b, pair_by = bound_ms(4 * x.numel() + wpk.numel() + out_bytes
                               + 8 * O, 2 * macs, INT8_OPS_PER_S)
    rows_b, _ = bound_ms(4 * x.numel() + 2 * M * kc + wpk.numel()
                         + out_bytes + 8 * O, 0)
    conv_b, conv_by = bound_ms(M * kc + wpk.numel() + out_bytes + 8 * O,
                               2 * M * O * kc, INT8_OPS_PER_S)
    col_b, col_by = bound_ms(4 * x.numel() + M * kc, x.numel(),
                             FP32_FLOPS_PER_S)
    print("int8 stem 7x7/2 3->64 224^2 (B=%d): im2col quantize %.4f ms + "
          "hopper 1x1 over %d channels %.4f ms = %.4f ms (one graph: %.4f "
          "ms; by the profiler %s + %s, one graph %s); the earlier NHWC "
          "quantize %.4f ms + general kernel %.4f ms (one graph: %.4f ms; "
          "profiler %s); the pair's call %.4f ms, plain %.4f ms; bound "
          "%.4f ms "
          "(%s: x read once, the float32 output written once), %.4f ms "
          "with the im2col rows written and read, im2col alone %.4f ms "
          "(%s), the 1x1 alone %.4f ms (%s) [%s]"
          % (N, g["im2col"], kc, g["hopper 1x1"],
             g["im2col"] + g["hopper 1x1"], g["pair"], _fmt(dv["im2col"]),
             _fmt(dv["hopper 1x1"]), _fmt(dv["pair"]), g["nhwc"],
             g["general"], g["general pair"], _fmt(dv["general pair"]),
             call, plain, pair_b, pair_by, rows_b,
             col_b, col_by, conv_b, conv_by, card))
    summary = {"pair_ms": g["pair"], "im2col_ms": g["im2col"],
               "conv_ms": g["hopper 1x1"], "device_ms": dv,
               "general_pair_ms": g["general pair"],
               "general_ms": g["general"], "nhwc_ms": g["nhwc"],
               "bound_ms": pair_b, "rows_floor_ms": rows_b,
               "call_ms": call, "plain_ms": plain}
    hopper_row = {"shape": "stem as im2col rows, 1x1 over %d channels" % kc,
                  "route": "hopper", "ms": g["hopper 1x1"],
                  "general_ms": g["general"], "call_ms": None,
                  "plain_ms": plain, "bound_ms": conv_b, "bound_by": conv_by,
                  "library_ms": None, "bf16_ms": None, "macs": M * O * kc,
                  "plan": i8.int8_conv_plan(M, O, wpk.shape[2])}
    return {"summary": summary, "hopper_row": hopper_row}


# the int8 forward's kernels by name: K3 on each route, K2 (its three
# kernels: quantize_tile, quantize_kernel for the Dense, quantize_im2col)
INT8_FORWARD_KERNELS = {"int8_conv hopper": "conv_hopper",
                        "int8_conv general": "conv_kernel",
                        "int8_conv depthwise": "mxq::conv_depthwise",
                        "int8_quantize": "quantize_",
                        "int8_quantize im2col": "quantize_im2col"}


def _forward_row(mt, net, x, tag, card, model="resnet50"):
    """device_busy of one forward of ``net`` on ``x`` (no tape), with the
    peak memory of the calls and the int8 kernels' ms and launches a
    call (INT8_FORWARD_KERNELS)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mt.autograd.pause():
        host, dev_ms, top, counts, per = device_busy(lambda: net(x), reps=5)
    peak = torch.cuda.max_memory_allocated()
    B = x.shape[0]
    int8 = {name: [sum(v[i] for k, v in per.items() if match in k)
                   for i in (0, 1)]
            for name, match in INT8_FORWARD_KERNELS.items()}
    print("%s %s forward (B=%d): %.0f images/s, %.2f ms host, %.2f ms "
          "of kernels (device busy %.1f%%), %.1f device events per call, "
          "peak memory %.2f GB; top kernels %s%s [%s]"
          % (model, tag, B, B / host * 1e3, host, dev_ms, 100 * dev_ms / host,
             counts["device events"], peak / 1e9,
             "; ".join("%s %.3f" % t for t in top),
             "".join("; %s %.3f ms in %g launches" % (k, v[0], v[1])
                     for k, v in int8.items() if v[1]), card))
    return {"images_per_s": B / host * 1e3, "host_ms": host,
            "kernel_ms": dev_ms, "peak_gb": peak / 1e9, "int8": int8}


def k2_forward_rows(mt, net, x, card):
    """K2 at every distinct quantize input of the int8 forward of ``net``
    on ``x``, found by forward pre-hooks on its quantized layers, and,
    beside them, the stem's NHWC layout (the earlier path): each held
    against plain on random data of that shape and timed -- own device
    ms by CUDA-graph replay (``ms``) and by the profiler (``device_ms``,
    L2 flushed), the wrapper call, the plain version; the bound is x
    read once and the int8 written once.  Each row counts its launches
    in the forward."""
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.ops import int8 as i8
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda blk, a: seen.append((blk, tuple(a[0].shape), a[0].dtype)))
        for m in net.modules()
        if isinstance(m, (q.QuantizedConv2D, q.QuantizedDense))]
    with mt.autograd.pause():
        net(x)
    for h in hooks:
        h.detach()
    keys = {}
    for blk, shape, dt in seen:
        if isinstance(blk, q.QuantizedDense):
            key = ("nhwc", (math.prod(shape[:-1]), shape[-1]), 1, None)
        else:
            geo = (blk._kernel, blk._strides, blk._padding, blk._dilation)
            mode, _ = i8.int8_conv_mode(*shape, *geo, blk._groups)
            key = (mode, shape, blk._groups, geo if mode == "im2col"
                   else None)
            if mode == "im2col":      # beside it, the earlier NHWC layout
                keys.setdefault(("nhwc", shape, blk._groups, None), 0)
        keys[key] = keys.get(key, 0) + 1
    check(sum(keys.values()) == 54, "int8 resnet50: %d quantize inputs, "
          "want 54" % sum(keys.values()))
    gen = torch.Generator(device=x.device).manual_seed(62)
    rows = []
    for (mode, shape, g, geo), count in sorted(keys.items(),
                                               key=lambda kv: -kv[1]):
        if mode == "im2col":
            def k2(xi, geo=geo):
                return i8.int8_quantize_im2col(xi, 0.02, *geo)

            def k2_plain(xi, geo=geo):
                return i8.int8_quantize_im2col_plain(xi, 0.02, *geo)
        else:
            def k2(xi, g=g):
                return i8.int8_quantize(xi, 0.02, g)

            def k2_plain(xi, g=g):
                return i8.int8_quantize_plain(xi, 0.02, g)
        # distinct inputs, 160 MB or more of them (at least 2, at most 16)
        xs = [torch.randn(shape, generator=gen, device=x.device)
              for _ in range(max(2, min(16, -(-160_000_000 // (
                  4 * math.prod(shape))))))]
        xr = xs[0]
        fn = lambda: k2(xr)  # noqa: E731
        out = fn()
        check(torch.equal(out, k2_plain(xr)), "int8_quantize %s %s "
              "differs from plain" % (mode, shape))
        ms = graph_ms(fn)
        b2b = chain_ms([lambda xi=xi: k2(xi) for xi in xs])
        dms = profiled_ms(fn, "quantize_")
        call = time_ms(fn)
        plain_ms = time_ms(lambda: k2_plain(xr), iters=3, warmup=1)
        b_ms, b_by = bound_ms(4 * xr.numel() + out.numel(), xr.numel(),
                              FP32_FLOPS_PER_S)
        tag = "x".join(map(str, shape[1:]))
        if mode == "im2col":
            tag += " im2col %dx%d/%d -> %s" % (geo[0][0], geo[0][1],
                                               geo[1][0],
                                               tuple(out.shape))
        plan = (i8.int8_quantize_plan(shape[0], shape[1],
                                      math.prod(shape[2:]) or 1, g)
                if mode == "nhwc" else None)
        print("int8_quantize %s (B=%d, float32, %d in the forward): kernel "
              "%.4f ms (graph), %.4f ms a launch back to back over %d "
              "inputs, %s ms (profiler), call %.4f ms, plain %.4f ms, "
              "bound %.4f ms (%s), %.1f%% of it (back to back: %.1f%%); "
              "plan %s [%s]"
              % (tag, shape[0], count, ms, b2b, len(xs), _fmt(dms), call,
                 plain_ms, b_ms, b_by, 100 * b_ms / ms, 100 * b_ms / b2b,
                 plan, card))
        rows.append({"shape": tag, "mode": mode, "launches": count,
                     "ms": ms, "b2b_ms": b2b, "device_ms": dms,
                     "call_ms": call,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "plan": plan})
        del xr, xs, out
    torch.cuda.empty_cache()
    return rows


def int8_resnet_phase(mt, co, dev, card):
    """``bench.py:318-343`` on the port: ``resnet50_v1()`` float32 NCHW,
    B=32, 224^2, one ``uniform(0, 1)`` calibration batch through
    ``quantize_net(calib_mode="naive")``, then the int8 net eager and
    hybridized (CUDA graphs) beside the float32 and bf16 nets of the same
    weights; top-1 agreement and the logits' error against the float32
    net on a second batch; the kernels launched per forward (K3 54 times:
    53 convolutions and the Dense; K2 as often).  Then
    ``calib_mode="entropy"`` on a batch of 8, its calibration timed.
    Returns the launch counts of the int8 forwards and K2's rows at its
    inputs (:func:`k2_forward_rows`)."""
    from mxnet_tpu_torch.contrib import quantization as q
    B = INT8_RESNET_B
    gen = torch.Generator(device=dev).manual_seed(61)
    calib = torch.rand(B, 3, 224, 224, generator=gen, device=dev)
    x = torch.rand(B, 3, 224, 224, generator=gen, device=dev)
    rows = {}
    fp32 = _resnet50(mt, dev)
    with mt.autograd.pause():
        want = fp32(x)
    for tag in ("float32", "bf16"):
        net = fp32 if tag == "float32" else _resnet50(mt, dev).cast(
            "bfloat16")
        xin = x if tag == "float32" else x.to(torch.bfloat16)
        for mode in ("eager", "hybridized"):
            net.hybridize(mode == "hybridized")
            rows["%s %s" % (tag, mode)] = _forward_row(
                mt, net, xin, "%s %s" % (tag, mode), card)
        net.hybridize(False)
    del net
    gc.collect()
    torch.cuda.empty_cache()
    net = _resnet50(mt, dev)
    with mt.autograd.pause():
        net(x[:1])         # shapes: quantize_net skips a deferred layer
    t0 = time.monotonic()
    q.quantize_net(net, calib_data=[calib], calib_mode="naive")
    torch.cuda.synchronize()
    naive_s = time.monotonic() - t0
    n_q = sum(isinstance(m, (q.QuantizedConv2D, q.QuantizedDense))
              for m in net.modules())
    check(n_q == 54, "int8 resnet50: %d layers quantized, want 54" % n_q)
    co.reset_launch_counts()
    with mt.autograd.pause():
        got = net(x)
    torch.cuda.synchronize()
    launches = dict(co.LAUNCHES)
    check(launches["int8_conv"] == 54 and launches["int8_quantize"] == 54
          and launches["int8_conv_hopper"] == 54
          and launches["int8_conv_general"] == 0
          and launches["int8_conv_depthwise"] == 0
          and launches["int8_quantize_im2col"] == 1,
          "int8 resnet50: a forward launched int8_conv %d (hopper %d, "
          "general %d) and int8_quantize %d times (im2col %d), want 54 "
          "(54 and 0) and 54 (the stem's 1)"
          % (launches["int8_conv"], launches["int8_conv_hopper"],
             launches["int8_conv_general"], launches["int8_quantize"],
             launches["int8_quantize_im2col"]))
    k2_rows = k2_forward_rows(mt, net, x, card)
    rows["int8 eager"] = _forward_row(mt, net, x, "int8 eager", card)
    net.hybridize()
    with mt.autograd.pause():
        net(x)
    co.reset_launch_counts()
    hyb = net(x)
    torch.cuda.synchronize()
    hyb_launches = dict(co.LAUNCHES)
    check(len(net._graphs) == 1 and torch.equal(hyb, got)
          and hyb_launches["int8_conv"] == 54
          and hyb_launches["int8_conv_hopper"] == 54
          and hyb_launches["int8_quantize"] == 54
          and hyb_launches["int8_quantize_im2col"] == 1,
          "int8 resnet50: the hybridized forward differs from eager or did "
          "not replay its kernels (%s)" % hyb_launches)
    rows["int8 hybridized"] = _forward_row(mt, net, x, "int8 hybridized",
                                           card)
    net.hybridize(False)
    check(got.shape == (B, 1000) and bool(torch.isfinite(got).all()),
          "int8 resnet50: logits %s not finite" % (tuple(got.shape),))
    rel = _rel(got, want)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    maxrel = ((got - want).abs().max() / want.abs().max()).item()
    print("int8 resnet50 (B=%d, calib naive on one uniform(0,1) batch, "
          "%.2f s): on a second batch, top-1 agreement with float32 %.4f, "
          "logits ||d||/||fp32|| %.4f (limit %.2f), max|d|/max|fp32| %.4f; "
          "a forward launches int8_conv %d and int8_quantize %d times "
          "(hybridized replay: %d, %d); hybridized == eager bit for bit "
          "[%s]" % (B, naive_s, agree, rel, INT8_RESNET_REL, maxrel,
                    launches["int8_conv"], launches["int8_quantize"],
                    hyb_launches["int8_conv"], hyb_launches["int8_quantize"],
                    card))
    check(rel <= INT8_RESNET_REL, "int8 resnet50: logits differ from "
          "float32 by %.4f" % rel)
    print("int8 resnet50 forward rows, same run: %s" % "; ".join(
        "%s %.0f images/s, %.2f ms host, %.2f ms kernels, %.2f GB"
        % (k, v["images_per_s"], v["host_ms"], v["kernel_ms"], v["peak_gb"])
        for k, v in rows.items()))
    k3 = rows["int8 hybridized"]["int8"]
    print("int8 resnet50 hybridized forward: K3 %.3f ms of kernels (hopper "
          "%.3f ms in %g launches, general %.3f in %g), K2 %.3f ms in %g "
          "(im2col %.3f in %g), of %.2f ms [%s]"
          % (k3["int8_conv hopper"][0] + k3["int8_conv general"][0],
             *k3["int8_conv hopper"], *k3["int8_conv general"],
             *k3["int8_quantize"], *k3["int8_quantize im2col"],
             rows["int8 hybridized"]["kernel_ms"], card))
    k2_sum = sum(r["launches"] * r["ms"] for r in k2_rows)
    k2_b2b = sum(r["launches"] * r["b2b_ms"] for r in k2_rows)
    k2_bound = sum(r["launches"] * r["bound_ms"] for r in k2_rows)
    print("int8 resnet50 K2 over the forward's %d launches: %.4f ms by the "
          "forward's own profile (hybridized), %.4f ms summed from the "
          "per-input rows (graph, L2 flushed; %.4f ms back to back), "
          "against a summed bound of %.4f ms (%.1f%% in the forward) [%s]"
          % (sum(r["launches"] for r in k2_rows), k3["int8_quantize"][0],
             k2_sum, k2_b2b, k2_bound,
             100 * k2_bound / max(k3["int8_quantize"][0], 1e-9), card))
    del net, got, hyb, fp32
    gc.collect()
    torch.cuda.empty_cache()
    net = _resnet50(mt, dev)
    with mt.autograd.pause():
        net(x[:1])
    t0 = time.monotonic()
    q.quantize_net(net, calib_data=[calib[:INT8_ENTROPY_B]],
                   calib_mode="entropy")
    torch.cuda.synchronize()
    ent_s = time.monotonic() - t0
    with mt.autograd.pause():
        ent = net(x)
    print("int8 resnet50 calib_mode=entropy on a batch of %d: calibration "
          "%.2f s (host numpy: 54 histograms of 8001 bins and their KL "
          "searches); top-1 agreement with float32 %.4f, logits "
          "||d||/||fp32|| %.4f [%s]"
          % (INT8_ENTROPY_B, ent_s,
             (ent.argmax(-1) == want.argmax(-1)).float().mean().item(),
             _rel(ent, want), card))
    check(bool(torch.isfinite(ent).all()), "int8 resnet50 entropy: logits "
          "not finite")
    del net, ent, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches, k2_rows


# ----------------------------------------------------------------------
# the vision zoo: every family at full width, two of them
# training, int8 MobileNet v2 (K3's general route at its depthwise
# layers), parameter files and export, and a failed capture
# ----------------------------------------------------------------------
ZOO_B = 32
#: one net a family, at its published input size
ZOO_NETS = [("alexnet", 224), ("vgg16_bn", 224), ("squeezenet1.1", 224),
            ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
            ("densenet121", 224), ("inceptionv3", 299)]
ZOO_TRAIN = ("mobilenetv2_1.0", "inceptionv3")
ZOO_TRAIN_STEPS = 3
#: float32 logits, card (cuDNN with TF32 off) vs CPU, ||d|| / ||cpu||:
#: ResNet-50's limit (the seven nets measured 0 to 2.3e-6 on the H100)
ZOO_CPU_REL = RESNET_CPU_REL
ZOO_HYB_REL = RESNET_HYB_REL
#: int8 MobileNet v2 against its float32 net, ||d|| / ||fp32||: the int8
#: ResNet-50's limit (measured 0.0223 on the H100, top-1 agreement 1.0)
ZOO_INT8_REL = INT8_RESNET_REL
#: an imported program against its net's eager forward: the same aten
#: ops and kernels on the same inputs, so bit for bit (as measured)
ZOO_EXPORT_REL = 0.0


def _zoo_net(mt, name, dev, seed=0):
    """``get_model(name)`` at full width (1000 classes), float32 on the
    card, its weights Xavier (magnitude 2) drawn from ``seed`` at the
    first forward."""
    net = mt.gluon.model_zoo.vision.get_model(name)
    return net.initialize(mt.init.Xavier(magnitude=2), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(
                              seed))


def zoo_cpu_check(mt, dev, name, params, x):
    """The float32 net on the card (cuDNN with TF32 off) against the CPU
    on the same weights and 2 images; returns ||d|| / ||cpu||."""
    vision = mt.gluon.model_zoo.vision
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with mt.autograd.pause():
            card = mt.convert.load_params(
                vision.get_model(name).initialize(device=dev), params)(x)
            cpu = mt.convert.load_params(
                vision.get_model(name).initialize(device="cpu"),
                params)(x.cpu())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    rel = _rel(card.cpu(), cpu)
    check(rel <= ZOO_CPU_REL, "%s: the card disagrees with the CPU by %.3e"
          % (name, rel))
    return rel


def zoo_inference(mt, dev, card, name, size):
    """``name`` at B=32 bf16 NCHW, eager and hybridized (CUDA graphs),
    after its float32 net held against the CPU; returns the rows."""
    gen = torch.Generator(device=dev).manual_seed(70)
    x = torch.randn(ZOO_B, 3, size, size, generator=gen, device=dev)
    net = _zoo_net(mt, name, dev)
    with mt.autograd.pause():
        net(x[:2])                             # materialise the weights
    cpu_rel = zoo_cpu_check(mt, dev, name, mt.convert.export_params(net),
                            x[:2])
    net.cast("bfloat16")
    xb = x.to(torch.bfloat16)
    with mt.autograd.pause():
        eager = net(xb)
    check(eager.shape == (ZOO_B, 1000) and bool(torch.isfinite(eager).all()),
          "%s: bf16 logits %s not finite" % (name, tuple(eager.shape)))
    rows = {"cpu_rel": cpu_rel}
    for mode in ("eager", "hybridized"):
        net.hybridize(mode == "hybridized")
        scope = contextlib.nullcontext() if mode == "hybridized" \
            else mt.autograd.pause()
        with scope:
            if mode == "hybridized":
                net(xb)                         # eager once, then capture
                out = net(xb)                   # replay
                rel = _rel(out, eager)
                check(len(net._graphs) == 1 and rel <= ZOO_HYB_REL,
                      "%s: no graph, or hybridized differs from eager by "
                      "%.3e" % (name, rel))
                rows["hyb_equal"] = torch.equal(out, eager)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(3):  # the profiler now and then keeps no device event
                host, dev_ms, top, counts, _ = device_busy(
                    lambda: net(xb), reps=5)
                if counts["device events"]:
                    break
            peak = torch.cuda.max_memory_allocated()
        rows[mode] = {"images_per_s": ZOO_B / host * 1e3, "host_ms": host,
                      "kernel_ms": dev_ms, "busy": dev_ms / host,
                      "peak_gb": peak / 1e9}
        print("zoo %s %s forward (B=%d bf16 %dx%d NCHW): %.0f images/s, "
              "%.2f ms host, %.2f ms of kernels (device busy %.1f%%), %.1f "
              "device events per call, peak memory %.2f GB; top kernels %s "
              "[%s]" % (name, mode, ZOO_B, size, size, ZOO_B / host * 1e3,
                        host, dev_ms, 100 * dev_ms / host,
                        counts["device events"], peak / 1e9,
                        "; ".join("%s %.3f" % t for t in top[:4]), card))
    net.hybridize(False)
    print("zoo %s: float32 card (TF32 off) vs CPU on 2 images ||d||/||cpu|| "
          "%.3e (limit %.0e); bf16 hybridized == eager bit for bit %s"
          % (name, cpu_rel, ZOO_CPU_REL, rows["hyb_equal"]))
    return rows


def zoo_train(mt, co, dev, card, name):
    """3 SGD steps (lr 0.05, momentum 0.9, wd 1e-4) of ``name`` at B=32,
    bf16 weights with BatchNorm in float32, BatchNorm in training mode,
    the softmax CE, through ``record`` and the ``Trainer``; returns the
    launch counts of the steps."""
    size = dict(ZOO_NETS)[name]
    net = _zoo_net(mt, name, dev, seed=1).cast("bfloat16")
    for m in net.modules():
        if isinstance(m, mt.gluon.nn.BatchNorm):
            m.cast("float32")
    gen = torch.Generator(device=dev).manual_seed(71)
    x = torch.randn(ZOO_B, 3, size, size, generator=gen, device=dev).to(
        torch.bfloat16)
    labels = torch.randint(0, 1000, (ZOO_B,), generator=gen, device=dev)
    with mt.autograd.pause():
        net(x[:2])
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9,
                                "wd": 1e-4})
    loss_fn = mt.gluon.loss.SoftmaxCELoss()

    def step():
        with mt.autograd.record():
            loss = loss_fn(net(x).float(), labels)
        mt.autograd.backward(loss)
        trainer.step(ZOO_B)
        return loss.mean().item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.reset_launch_counts()
    t0 = time.monotonic()
    losses = [step() for _ in range(ZOO_TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(co.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses), "zoo %s train: a loss is "
          "not finite: %s" % (name, losses))
    opt_per = check_opt_launches("zoo %s train" % name, launches, "multi_sgd",
                                 ZOO_TRAIN_STEPS, net.parameters())
    ms, dev_ms, _, _, per = device_busy(step, reps=2)
    opt_ms, opt_n = opt_cost(per)
    print("zoo %s train (B=%d bf16 %dx%d, SGD momentum 0.9): losses %s; %d "
          "steps in %.2f s; step %.1f ms host, %.1f ms of kernels (device "
          "busy %.1f%%), %.0f images/s, peak memory %.2f GB; multi_sgd %.3f "
          "ms in %g launches per step (%d by the table) [%s]"
          % (name, ZOO_B, size, size, losses, ZOO_TRAIN_STEPS, wall, ms,
             dev_ms, 100 * dev_ms / ms, ZOO_B / ms * 1e3, peak / 1e9, opt_ms,
             opt_n, opt_per, card))
    return launches


def _qconv_layers(mt, net, x):
    """(block, input shape) of every quantized convolution of a forward
    of ``net`` on ``x``, found by forward pre-hooks."""
    from mxnet_tpu_torch.contrib import quantization as q
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda blk, a: seen.append((blk, tuple(a[0].shape))))
        for m in net.modules() if isinstance(m, q.QuantizedConv2D)]
    with mt.autograd.pause():
        net(x)
    for h in hooks:
        h.detach()
    return seen


def _qconv_key(i8, blk, shape):
    geo = (blk._kernel, blk._strides, blk._padding, blk._dilation)
    mode, route = i8.int8_conv_mode(*shape, *geo, blk._groups)
    return (shape, blk._groups, geo, blk._wpk.shape[0] * blk._wpk.shape[1],
            mode, route)


def _qconv_plain(i8, blk, xi, mode):
    """K2 then K3, the plain versions, as ``quantized_conv`` runs them;
    (quantized input, output)."""
    s, g = blk._act_scale, blk._groups
    geo = (blk._kernel, blk._strides, blk._padding, blk._dilation)
    epi = {"scale": blk._scale, "bias": blk._bias,
           "relu": blk._activation == "relu", "out_dtype": xi.dtype}
    if mode == "im2col":
        q = i8.int8_quantize_im2col_plain(xi, s, *geo)
        return q, i8.int8_conv_plain(q, blk._wpk, (1, 1), **epi)
    q = i8.int8_quantize_plain(xi, s, g)
    return q, i8.int8_conv_plain(q, blk._wpk, *geo, g, **epi)


def zoo_int8_layers(mt, net, x, card, name):
    """Every distinct quantized convolution of the int8 forward of
    ``name``: K2 and K3 (through ``quantized_conv``) held against their
    plain versions bit for bit on random data of that input's shape; each
    depthwise one (K3's depthwise route) also held against the general
    kernel forced on it, then timed: own device ms by CUDA-graph replay
    (``ms``, L2 flushed), the general kernel's on the same input laid out
    with each channel padded to 4 bytes (``general_ms``: the earlier
    design, without the padding copy), the call, the plain version,
    cuDNN's bf16 channels-last depthwise convolution of the shape
    (``bf16_ms``; PyTorch has no int8 convolution on CUDA), and the bound
    on the bytes (int8 in, float32 out, the weight, its scales) or the
    MACs.  A kernel's ``ms`` is its own device time by the profiler (L2
    flushed), the graph replay's where the profiler drops the records.
    Returns (route counts a forward, depthwise rows)."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import int8 as i8
    layers = _qconv_layers(mt, net, x)
    keys = {}
    for blk, shape in layers:
        keys.setdefault(_qconv_key(i8, blk, shape), []).append(blk)
    routes = {"hopper": 0, "general": 0, "depthwise": 0, "im2col": 0}
    for key, blks in keys.items():
        routes[key[5]] += len(blks)
        routes["im2col"] += len(blks) * (key[4] == "im2col")
    gen = torch.Generator(device=x.device).manual_seed(72)
    rows = []
    for key, blks in sorted(keys.items(), key=lambda kv: -len(kv[1])):
        (shape, g, geo, O, mode, route), blk = key, blks[0]
        xi = torch.randn(shape, generator=gen, device=x.device)
        want_q, want = _qconv_plain(i8, blk, xi, mode)
        got_q = (i8.int8_quantize_im2col(xi, blk._act_scale, *geo)
                 if mode == "im2col" else
                 i8.int8_quantize(xi, blk._act_scale, g))
        epi = dict(scale=blk._scale, bias=blk._bias,
                   relu=blk._activation == "relu", out_dtype=xi.dtype)
        got = i8.quantized_conv(xi, blk._act_scale, blk._wpk, *geo, g,
                                **epi)
        check(torch.equal(got_q, want_q) and torch.equal(got, want),
              "int8 %s: K2 / K3 differ from plain at %s" % (name, key))
        if route != "depthwise":
            continue
        (kh, kw), stride, pad, dil = geo
        xq = got_q
        forced = i8._int8_conv(xq, blk._wpk, *geo, g, route="general", **epi)
        check(torch.equal(forced, want), "int8 %s: the general kernel "
              "forced on %s differs from plain" % (name, key))
        # the earlier design's input: each channel padded to 4 bytes
        xp = F.pad(xq[..., :g, None], (0, 3)).reshape(*xq.shape[:3], 4 * g)
        del forced

        def fn(q=xq, blk=blk, geo=geo, g=g, epi=epi):
            return i8.int8_conv(q, blk._wpk, *geo, g, **epi)
        graph = graph_ms(fn)
        general_graph = graph_ms(lambda: fn(xp))
        # each kernel's own device time (the profiler): a graph replay
        # adds ~5 us of its own, most of a 14^2 or 7^2 layer's time
        own = profiled_ms(fn, "mxq::conv_depthwise")
        general_own = profiled_ms(lambda: fn(xp), "mxq::conv_kernel")
        ms = graph if own is None else own
        general_ms = general_graph if general_own is None else general_own
        call = time_ms(fn)
        plain_ms = time_ms(lambda: _qconv_plain(i8, blk, xi, mode),
                           iters=3, warmup=1)
        xb = xi.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        wb = torch.randn(O, 1, kh, kw, generator=gen, device=x.device).to(
            torch.bfloat16)
        bf16_ms = graph_ms(lambda: F.conv2d(xb, wb, None, stride, pad, dil,
                                            g))
        N, C, H, W = shape
        OH, OW = got.shape[2:]
        macs = N * O * OH * OW * kh * kw
        nbytes = N * C * H * W + 4 * N * O * OH * OW + O * kh * kw + 8 * O
        b_ms, b_by = bound_ms(nbytes, 2 * macs, INT8_OPS_PER_S)
        tag = "%s dw %dx%d/%d %d@%dx%d" % (name, kh, kw, stride[0], C, H, W)
        print("int8_conv depthwise %s (B=%d, %d in the forward): kernel "
              "%.4f ms (profiler %s, graph %.4f), general kernel %.4f ms "
              "(profiler %s, graph %.4f), call %.4f ms, plain %.4f ms, bound "
              "%.4f ms (%s: %.1f MB), %.1f%% of it (general %.2f%%); cuDNN "
              "bf16 depthwise %.4f ms (graph) [%s]"
              % (tag, N, len(blks), ms, _fmt(own), graph, general_ms,
                 _fmt(general_own), general_graph, call, plain_ms, b_ms,
                 b_by, nbytes / 1e6, 100 * b_ms / ms,
                 100 * b_ms / general_ms, bf16_ms, card))
        rows.append({"shape": tag, "route": "depthwise",
                     "launches": len(blks), "ms": ms, "graph_ms": graph,
                     "general_ms": general_ms, "call_ms": call,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bound_bytes": nbytes,
                     "library_ms": None, "bf16_ms": bf16_ms, "macs": macs})
        del xq, xp, xb, wb
    torch.cuda.empty_cache()
    return routes, rows


#: the int8 zoo nets: their quantized layers and depthwise layers
ZOO_INT8 = {"mobilenetv2_1.0": (54, 17), "mobilenet1.0": (28, 13)}


def zoo_int8_phase(mt, co, dev, card, name):
    """``name`` (ZOO_INT8) float32 NCHW at B=32 through ``quantize_net``
    (naive, one uniform(0, 1) batch), eager and hybridized, beside the
    float32 and bf16 nets of the same weights: its depthwise layers on
    K3's depthwise route, the rest (the one-group layers whose padded
    channels are not a multiple of 32 through K2's im2col rows) on the
    hopper route, none on the general one; every distinct K2 / K3 input
    against plain.  Returns (the launches of one eager int8 forward, the
    depthwise rows)."""
    from mxnet_tpu_torch.contrib import quantization as q
    n_layers, n_dw = ZOO_INT8[name]
    gen = torch.Generator(device=dev).manual_seed(73)
    calib = torch.rand(ZOO_B, 3, 224, 224, generator=gen, device=dev)
    x = torch.rand(ZOO_B, 3, 224, 224, generator=gen, device=dev)
    fp32 = _zoo_net(mt, name, dev, seed=2)
    with mt.autograd.pause():
        want = fp32(x)
    rows = {}
    for tag in ("float32", "bf16"):
        net = fp32 if tag == "float32" else _zoo_net(mt, name, dev, 2).cast(
            "bfloat16")
        xin = x if tag == "float32" else x.to(torch.bfloat16)
        for mode in ("eager", "hybridized"):
            net.hybridize(mode == "hybridized")
            rows["%s %s" % (tag, mode)] = _forward_row(
                mt, net, xin, "%s %s" % (tag, mode), card, name)
        net.hybridize(False)
    del net
    net = _zoo_net(mt, name, dev, seed=2)
    with mt.autograd.pause():
        net(x[:1])
    q.quantize_net(net, calib_data=[calib], calib_mode="naive")
    n_q = sum(isinstance(m, (q.QuantizedConv2D, q.QuantizedDense))
              for m in net.modules())
    check(n_q == n_layers, "int8 %s: %d layers quantized, want %d"
          % (name, n_q, n_layers))
    routes, dw_rows = zoo_int8_layers(mt, net, x, card, name)
    names = ("int8_conv", "int8_conv_hopper", "int8_conv_general",
             "int8_conv_depthwise", "int8_quantize", "int8_quantize_im2col")
    n_dense = sum(isinstance(m, q.QuantizedDense) for m in net.modules())
    expect = (n_q, routes["hopper"] + n_dense, 0, n_dw, n_q,
              routes["im2col"])
    co.reset_launch_counts()
    with mt.autograd.pause():
        got = net(x)
    torch.cuda.synchronize()
    launches = dict(co.LAUNCHES)
    counts = tuple(launches[k] for k in names)
    check(counts == expect and routes["depthwise"] == n_dw and
          routes["general"] == 0,
          "int8 %s: a forward launched %s %s times, want %s"
          % (name, " / ".join(names), counts, expect))
    rows["int8 eager"] = _forward_row(mt, net, x, "int8 eager", card, name)
    net.hybridize()
    with mt.autograd.pause():
        net(x)
    co.reset_launch_counts()
    hyb = net(x)
    torch.cuda.synchronize()
    hyb_counts = tuple(co.LAUNCHES[k] for k in names)
    check(len(net._graphs) == 1 and torch.equal(hyb, got)
          and hyb_counts == counts, "int8 %s: the hybridized forward differs "
          "from eager or did not replay its kernels (%s)" % (name, hyb_counts))
    rows["int8 hybridized"] = _forward_row(mt, net, x, "int8 hybridized",
                                           card, name)
    net.hybridize(False)
    check(got.shape == (ZOO_B, 1000) and bool(torch.isfinite(got).all()),
          "int8 %s: logits not finite" % name)
    # in float64: MobileNet 1.0's random logits are ~1e-21, whose float32
    # squares underflow
    rel = _rel(got.double(), want.double())
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print("int8 %s (B=%d, calib naive on one uniform(0,1) batch): on a "
          "second batch, top-1 agreement with float32 %.4f, logits "
          "||d||/||fp32|| %.4f (limit %.2f), max|d|/max|fp32| %.4f; a forward "
          "launches int8_conv %d times (hopper %d, general %d, depthwise "
          "%d) and int8_quantize %d (im2col %d); hybridized == eager bit "
          "for bit [%s]"
          % (name, ZOO_B, agree, rel, ZOO_INT8_REL,
             ((got - want).abs().max() / want.abs().max()).item(), *counts,
             card))
    check(rel <= ZOO_INT8_REL, "int8 %s: logits differ from float32 by %.4f"
          % (name, rel))
    print("int8 %s forward rows, same run: %s" % (name, "; ".join(
        "%s %.0f images/s, %.2f ms host, %.2f ms kernels, %.2f GB"
        % (k, v["images_per_s"], v["host_ms"], v["kernel_ms"], v["peak_gb"])
        for k, v in rows.items())))
    k3 = rows["int8 hybridized"]["int8"]
    dw_sum = sum(r["launches"] * r["ms"] for r in dw_rows)
    dw_gen = sum(r["launches"] * r["general_ms"] for r in dw_rows)
    dw_bf16 = sum(r["launches"] * r["bf16_ms"] for r in dw_rows)
    dw_bound = sum(r["launches"] * r["bound_ms"] for r in dw_rows)
    print("int8 %s hybridized forward: K3 depthwise %.3f ms in %g launches "
          "(the per-shape rows sum to %.3f ms against a bound of %.3f ms: "
          "%.1f%%; the general kernel's rows %.3f ms, cuDNN bf16's %.3f "
          "ms), K3 hopper %.3f ms in %g, K3 general %.3f ms in %g, K2 %.3f "
          "ms in %g, of %.2f ms of kernels [%s]"
          % (name, *k3["int8_conv depthwise"], dw_sum, dw_bound,
             100 * dw_bound / dw_sum, dw_gen, dw_bf16,
             *k3["int8_conv hopper"], *k3["int8_conv general"],
             *k3["int8_quantize"], rows["int8 hybridized"]["kernel_ms"],
             card))
    del net, fp32, got, hyb, want
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dw_rows


def _imported_rows(mt, net, blk, x, tag, card):
    """Host and kernel time of the net hybridized and of its imported
    program, eager and hybridized, in one run."""
    out = {}
    for who, b in (("net", net), ("imported", blk)):
        for mode in ("eager", "hybridized"):
            if who == "net" and mode == "eager":
                continue
            b.hybridize(mode == "hybridized")
            with mt.autograd.pause() if mode == "eager" else \
                    contextlib.nullcontext():
                host, dev_ms, *_ = device_busy(lambda: b(x), reps=5)
            out["%s %s" % (who, mode)] = (x.shape[0] / host * 1e3, host,
                                          dev_ms)
            b.hybridize(False)
    print("%s export: %s [%s]" % (tag, "; ".join(
        "%s %.0f images/s (%.2f ms host, %.2f ms kernels)" % (k, *v)
        for k, v in out.items()), card))
    return out


def zoo_io_phase(mt, co, dev, card):
    """``save_parameters`` / ``load_parameters(device=cuda)`` of ResNet-50
    (logits bit for bit); ``export`` -> ``SymbolBlock.imports`` on the
    card of the int8 ResNet-50 (K2 and K3 launched by the program's
    ``mxnet_tpu_torch::`` ops) and of the bf16 MobileNet v2, each held
    against its net's eager forward; BERT-base's export refused.
    Returns the launches of one run of the imported int8 program."""
    import tempfile

    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.models.bert import BERTModel, bert_base_config
    vision = mt.gluon.model_zoo.vision
    gen = torch.Generator(device=dev).manual_seed(74)
    calib = torch.rand(ZOO_B, 3, 224, 224, generator=gen, device=dev)
    x = torch.rand(ZOO_B, 3, 224, 224, generator=gen, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        r50 = _resnet50(mt, dev)
        with mt.autograd.pause():
            want = r50(x)
        path = os.path.join(tmp, "resnet50.params")
        t0 = time.monotonic()
        r50.save_parameters(path)
        save_s = time.monotonic() - t0
        fresh = vision.resnet50_v1()
        t0 = time.monotonic()
        fresh.load_parameters(path, device=dev)
        load_s = time.monotonic() - t0
        with mt.autograd.pause():
            got = fresh(x)
        check(all(p.is_cuda for p in fresh.parameters()) and
              torch.equal(got, want), "resnet50: logits after save / load "
              "differ")
        print("resnet50 save_parameters %.2f s, load_parameters(device=cuda) "
              "%.2f s (%.1f MB): logits bit for bit [%s]"
              % (save_s, load_s, os.path.getsize(path) / 1e6, card))
        del fresh, got
        q.quantize_net(r50, calib_data=[calib], calib_mode="naive")
        with mt.autograd.pause():
            want = r50(x)
        t0 = time.monotonic()
        sym, par = r50.export(os.path.join(tmp, "r50_int8"),
                              example_inputs=(x,))
        export_s = time.monotonic() - t0
        blk = SymbolBlock.imports(sym, ["data"], par, device=dev)
        co.reset_launch_counts()
        got = blk(x)
        torch.cuda.synchronize()
        launches = dict(co.LAUNCHES)
        rel = _rel(got, want)
        check(launches["int8_quantize"] == 54 and launches["int8_conv"] == 54
              and launches["int8_conv_hopper"] == 54
              and launches["int8_quantize_im2col"] == 1,
              "int8 resnet50 imported: K2 / K3 launched %s" % {
                  k: v for k, v in launches.items() if v})
        check(rel <= ZOO_EXPORT_REL, "int8 resnet50 imported: differs from "
              "the net by %.3e" % rel)
        print("int8 resnet50 export %.2f s (%.1f MB program, %.1f MB "
              "params): the imported program launches int8_quantize %d "
              "(im2col %d) and int8_conv %d (hopper %d) times; == eager bit "
              "for bit %s (||d||/||eager|| %.3e, limit %.0e) [%s]"
              % (export_s, os.path.getsize(sym) / 1e6,
                 os.path.getsize(par) / 1e6, launches["int8_quantize"],
                 launches["int8_quantize_im2col"], launches["int8_conv"],
                 launches["int8_conv_hopper"], torch.equal(got, want), rel,
                 ZOO_EXPORT_REL, card))
        rows = {"int8 resnet50": _imported_rows(mt, r50, blk, x,
                                                "int8 resnet50", card)}
        del r50, blk, got, want
        gc.collect()
        torch.cuda.empty_cache()
        mnv2 = _zoo_net(mt, "mobilenetv2_1.0", dev, seed=3).cast("bfloat16")
        xb = x.to(torch.bfloat16)
        with mt.autograd.pause():
            want = mnv2(xb)
        sym, par = mnv2.export(os.path.join(tmp, "mnv2"), example_inputs=xb)
        blk = SymbolBlock.imports(sym, None, par, device=dev)
        got = blk(xb)
        rel = _rel(got, want)
        check(rel <= ZOO_EXPORT_REL, "bf16 mobilenetv2 imported: differs from "
              "the net by %.3e" % rel)
        print("bf16 mobilenetv2_1.0 export: imported == eager bit for bit %s "
              "(||d||/||eager|| %.3e, limit %.0e) [%s]"
              % (torch.equal(got, want), rel, ZOO_EXPORT_REL, card))
        rows["bf16 mobilenetv2_1.0"] = _imported_rows(
            mt, mnv2, blk, xb, "bf16 mobilenetv2_1.0", card)
        del mnv2, blk, got, want
        bert = BERTModel(bert_base_config()).initialize(device=dev)
        toks = torch.randint(0, 30000, (1, 128), generator=gen, device=dev)
        refused = None
        try:
            bert.export(os.path.join(tmp, "bert"), example_inputs=(toks,))
        except NotImplementedError as e:
            refused = str(e)
        check(refused is not None and "queue 2" in refused and
              not os.path.exists(os.path.join(tmp, "bert-0000.params")),
              "BERT-base: export did not refuse the flash forward")
        print("BERT-base export refused before writing a file: %s" % refused)
        del bert
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rows


def failed_capture_phase(co, dev):
    """F12: a capture that syncs with the host raises its error and
    leaves the process as it was: an unseeded ``torch.randn`` on the
    card, then a graph that captures and replays."""
    def syncing():
        return torch.ones(4, device=dev).sum().item()
    before = dict(co.LAUNCHES)
    raised = None
    try:
        co.capture_graph(syncing, warmup=0)
    except RuntimeError as e:
        raised = e
    check(raised is not None and co.LAUNCHES == before,
          "a capture that syncs with the host did not raise")
    a, b = torch.randn(8, device=dev), torch.rand(8, device=dev)
    y = torch.ones(16, device=dev)
    graph, out, _ = co.capture_graph(lambda: y * 2 + 1)
    y.fill_(3)
    co.replay_graph(graph, {})
    torch.cuda.synchronize()
    check(a.shape == b.shape == (8,) and
          torch.equal(out, torch.full((16,), 7.0, device=dev)),
          "after a failed capture a graph did not replay")
    print("failed capture (%s): unseeded torch.randn / torch.rand on the "
          "card, then a fresh graph captured and replayed: ok"
          % str(raised).splitlines()[0][:80])


def vision_zoo_phase(mt, co, dev, card):
    """The zoo's phases; returns ({path: launches}, K3's depthwise rows:
    MobileNet v2's, then MobileNet 1.0's)."""
    t0 = time.monotonic()
    failed_capture_phase(co, dev)
    infer = {}
    for name, size in ZOO_NETS:
        infer[name] = zoo_inference(mt, dev, card, name, size)
        gc.collect()
        torch.cuda.empty_cache()
    print("zoo inference rows (B=%d bf16; images/s eager / hybridized, "
          "device busy hybridized, peak GB hybridized, card vs CPU): %s "
          "[%s]" % (ZOO_B, "; ".join(
              "%s %.0f / %.0f, %.1f%%, %.2f GB, %.1e" % (
                  k, v["eager"]["images_per_s"],
                  v["hybridized"]["images_per_s"],
                  100 * v["hybridized"]["busy"], v["hybridized"]["peak_gb"],
                  v["cpu_rel"]) for k, v in infer.items()), card))
    train = {}
    for name in ZOO_TRAIN:
        for k, v in zoo_train(mt, co, dev, card, name).items():
            train[k] = train.get(k, 0) + v
        gc.collect()
        torch.cuda.empty_cache()
    int8_launches, dw_rows = zoo_int8_phase(mt, co, dev, card,
                                            "mobilenetv2_1.0")
    v1_launches, v1_rows = zoo_int8_phase(mt, co, dev, card, "mobilenet1.0")
    export_launches, _ = zoo_io_phase(mt, co, dev, card)
    print("vision zoo phases %.1f s" % (time.monotonic() - t0))
    return {"zoo_train": train, "zoo_int8": int8_launches,
            "zoo_int8_v1": v1_launches,
            "zoo_export": export_launches}, dw_rows + v1_rows


def amp_phase(mt, co, dev, card, finite_rec):
    """float16 AMP training: BERT-base (``amp.init("float16")``,
    ``convert_hybrid_block`` keeping LayerNorm float32, AdamW with
    ``multi_precision``, ``init_trainer``, ``scale_loss``), 6 steps at
    B=16, T=512, dropout off, through the tensor-core flash kernels; then
    ResNet-50 NHWC, B=128, SGD with momentum, 3 updating steps (an
    overflowed step is counted and taken again); each with its
    loss-scale trajectory from 2^16 and K1 launched once a step.  Then
    the guard: a ``GradGuard`` on the ResNet trainer and an injected
    ``nan_grad``: the step is skipped (weights bit for bit),
    ``fault::nonfinite_steps`` counts 1, the scale halves, and the next
    step updates.  ``finite_rec`` (K1's record) gains the BERT-base
    gradient list's timing.  Returns the launch counts of the three
    paths."""
    from mxnet_tpu_torch import amp, fault, profiler
    from mxnet_tpu_torch.ops import multi_tensor as mtk
    amp.init("float16")
    cfg = mt.models.bert_base_config(dtype="float32", dropout=0.0)
    net = mt.models.BERTForPretrain(cfg).initialize(
        device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    batch = bert_batch(cfg, dev, BERT_B, BERT_T, 7)
    probe = (batch[0][:2], batch[1][:2])
    with torch.no_grad(), mt.autograd.pause():
        fp32_loss = bert_loss(mt, net, *batch).item()
        fp32_logits = net(*probe)[0].float()
    amp.convert_hybrid_block(net, "float16")
    with torch.no_grad(), mt.autograd.pause():
        logit_rel = _rel(net(*probe)[0], fp32_logits)
    del fp32_logits
    check(logit_rel <= AMP_LOGIT_REL, "amp bert: float16 MLM logits differ "
          "from float32 by %.3g (limit %.0e)" % (logit_rel, AMP_LOGIT_REL))
    dts = sorted({str(p.dtype)[6:] for p in net.parameters()})
    ln = {str(m.gamma.dtype)[6:] for m in net.modules()
          if isinstance(m, mt.gluon.nn.LayerNorm)}
    check(ln == {"float32"} and "float16" in dts, "amp: convert_hybrid_block "
          "left LayerNorm %s, weights %s" % (ln, dts))
    tr = mt.gluon.Trainer(net.collect_params(), "adamw",
                          {"learning_rate": 2e-5, "wd": 0.01,
                           "multi_precision": True})
    amp.init_trainer(tr)

    def bert_step(step=True):
        with mt.autograd.record():
            loss = bert_loss(mt, net, *batch)
            with amp.scale_loss(loss, tr) as scaled:
                mt.autograd.backward(scaled)
        if step:
            tr.step(1)
        return loss.item()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.reset_launch_counts()
    traj, losses = [], []
    t0 = time.monotonic()
    for _ in range(AMP_BERT_STEPS):
        losses.append(bert_step())
        traj.append(tr._amp_loss_scaler.loss_scale)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    bert_launches = dict(co.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    overflows = sum(b < a for a, b in zip([2.0 ** 16] + traj, traj))
    check(all(math.isfinite(v) for v in losses), "amp bert: a loss is not "
          "finite: %s" % losses)
    check(abs(losses[0] - fp32_loss) <= AMP_LOSS_RTOL * abs(fp32_loss),
          "amp bert: first loss %.5f, float32 %.5f" % (losses[0], fp32_loss))
    check(bert_launches["multi_all_finite"] == AMP_BERT_STEPS,
          "amp bert: multi_all_finite launched %d times in %d steps"
          % (bert_launches["multi_all_finite"], AMP_BERT_STEPS))
    for name in ("flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma"):
        check(bert_launches[name] == cfg.num_layers * AMP_BERT_STEPS,
              "amp bert: %s launched %d times" % (name, bert_launches[name]))
    ms, dev_ms, top, counts, per = device_busy(bert_step, reps=2)
    print("amp bert-base float16 (B=%d, T=%d, dropout 0, AdamW "
          "multi_precision): losses %s (float32 model's first %.5f, limit "
          "%.0e relative); MLM logits of 2 sequences before the first "
          "step: ||fp16 - fp32|| / ||fp32|| %.3g (limit %.0e); loss scale "
          "%s from 2^16, %d overflow steps; %d "
          "steps in %.2f s; step %.1f ms host, %.1f ms of kernels (device "
          "busy %.1f%%), %.1f samples/s, peak memory %.2f GB; "
          "multi_all_finite %d launches (1 a step); top kernels %s [%s]"
          % (BERT_B, BERT_T, losses, fp32_loss, AMP_LOSS_RTOL, logit_rel,
             AMP_LOGIT_REL, traj,
             overflows, AMP_BERT_STEPS, wall, ms, dev_ms, 100 * dev_ms / ms,
             BERT_B / ms * 1e3, peak / 1e9,
             bert_launches["multi_all_finite"],
             "; ".join("%s %.3f" % t for t in top), card))
    bert_step(step=False)                 # fresh gradients, kept
    grads = [p.grad for p in net.parameters() if p.grad is not None]
    finite_rec["shapes"].append(finite_list_timing(
        mtk, grads, "bert-base float16 AMP grads (float16 + float32 "
        "LayerNorm)", card))
    del net, tr, grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    # ResNet-50, NHWC, float16 with float32 BatchNorm
    B = AMP_RESNET_B
    net = _resnet50(mt, dev, "NHWC")
    amp.convert_hybrid_block(net, "float16")
    gen = torch.Generator(device=dev).manual_seed(62)
    x = torch.randn(B, 224, 224, 3, generator=gen, device=dev).half()
    labels = torch.randint(0, 1000, (B,), generator=gen, device=dev)
    with mt.autograd.pause():
        net(x[:2])
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.05, "momentum": 0.9,
                           "wd": 1e-4, "multi_precision": True})
    amp.init_trainer(tr)
    loss_fn = mt.gluon.loss.SoftmaxCELoss()

    def resnet_backward():
        with mt.autograd.record():
            loss = loss_fn(net(x).float(), labels).mean()
            with amp.scale_loss(loss, tr) as scaled:
                mt.autograd.backward(scaled)
        return loss.item()

    def resnet_step():
        loss = resnet_backward()
        tr.step(1)
        return loss
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    co.reset_launch_counts()
    traj, losses, updates = [], [], 0
    # AMP_RESNET_STEPS steps that update; an overflowed one (the scale
    # halves, nothing updates) is counted and retried
    while updates < AMP_RESNET_STEPS and len(traj) < AMP_RESNET_TRIES:
        scale = tr._amp_loss_scaler.loss_scale
        losses.append(resnet_step())
        traj.append(tr._amp_loss_scaler.loss_scale)
        updates += traj[-1] >= scale
    torch.cuda.synchronize()
    rn_launches = dict(co.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print("amp resnet50 float16 NHWC: losses %s; loss scale %s from 2^16, "
          "%d overflow steps; launches %s" % (
              losses, traj, len(traj) - updates,
              {k: v for k, v in rn_launches.items() if v}))
    check(all(math.isfinite(v) for v in losses), "amp resnet: a loss is not "
          "finite: %s" % losses)
    check(updates == AMP_RESNET_STEPS and
          rn_launches["multi_all_finite"] == len(traj) and
          rn_launches["multi_sgd"] == updates * opt_tables(net.parameters()),
          "amp resnet: %d updating steps of %d, multi_all_finite %d / "
          "multi_sgd %d launches" % (updates, len(traj),
                                     rn_launches["multi_all_finite"],
                                     rn_launches["multi_sgd"]))
    ms, dev_ms, top, counts, per = device_busy(resnet_step, reps=2)
    print("amp resnet50 float16 NHWC (B=%d, SGD momentum 0.9, float32 "
          "BatchNorm): %d updating steps; step %.1f ms host, %.1f ms of "
          "kernels (device busy %.1f%%), %.0f images/s, peak memory %.2f "
          "GB; multi_all_finite %d launches (1 a step); top kernels %s [%s]"
          % (B, updates, ms, dev_ms, 100 * dev_ms / ms, B / ms * 1e3,
             peak / 1e9, rn_launches["multi_all_finite"],
             "; ".join("%s %.3f" % t for t in top), card))
    # the guard
    guard = fault.GradGuard(tr)
    base = profiler.get_counters().get("fault::nonfinite_steps", 0)
    scale = tr._amp_loss_scaler.loss_scale
    resnet_backward()
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    fault.inject("nan_grad", at=1)
    co.reset_launch_counts()
    try:
        tr.step(1)
    finally:
        fault.clear()
    torch.cuda.synchronize()
    guard_launches = dict(co.LAUNCHES)
    same = all(torch.equal(p.detach(), before[n])
               for n, p in net.named_parameters())
    skips = profiler.get_counters().get("fault::nonfinite_steps", 0) - base
    check(same and skips == 1 and guard.skipped == 1
          and tr._amp_loss_scaler.loss_scale == scale / 2
          and guard_launches["multi_all_finite"] == 1
          and guard_launches["multi_sgd"] == 0,
          "guard: weights same %s, nonfinite_steps %d, skipped %d, scale "
          "%s -> %s, launches %s" % (same, skips, guard.skipped, scale,
                                     tr._amp_loss_scaler.loss_scale,
                                     guard_launches))
    resnet_step()
    moved = sum(not torch.equal(p.detach(), before[n])
                for n, p in net.named_parameters() if p.requires_grad)
    check(moved > 0 and guard.consecutive == 0, "guard: the step after the "
          "skip updated nothing")
    print("guard (GradGuard on the amp resnet50 trainer, nan_grad injected "
          "at the step seam): step skipped, every weight bit for bit, "
          "fault::nonfinite_steps +%d, loss scale %s -> %s, "
          "multi_all_finite launched %d, multi_sgd %d; the next step moved "
          "%d trainable tensors [%s]"
          % (skips, scale, scale / 2, guard_launches["multi_all_finite"],
             guard_launches["multi_sgd"], moved, card))
    guard.detach()
    del net, tr, before, x
    gc.collect()
    torch.cuda.empty_cache()
    return bert_launches, rn_launches, guard_launches


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


def profiled_ms(fn, match=None):
    """:func:`device_ms`'s ms, or None where the profiler keeps dropping
    the calls' records (seen on the H100 machine late in a run)."""
    try:
        return device_ms(fn, match)[0]
    except SmokeFailure as e:
        print("profiler: not measured (%s)" % str(e)[:160])
        return None


def _fmt(ms):
    return "not measured" if ms is None else "%.4f" % ms


def chain_ms(fns, iters=10):
    """Device ms per call of ``fns`` captured back to back in one CUDA
    graph and replayed (L2 flushed before each replay): each call's time
    as a graph step shows it, with the launch gaps inside a graph and no
    graph launch.  Give calls that read distinct data (weights), more
    than the L2 holds, so that each reads its own from memory."""
    from mxnet_tpu_torch.ops import cuda_ops
    graph, _, _ = cuda_ops.capture_graph(lambda: [f() for f in fns],
                                         warmup=1)
    return time_ms(graph.replay, iters, warmup=1) / len(fns)


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


def _fused_sgd_ms(groups, lr, wd, momentum):
    """Device ms (:func:`graph_ms`) of ``torch._fused_sgd_`` (PyTorch's
    own fused SGD with momentum; one lr and wd for the list, where the
    kernel's are per tensor, and the momentum in the weights' dtype,
    where the kernel's is float32) on the list: the library yardstick of
    ``multi_sgd``; the port never calls it."""
    ps, gs = ([grp[i].clone() for grp in groups] for i in range(2))
    # its fast path takes one dtype a list: momentum in the weights'
    ms = [grp[2].to(grp[0].dtype) for grp in groups]
    try:     # the yardstick only: a torch without it leaves library_ms null
        return graph_ms(lambda: torch._fused_sgd_(
            ps, gs, ms, weight_decay=wd, momentum=momentum, lr=lr,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False))
    except (AttributeError, RuntimeError, TypeError) as e:
        print("torch._fused_sgd_ not timed: %s" % e)
        return None


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
                elif kind == "sgd":
                    def lib():
                        return _fused_sgd_ms(groups, 2e-5, 0.01, 0.9)
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


# ----------------------------------------------------------------------
# phase 15: context and expert parallelism, 4 ranks on the one card
# ----------------------------------------------------------------------
# Llama-3-8B attention widths in bf16, long context: q (1, 32, 4*8192,
# 128), k/v (1, 8, 4*8192, 128), 8192 tokens a rank.  Held against plain
# only at 4*1024 (the plain scores at 32k would be 137 GB).
RING_WORLD, RING_H, RING_HKV, RING_D = 4, 32, 8, 128
RING_T_LOCAL, RING_PLAIN_T_LOCAL = 8192, 1024
# (mesh, axis, causal, layout)
RING_CASES = [("flat", "cp", True, "striped"),
              ("flat", "cp", True, "roundrobin"),
              ("flat", "cp", False, "roundrobin"),
              ("2level", ("dcn", "cp"), True, "striped"),
              ("2level", ("dcn", "cp"), True, "roundrobin"),
              ("2level", ("dcn", "cp"), False, "roundrobin")]
# The ring against one flash call (or plain) over the whole sequence.
# Both round P to bf16 per block, the ring merges its blocks' bf16
# outputs in float32 and rounds once more; so twice the kernel's own
# limits against plain: O absolute, each grad max|d| / max|ref|.
# Measured on an H100: O 1.56e-2 (one bf16 step of an |O| in [2, 4)),
# grads at most 6.9e-3, at both lengths.
RING_O_ATOL = 2 * FLASH_O_ATOL
RING_GRAD_REL = 2 * FLASH_BWD_TOL
# One full-width MoE layer over ep=4: x (2048, 4096) bf16, 8 experts of
# 4096 -> 14336; against the unsharded call, max|d| / max|ref|.  Each
# token takes one expert, so the partial sums add zeros, and only the
# per-expert products' cuBLAS kernels may differ (bf16 output).
# Measured on an H100: bitwise equal.
EP_T, EP_D, EP_H, EP_E = 2048, 4096, 14336, 8
EP_REL = 1e-2
RING_TIMEOUT_S = 600


def ring_rank_modules():
    """What a rank child imports: the port, its parallel layer (the
    pipeline and the sharding rules included), the kvstore and its
    kernels' wrappers (no JAX)."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore, parallel  # noqa: F401
    from mxnet_tpu_torch.ops import cuda_ops
    from mxnet_tpu_torch.parallel import _compat, pipeline  # noqa: F401
    from mxnet_tpu_torch.parallel import sharding  # noqa: F401
    return mt, parallel, cuda_ops, _compat


def _ring_inputs(T, dev):
    gen = torch.Generator(device=dev).manual_seed(21)

    def rnd(h):
        return torch.randn(1, h, T, RING_D, device=dev, generator=gen,
                           dtype=torch.bfloat16)
    return rnd(RING_H), rnd(RING_HKV), rnd(RING_HKV), rnd(RING_H)


def _ring_reference(co, q, k, v, do, causal, plain):
    """(o, dq, dk, dv) over the whole sequence in one process: the plain
    version (float32), or one flash call and its backward kernels."""
    if plain:
        zero = torch.zeros(1, dtype=torch.int32, device=q.device)
        scale = RING_D ** -0.5
        o, lse = co._dense_with_lse(q, k, v, zero, zero, causal, scale)
        delta = (do.float() * o.float()).sum(-1)
        return (o,) + tuple(co._flash_bwd_dense(q, k, v, do, lse, delta,
                                                zero, zero, causal, scale))
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    o = co.flash_attention(qq, kk, vv, causal=causal)
    return (o.detach(),) + torch.autograd.grad(o, (qq, kk, vv), do)


def _ring_call(parallel, mesh, axis, causal, layout, q, k, v, do):
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    o = parallel.ring_attention_sharded(qq, kk, vv, mesh, axis_name=axis,
                                        causal=causal, layout=layout)
    return (o.detach(),) + torch.autograd.grad(o, (qq, kk, vv), do)


def _kernel_ms(fn):
    """(flash kernels' device ms, all kernels' device ms) of one call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return (sum(e.self_device_time_total for e in ev if "flash" in e.key)
            / 1e3, sum(e.self_device_time_total for e in ev) / 1e3)


def ring_rank(rank, out_dir, backend="gloo"):
    """One rank of the ring phase (``chip_smoke.py --ring-rank R DIR
    [BACKEND]``): the ring cases at 4*1024 (rank 0 holds them against
    plain) and at 4*8192 (against one flash call), then the ep MoE layer
    (against the unsharded call); a JSON report into DIR.  Rank r runs
    on card r % device_count."""
    import torch.distributed as dist
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(out_dir, "store"),
                                      RING_WORLD),
        rank=rank, world_size=RING_WORLD)
    mt, parallel, co, comm = ring_rank_modules()
    meshes = {"flat": parallel.create_mesh(cp=RING_WORLD),
              "2level": parallel.create_mesh(dcn=2, cp=RING_WORLD // 2)}
    dev = meshes["flat"].device
    report = {"rank": rank, "device": str(dev),
              "backend": meshes["flat"].backend, "cases": [],
              "launches": dict.fromkeys(co.LAUNCHES, 0)}
    for t_local in (RING_PLAIN_T_LOCAL, RING_T_LOCAL):
        plain = t_local == RING_PLAIN_T_LOCAL
        q, k, v, do = _ring_inputs(RING_WORLD * t_local, dev)
        refs = {}
        # one untimed call first: the first collectives and host buffers
        # cost seconds once (3.8 s of the first case's timing without it)
        _ring_call(parallel, meshes["flat"], "cp", True, "striped", q, k, v,
                   do)
        for mesh_name, axis, causal, layout in RING_CASES:
            dist.barrier()
            torch.cuda.synchronize()
            co.reset_launch_counts()
            comm.reset_transport()
            t0 = time.perf_counter()
            got = _ring_call(parallel, meshes[mesh_name], axis, causal,
                             layout, q, k, v, do)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(co.LAUNCHES)
            transport = dict(comm.TRANSPORT)
            for name, n in launches.items():
                report["launches"][name] += n
            dist.barrier()
            flash_ms, dev_ms = _kernel_ms(lambda: _ring_call(
                parallel, meshes[mesh_name], axis, causal, layout, q, k, v,
                do))
            case = {"T": RING_WORLD * t_local, "mesh": mesh_name,
                    "causal": causal, "layout": layout, "ring_ms": ms,
                    "flash_kernels_ms": flash_ms, "device_ms": dev_ms,
                    "launches": {n: launches[n] for n in
                                 ("flash_fwd", "flash_bwd_dq",
                                  "flash_bwd_dkv")},
                    "staged_calls": transport["staged_calls"],
                    "staged_bytes": transport["staged_bytes"],
                    "staged_ms": transport["staged_ms"],
                    "device_calls": transport["device_calls"]}
            if rank == 0:
                if causal not in refs:
                    refs[causal] = _ring_reference(co, q, k, v, do, causal,
                                                   plain)
                ref = refs[causal]
                case["against"] = "plain" if plain else "kernel"
                case["o_err"] = (got[0].float() - ref[0].float()).abs() \
                    .max().item()
                case["grad_rel"] = [
                    ((g.float() - r.float()).abs().max() /
                     r.float().abs().max()).item()
                    for g, r in zip(got[1:], ref[1:])]
            report["cases"].append(case)
            del got
        del q, k, v, do, refs
        torch.cuda.empty_cache()
    # expert parallelism: one full-width MoE layer over ep
    ep = parallel.create_mesh(ep=RING_WORLD)
    gen = torch.Generator(device=dev).manual_seed(22)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * std).to(
            torch.bfloat16)
    x = rnd(EP_T, EP_D)
    gate = rnd(EP_D, EP_E, std=0.02)
    w1 = rnd(EP_E, EP_D, EP_H, std=0.02)
    w2 = rnd(EP_E, EP_H, EP_D, std=0.02)
    mine = slice(rank * EP_E // RING_WORLD, (rank + 1) * EP_E // RING_WORLD)
    parallel.switch_moe(x, gate, w1[mine], w2[mine], mesh=ep)   # warm-up
    dist.barrier()
    comm.reset_transport()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, aux = parallel.switch_moe(x, gate, w1[mine], w2[mine], mesh=ep)
    torch.cuda.synchronize()
    ep_case = {"ms": (time.perf_counter() - t0) * 1e3,
               "staged_bytes": comm.TRANSPORT["staged_bytes"],
               "staged_ms": comm.TRANSPORT["staged_ms"],
               "finite": bool(torch.isfinite(out).all())}
    if rank == 0:
        want, aux_w = parallel.switch_moe(x, gate, w1, w2)
        ep_case["rel_err"] = ((out.float() - want.float()).abs().max() /
                              want.float().abs().max()).item()
        ep_case["aux_err"] = abs(aux.item() - aux_w.item())
    report["ep"] = ep_case
    del x, gate, w1, w2, out
    torch.cuda.empty_cache()
    # phase 17 in the same children: dp x tp, the pipeline, the kvstore
    report["dp_tp"] = dp_tp_rank(mt, parallel, co, comm, dev, rank)
    report["pipeline"] = pipeline_rank(mt, parallel, co, comm, dev, rank)
    report["kvstore"] = kvstore_rank(mt, co, dev, rank, RING_WORLD)
    report["imported_jax"] = any(m.split(".")[0] in ("jax", "jaxlib",
                                                     "mxnet_tpu")
                                 for m in sys.modules)
    dump_json(os.path.join(out_dir, "rank%d.json" % rank), report)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def ring_block_check(co, dev):
    """The flash forward and the block backward at one ring step's
    shape, q (1, 32, 8192, 128) over k/v (1, 8, 8192, 128) bf16, at the
    offsets the ring gives them, against plain: a later rank's block in
    the striped layout (keys shifted by one), an earlier rank's block in
    the round-robin one (all visible) and a later rank's (all masked).
    Returns the largest errors: O, lse absolute; dq / dk / dv relative
    (max|d| / max|plain|) and absolute."""
    T, scale = RING_T_LOCAL, RING_D ** -0.5
    q, k, v, do = _ring_inputs(T, dev)
    worst = {"o": 0.0, "lse": 0.0, "rel": 0.0, "abs": 0.0}
    for qo, ko in ((0, 1), (2 * T, T), (T, 2 * T)):
        o, lse = co.flash_attention_with_lse(q, k, v, causal=True,
                                             q_offset=qo, k_offset=ko)
        offs = [torch.tensor([x], dtype=torch.int32, device=dev)
                for x in (qo, ko)]
        o_p, lse_p = co._dense_with_lse(q, k, v, *offs, True, scale)
        masked = torch.isneginf(lse_p)
        check(torch.equal(torch.isneginf(lse), masked),
              "ring block: -inf lse rows differ (offsets %d, %d)" % (qo, ko))
        eo = (o.float() - o_p.float()).abs().max().item()
        el = (lse[~masked] - lse_p[~masked]).abs().max().item() \
            if (~masked).any() else 0.0
        del o_p, lse_p
        delta = (do.float() * o.float()).sum(-1)
        got = co.flash_attention_block_bwd(q, k, v, do, lse, delta,
                                           causal=True, q_offset=qo,
                                           k_offset=ko)
        want = co._flash_bwd_dense(q, k, v, do, lse, delta, *offs, True,
                                   scale)
        errs = [((g - w).abs().max().item(), w.abs().max().item())
                for g, w in zip(got, want)]
        del got, want
        rel = max(e / m if m else e for e, m in errs)
        print("ring block q(1,%d,%d,%d) over kv(1,%d,%d,%d) causal, q_off "
              "%d k_off %d: O err %.3e, lse err %.3e, backward max|d|/"
              "max|plain| %.3e (max |d| %.3e); masked rows %d"
              % (RING_H, T, RING_D, RING_HKV, T, RING_D, qo, ko, eo, el,
                 rel, max(e for e, _ in errs), int(masked.sum())))
        check(eo <= FLASH_O_ATOL and el <= FLASH_LSE_ATOL and
              rel <= FLASH_BWD_TOL, "ring block disagrees with plain")
        worst = {"o": max(worst["o"], eo), "lse": max(worst["lse"], el),
                 "rel": max(worst["rel"], rel),
                 "abs": max(worst["abs"], max(e for e, _ in errs))}
        torch.cuda.empty_cache()
    return worst


def _run_ranks(out_dir, backend, world=RING_WORLD, mode="--ring-rank",
               timeout=RING_TIMEOUT_S):
    """Start the rank children (``mode``: ``--ring-rank``,
    ``--serve-tp-rank`` or ``--elastic-rank``, whose third argument is
    its part in place of a backend) and wait; stop them all when one
    fails or the time runs out."""
    procs, logs = [], []
    for r in range(world):
        log = open(os.path.join(out_dir, "rank%d.log" % r), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode,
             str(r), out_dir, backend]
            + ([str(world)] if mode == "--serve-tp-rank" else []),
            stdout=log, stderr=subprocess.STDOUT))
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() - t0 > timeout:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, "rank%d.log" % r)) as f:
                tail = f.read()[-3000:]
            raise SmokeFailure("%s: rank %d exited %s:\n%s"
                               % (mode, r, p.returncode, tail))
    return time.monotonic() - t0


def ring_phase(co, dev, card, backend="gloo"):
    """Context and expert parallelism over 4 ranks, after one ring
    step's kernels are held against plain here: gloo ranks sharing the
    one card (NCCL refuses two ranks on one device), or with ``backend=
    "nccl"`` one rank a card on 4 cards (``--ring-nccl``).  The kernels
    are built already (``main``), so the ranks only load them.  Returns
    rank 0's launch counts over its ring calls and the ring block's
    errors."""
    import tempfile
    block = ring_block_check(co, dev)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mx_ring_") as out_dir:
        wall = _run_ranks(out_dir, backend)
        reports = []
        for r in range(RING_WORLD):
            with open(os.path.join(out_dir, "rank%d.json" % r)) as f:
                reports.append(json.load(f))
    check(not any(rep["imported_jax"] for rep in reports),
          "ring: a rank child imported JAX")
    print("ring: %d ranks on %s, backend %s (%s); %.1f s in all [%s]"
          % (RING_WORLD, ", ".join(sorted({r["device"] for r in reports})),
             reports[0]["backend"], "every CUDA tensor staged through "
             "pinned host memory" if reports[0]["backend"] == "gloo" else
             "collectives on the cards", wall, card))
    for i, case in enumerate(reports[0]["cases"]):
        per = [rep["cases"][i] for rep in reports]
        tag = "T=%d %s %s %s" % (case["T"], case["mesh"],
                                 "causal" if case["causal"] else
                                 "non-causal", case["layout"])
        for rep, c in zip(reports, per):
            check(c["launches"] == {"flash_fwd": RING_WORLD,
                                    "flash_bwd_dq": RING_WORLD,
                                    "flash_bwd_dkv": RING_WORLD},
                  "ring %s: rank %d launched %s, want %d of each per call"
                  % (tag, rep["rank"], c["launches"], RING_WORLD))
        print("ring %s vs %s: O err %.3e (limit %.0e), max|d|/max|ref| "
              "dq %.3e dk %.3e dv %.3e (limit %.0e); per rank: ring ms "
              "(forward + backward) %s, flash kernels' device ms %s, all "
              "device events' (staging copies included) %s, host-staged "
              "transport %s MB in %s ms (%d calls; %d on the device); "
              "launches per rank %s"
              % (tag, case["against"], case["o_err"], RING_O_ATOL,
                 *case["grad_rel"], RING_GRAD_REL,
                 ["%.1f" % c["ring_ms"] for c in per],
                 ["%.2f" % c["flash_kernels_ms"] for c in per],
                 ["%.2f" % c["device_ms"] for c in per],
                 ["%.1f" % (c["staged_bytes"] / 1e6) for c in per],
                 ["%.1f" % c["staged_ms"] for c in per],
                 case["staged_calls"], case["device_calls"],
                 case["launches"]))
        check(case["o_err"] <= RING_O_ATOL and
              max(case["grad_rel"]) <= RING_GRAD_REL,
              "ring %s disagrees with %s: O %.3e, grads %s"
              % (tag, case["against"], case["o_err"], case["grad_rel"]))
    ep = reports[0]["ep"]
    print("ep: one MoE layer, x (%d, %d) bf16, %d experts of %d -> %d over "
          "ep=%d: max|d|/max|unsharded| %.3e (limit %.0e), aux err %.3e; "
          "per rank ms %s, host-staged %s MB in %s ms [%s]"
          % (EP_T, EP_D, EP_E, EP_D, EP_H, RING_WORLD, ep["rel_err"],
             EP_REL, ep["aux_err"], ["%.1f" % r["ep"]["ms"] for r in reports],
             ["%.1f" % (r["ep"]["staged_bytes"] / 1e6) for r in reports],
             ["%.1f" % r["ep"]["staged_ms"] for r in reports], card))
    check(all(r["ep"]["finite"] for r in reports), "ep: output not finite")
    check(ep["rel_err"] <= EP_REL and ep["aux_err"] <= 1e-5,
          "ep: the sharded MoE layer disagrees with the unsharded call")
    return (reports[0]["launches"], block, dp_tp_report(reports, card),
            pipeline_report(reports, card), kvstore_report(reports, card))


def dp_tp_report(reports, card):
    """Check and print the dp x tp runs; rank 0's launches."""
    want = reports[0]["dp_tp"]["unsharded"]
    for name, _, zero1, local in DPTP_MESHES:
        per = [rep["dp_tp"]["meshes"][name] for rep in reports]
        losses = [[r["loss"] for r in m["runs"]] for m in per]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[0], want))
        for rep, m in zip(reports, per):
            for i, r in enumerate(m["runs"]):
                tag = "dp_tp %s: rank %d step %d" % (name, rep["rank"], i)
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                    check(r["launches"][k] == DPTP_LAYERS,
                          "%s launched %s %d times, want %d (one a layer)"
                          % (tag, k, r["launches"][k], DPTP_LAYERS))
                check(r["launches"]["multi_adam"] == m["groups"],
                      "%s launched multi_adam %d times, want %d (one a "
                      "dtype group)" % (tag, r["launches"]["multi_adam"],
                                        m["groups"]))
                check(r["heads"] == [list(local)] and
                      r["calls"] == DPTP_LAYERS,
                      "%s: flash called on heads %s (%d calls), want %s"
                      % (tag, r["heads"], r["calls"], local))
            check(all(math.isfinite(x) for x in losses[0]) and
                  all(lo == losses[0] for lo in losses),
                  "dp_tp %s: the ranks' losses differ: %s" % (name, losses))
        run0 = [m["runs"] for m in per]
        print("dp_tp %s (zero1 %s; Llama-3-8B widths, %d layers, B=%d T=%d, "
              "%.3f B params, %d local a rank): losses %s vs unsharded %s "
              "(max rel %.2e, limit %.0e); flash on %d/%d local heads, %d "
              "zero1-split tensors; per step and rank: ms %s, staged MB %s "
              "in ms %s (%s calls) [%s]"
              % (name, zero1, DPTP_LAYERS, DPTP_B, DPTP_T,
                 reports[0]["dp_tp"]["params"] / 1e9,
                 per[0]["local_params"], losses[0], want, rel,
                 DPTP_LOSS_RTOL, local[0], local[1], per[0]["zero1_rows"],
                 [["%.0f" % r["ms"] for r in rr] for rr in run0],
                 [["%.0f" % (r["transport"]["staged_bytes"] / 1e6)
                   for r in rr] for rr in run0],
                 [["%.0f" % r["transport"]["staged_ms"] for r in rr]
                  for rr in run0],
                 [r["transport"]["staged_calls"] for r in run0[0]], card))
        check(rel <= DPTP_LOSS_RTOL,
              "dp_tp %s: the losses differ from the unsharded step's" % name)
    return reports[0]["dp_tp"]["launches"]


def pipeline_report(reports, card):
    """Check and print the pipeline runs; rank 0's launches."""
    for sched, v in PIPE_SCHEDULES:
        per = [rep["pipeline"]["schedules"][sched] for rep in reports]
        r0 = per[0]
        check(all(r["finite"] for r in per) and
              len({r["y_sum"] for r in per}) == 1,
              "pipeline %s: outputs not finite or not replicated" % sched)
        for rep, r in zip(reports, per):
            n = PIPE_M * v
            check(r["launches"]["flash_fwd"] == 2 * n and
                  r["launches"]["flash_bwd_dq"] == n and
                  r["launches"]["flash_bwd_dkv"] == n,
                  "pipeline %s: rank %d launched %s, want %d forwards and "
                  "%d backwards (each stage-microbatch's, recomputed)"
                  % (sched, rep["rank"], r["launches"], 2 * n, n))
        stash = [r["max_live_stash"] for r in per]
        print("pipeline %s (pp=%d, v=%d, %d full-width blocks, B=%d T=%d, "
              "M=%d; %d slots): y %.3e dx %.3e dparams %.3e max|d|/max|ref| "
              "(limit %.0e) vs the blocks in sequence; stage inputs held at "
              "once per rank %s; per rank ms %s, staged MB %s in ms %s "
              "[%s]" % (sched, RING_WORLD, v, RING_WORLD * v, PIPE_B, PIPE_T,
                        PIPE_M, r0["slots"], r0["y_rel"], r0["dx_rel"],
                        r0["dp_rel"], PIPE_REL, stash,
                        ["%.0f" % r["ms"] for r in per],
                        ["%.0f" % (r["transport"]["staged_bytes"] / 1e6)
                         for r in per],
                        ["%.0f" % r["transport"]["staged_ms"] for r in per],
                        card))
        check(max(r0["y_rel"], r0["dx_rel"], r0["dp_rel"]) <= PIPE_REL,
              "pipeline %s disagrees with the blocks in sequence" % sched)
        if sched == "1f1b":
            check(stash == [RING_WORLD - d for d in range(RING_WORLD)],
                  "pipeline 1f1b: stage inputs held %s" % stash)
    return reports[0]["pipeline"]["launches"]


def kvstore_report(reports, card):
    """Check and print the kvstore runs; rank 0's launches."""
    kv0 = reports[0]["kvstore"]
    check(all(rep["kvstore"]["workers"] == [rep["rank"], RING_WORLD]
              for rep in reports), "kvstore: rank / num_workers wrong")
    check(all(all(rep["kvstore"]["pushpull"].values()) for rep in reports),
          "kvstore: a dist_sync pushpull is not the exact sum: %s"
          % [rep["kvstore"]["pushpull"] for rep in reports])
    check(len({rep["kvstore"]["w_sum"] for rep in reports}) == 1,
          "kvstore: the replicas' weights differ after update_on_kvstore")
    check(kv0["w0_equal"], "kvstore: worker 0's weights were not broadcast")
    print("kvstore: dist_sync over %d ranks, pushpull exact (float32, "
          "bf16): %s; Trainer(update_on_kvstore=True) on a full-width FFN, "
          "%d SGD steps, each rank on %d of %d rows: weight change vs one "
          "process on the whole batch ||d||/||ref|| %.3e (limit %.0e); "
          "launches %s; per rank ms %s [%s]"
          % (RING_WORLD, kv0["pushpull"], KV_STEPS, KV_ROWS,
             KV_ROWS * RING_WORLD, kv0["rel"], KV_REL,
             {k: n for k, n in kv0["launches"].items() if n},
             ["%.0f" % rep["kvstore"]["ms"] for rep in reports], card))
    check(kv0["rel"] <= KV_REL, "kvstore: the dist_sync Trainer differs")
    return kv0["launches"]


# ----------------------------------------------------------------------
# phase 17: data, tensor and pipeline parallelism and the kvstore, in
# the ring's rank children (the ranks start once)
# ----------------------------------------------------------------------
# Llama-3-8B widths, depth cut to 2 of 32 layers (each rank first makes
# the whole model from the seed, then keeps its blocks), B=2, T=512.
DPTP_LAYERS, DPTP_B, DPTP_T, DPTP_STEPS = 2, 2, 512, 3
# (name, mesh, zero1, local query / KV heads of the flash calls)
DPTP_MESHES = [("dp2_tp2_zero1", {"dp": 2, "tp": 2}, True, (16, 4)),
               ("tp4", {"tp": 4}, True, (8, 2))]
# The sharded losses against the unsharded step on the same weights:
# the row-parallel products sum bf16 partials over tp (the unsharded
# product rounds once), and dp sums bf16 gradients; 3 AdamW steps
# at lr 1e-4.  1e-2 relative, PARITY_LOSS_RTOL.
DPTP_LOSS_RTOL = PARITY_LOSS_RTOL
# pp=4, one full-width block a stage (v=2 under interleaved: 8 blocks),
# B=4 rows of T=512 in M=4 microbatches; y / dx / dparams against the
# blocks run in sequence on one rank, max|d| / max|ref|: bf16 weights,
# per-microbatch products and bf16 gradient sums over the microbatches.
PIPE_B, PIPE_T, PIPE_M = 4, 512, 4
PIPE_SCHEDULES = [("1f1b", 1), ("interleaved", 2)]
PIPE_REL = GRAD_REL_TOL
# the kvstore: a dist_sync pushpull of exact small integers (every rank
# of the children's world), then a full-width FFN (4096 -> 14336 -> 4096)
# trained 2 SGD steps through a Trainer(update_on_kvstore=True) over
# dist_sync, each rank on its quarter of the batch, against one
# process's Trainer on the whole batch: ||dw - dw_ref|| / ||dw_ref|| of
# the weights' change.  float32 weights: a bf16 weight's change at this
# learning rate is mostly its rounding, which differs between the two
# sums of the same gradient; in float32 only the order of the sums does.
KV_ROWS, KV_T, KV_STEPS = 8, 64, 2
KV_REL = 1e-3


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _record_heads(mt):
    """Wrap the transformer's flash call to record (query heads, KV
    heads) of each call; returns (list, undo)."""
    from mxnet_tpu_torch.models import transformer
    seen, flash = [], transformer.flash_attention

    def recording(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1]))
        return flash(q, k, v, **kw)
    transformer.flash_attention = recording

    def undo():
        transformer.flash_attention = flash
    return seen, undo


def _dtype_groups(params):
    return len({(p.dtype, p.device) for p in params if p.requires_grad})


def dp_tp_rank(mt, parallel, co, comm, dev, rank, cfg=None, B=DPTP_B,
               T=DPTP_T, steps=DPTP_STEPS, meshes=DPTP_MESHES):
    """One rank's dp x tp runs: each mesh's 3 AdamW ``TrainStep(mesh=,
    zero1=)`` steps, every step's loss, launches, flash heads and staged
    bytes; rank 0 then runs the unsharded step on the same weights."""
    import torch.distributed as dist
    cfg = cfg or mt.models.llama3_8b_config(dtype="bfloat16",
                                            n_layers=DPTP_LAYERS)
    V = cfg.vocab_size
    gen = torch.Generator().manual_seed(31)
    toks, labels = (torch.randint(0, V, (B, T), generator=gen).to(dev)
                    for _ in range(2))

    def make():
        net = mt.models.TransformerLM(cfg, device=dev)
        return net.initialize(torch.Generator(device=dev).manual_seed(5),
                              std=0.02)
    heads, undo = _record_heads(mt)
    out = {"meshes": {}, "launches": dict.fromkeys(co.LAUNCHES, 0)}
    for name, sizes, zero1, _ in meshes:
        mesh = parallel.create_mesh(sizes)
        net = make()
        step = parallel.TrainStep(net, None,
                                  mt.optimizer.AdamW(learning_rate=1e-4),
                                  mesh, forward_fn=_lm_loss(mt, net, V),
                                  zero1=zero1)
        runs = []
        for _ in range(steps):
            dist.barrier()
            _sync(dev)
            co.reset_launch_counts()
            comm.reset_transport()
            heads.clear()
            t0 = time.perf_counter()
            loss = step(toks, labels).item()
            _sync(dev)
            runs.append({"loss": loss,
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "launches": dict(co.LAUNCHES),
                         "heads": sorted(set(heads)), "calls": len(heads),
                         "transport": dict(comm.TRANSPORT)})
            for k, n in co.LAUNCHES.items():
                out["launches"][k] += n
        out["meshes"][name] = {
            "runs": runs, "groups": _dtype_groups(net.parameters()),
            "local_params": sum(p.numel() for p in net.parameters()),
            "zero1_rows": sum(1 for r in step._zero.values() if r)}
        del step, net
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    undo()
    dist.barrier()
    if rank == 0:
        net = make()
        step = parallel.TrainStep(net, None,
                                  mt.optimizer.AdamW(learning_rate=1e-4),
                                  forward_fn=_lm_loss(mt, net, V))
        out["unsharded"] = [step(toks, labels).item() for _ in range(steps)]
        out["params"] = net.num_params()
        del step, net
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    return out


def _stacked_block_params(mt, cfg, L, dev, seed):
    """A template TransformerBlock and ``L`` stages of its parameters,
    stacked (leading dimension the stage): weights N(0, 0.02), gains 1."""
    blk = mt.models.TransformerBlock(cfg)
    blk.initialize(mt.init.Zero(), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    stacked = {}
    for name, p in blk.named_parameters():
        if name.endswith("gamma"):
            stacked[name] = torch.ones((L,) + tuple(p.shape), dtype=p.dtype,
                                       device=dev)
        else:
            stacked[name] = (torch.randn((L,) + tuple(p.shape), device=dev,
                                         generator=gen) * 0.02).to(p.dtype)
    return blk, stacked


def pipeline_rank(mt, parallel, co, comm, dev, rank, cfg=None, B=PIPE_B,
                  T=PIPE_T, M=PIPE_M, schedules=PIPE_SCHEDULES):
    """One rank's ``pipeline_vjp`` over pp=4 for each schedule, one
    transformer block a stage; rank 0 holds y / dx / dparams against the
    blocks in sequence."""
    import torch.distributed as dist
    from torch.func import functional_call
    from mxnet_tpu_torch.parallel import pipeline
    cfg = cfg or mt.models.llama3_8b_config(dtype="bfloat16")
    mesh = parallel.create_mesh(pp=RING_WORLD)
    gen = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn(B, T, cfg.dim, device=dev, generator=gen)
    gy = torch.randn(B, T, cfg.dim, device=dev, generator=gen)
    out = {"schedules": {}, "launches": dict.fromkeys(co.LAUNCHES, 0)}
    for sched, v in schedules:
        blk, stacked = _stacked_block_params(mt, cfg, RING_WORLD * v, dev,
                                             43 + v)

        def stage(p, a):
            return functional_call(blk, p, (a,))
        dist.barrier()
        _sync(dev)
        co.reset_launch_counts()
        comm.reset_transport()
        t0 = time.perf_counter()
        y, dx, dps = parallel.pipeline_vjp(stage, stacked, x, gy, mesh, M,
                                           schedule=sched, virtual_stages=v)
        _sync(dev)
        rec = {"v": v, "ms": (time.perf_counter() - t0) * 1e3,
               "launches": dict(co.LAUNCHES),
               "transport": dict(comm.TRANSPORT),
               "max_live_stash": pipeline.LAST["max_live_stash"],
               "slots": pipeline.LAST["slots"],
               "y_sum": y.double().sum().item(),
               "finite": bool(torch.isfinite(y).all() and
                              torch.isfinite(dx).all())}
        for k, n in co.LAUNCHES.items():
            out["launches"][k] += n
        if rank == 0:
            params = {k: t.detach().requires_grad_()
                      for k, t in stacked.items()}
            xr = x.detach().requires_grad_()
            h = xr
            for s in range(RING_WORLD * v):
                h = stage({k: t[s] for k, t in params.items()}, h)
            grads = torch.autograd.grad(h, [xr] + list(params.values()), gy)

            def rel(a, b):
                return ((a.float() - b.float()).abs().max() /
                        b.float().abs().max()).item()
            rec["y_rel"] = rel(y, h.detach())
            rec["dx_rel"] = rel(dx, grads[0])
            rec["dp_rel"] = max(rel(dps[k], g) for k, g in
                                zip(params, grads[1:]))
            del params, xr, h, grads
        out["schedules"][sched] = rec
        del blk, stacked, y, dx, dps
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.barrier()
    return out


def kvstore_rank(mt, co, dev, rank, world, cfg=None, rows=KV_ROWS, T=KV_T,
                 steps=KV_STEPS):
    """One rank's kvstore run: dist_sync pushpulls of exact integers,
    then a full-width FFN trained through ``Trainer(update_on_kvstore=
    True)`` over dist_sync; rank 0 trains the same FFN in one process on
    the whole batch."""
    import torch.distributed as dist
    cfg = cfg or mt.models.llama3_8b_config()
    cfg = mt.models.LlamaConfig(**dict(vars(cfg), dtype="float32"))
    out = {"launches": dict.fromkeys(co.LAUNCHES, 0), "pushpull": {}}
    kv = mt.kv.create("dist_sync")
    out["workers"] = [kv.rank, kv.num_workers]
    base = torch.arange(4096 * 3, device=dev).reshape(3, 4096) % 7
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt)
        kv.init(key, mt.nd.NDArray(torch.zeros(3, 4096, dtype=dt,
                                               device=dev)))
        o = mt.nd.NDArray(torch.zeros(3, 4096, dtype=dt, device=dev))
        kv.pushpull(key, mt.nd.NDArray((base + rank).to(dt)), out=o)
        want = (base * world + sum(range(world))).to(dt)
        out["pushpull"][key] = bool(torch.equal(o._data, want))
    gen = torch.Generator().manual_seed(51)
    x = torch.randn(rows * world, T, cfg.dim, generator=gen).to(dev)
    n_total = x.shape[0] * T * cfg.dim

    def ffn(seed):
        f = mt.models.transformer.FeedForward(cfg)
        return f.initialize(mt.init.Normal(0.02), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(seed))

    def train(f, kvstore, xs):
        tr = mt.gluon.Trainer(f.collect_params(), "sgd",
                              {"learning_rate": 0.5, "momentum": 0.9},
                              kvstore=kvstore,
                              update_on_kvstore=kvstore is not None)
        if kvstore is not None:
            tr._init_kvstore()      # worker 0's weights to every rank
        w0 = {k: p.detach().float().clone()
              for k, p in f.collect_params().items()}
        for _ in range(steps):
            with mt.autograd.record():
                loss = f(xs).float().square().sum() / n_total
            loss.backward()
            tr.step(1)
        return {k: p.detach().float() - w0[k]
                for k, p in f.collect_params().items()}, w0
    dist.barrier()
    _sync(dev)
    co.reset_launch_counts()
    t0 = time.perf_counter()
    f = ffn(60 + rank)              # other weights on every rank
    delta, w0 = train(f, "dist_sync", x[rank * rows:(rank + 1) * rows])
    _sync(dev)
    out["ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = dict(co.LAUNCHES)
    out["w_sum"] = sum(p.detach().double().sum().item()
                       for p in f.parameters())
    if rank == 0:
        ref = ffn(60)
        ref_delta, ref_w0 = train(ref, None, x)
        out["w0_equal"] = all(torch.equal(w0[k], ref_w0[k]) for k in w0)
        out["rel"] = max(((delta[k] - ref_delta[k]).norm() /
                          ref_delta[k].norm()).item() for k in delta)
        del ref
    del f
    gc.collect()
    dist.barrier()
    return out


# ----------------------------------------------------------------------
# phase 16: the MoE LM at full width, remat, checkpoints
# ----------------------------------------------------------------------
MOE_LAYERS, MOE_EXPERTS = 4, 8
MOE_AUX_WEIGHT = 0.01
# remat recomputes the same forward kernels; the backward's sums may
# run in another order, so the losses of steps 2-3 to 1e-3 relative
# (measured on an H100: bitwise equal; the kernels have no atomics)
REMAT_LOSS_RTOL = 1e-3


def _lm_loss(mt, net, V, aux_weight=0.0):
    loss_fn = mt.gluon.loss.SoftmaxCELoss()

    def fwd(model, tokens, lab):
        logits = model(tokens).float()
        loss = loss_fn(logits.reshape(-1, V), lab.reshape(-1)).mean()
        return loss + aux_weight * model.moe_aux_loss() if aux_weight \
            else loss
    return fwd


def _router_margins(mt, net, tokens):
    """The top-1 router margin of every token at each MoE block."""
    seen = []

    def hook(mod, args):
        x = args[0].detach().reshape(-1, args[0].shape[-1]).double()
        top = (x @ mod.gate.detach().double()).sort(-1).values
        seen.append(top[:, -1] - top[:, -2])
    hooks = [blk.feed_forward.register_forward_pre_hook(hook)
             for blk in net.layers
             if isinstance(blk.feed_forward, mt.models.MoEFeedForward)]
    with torch.no_grad():
        net(tokens)
    for h in hooks:
        h.remove()
    return torch.cat(seen)


def moe_phase(mt, co, dev, card, B=2, T=1024):
    """``llama3_8b_config(n_layers=4, moe_num_experts=8, moe_every=2)``:
    3 AdamW ``TrainStep`` steps at B=2, T=1024 of CE + 0.01 x the aux
    loss; then a float32 ``tiny_config`` MoE, card against CPU."""
    cfg = mt.models.llama3_8b_config(dtype="bfloat16", n_layers=MOE_LAYERS,
                                     moe_num_experts=MOE_EXPERTS, moe_every=2)
    net = mt.models.TransformerLM(cfg, device=dev)
    net.initialize(torch.Generator(device=dev).manual_seed(0), std=0.02)
    V = cfg.vocab_size
    print("moe model: llama3_8b_config widths, %d layers, %d experts every "
          "2nd layer (layers 0, 2), %.3f B params"
          % (MOE_LAYERS, MOE_EXPERTS, net.num_params() / 1e9))
    gen = torch.Generator(device=dev).manual_seed(8)
    toks, labels = (torch.randint(0, V, (B, T), device=dev, generator=gen)
                    for _ in range(2))
    fwd = _lm_loss(mt, net, V, MOE_AUX_WEIGHT)
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
    launches = dict(co.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    aux = net.moe_aux_loss().item()
    check(all(math.isfinite(x) for x in losses) and math.isfinite(aux),
          "moe: a loss is not finite: %s, aux %s" % (losses, aux))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == 3 * MOE_LAYERS,
              "moe: %s launched %d times in 3 steps, want %d per step"
              % (name, launches[name], MOE_LAYERS))
    check_opt_launches("moe", launches, "multi_adam", 3, net.parameters())
    ms, dev_ms, top, _, _ = device_busy(lambda: step(toks, labels).item(),
                                        reps=1)
    print("moe train (B=%d, T=%d): losses %s (CE + %.2f x aux; aux %.4f), "
          "%.1f ms a step host (3 in %.2f s), %.1f ms of kernels (device "
          "busy %.1f%%), %.0f tokens/s, peak memory %.2f GB; top kernels "
          "(ms a step): %s [%s]"
          % (B, T, losses, MOE_AUX_WEIGHT, aux, ms, wall3, dev_ms,
             100 * dev_ms / ms, B * T / ms * 1e3, peak / 1e9,
             "; ".join("%s %.3f" % t for t in top), card))
    del step, net
    gc.collect()
    torch.cuda.empty_cache()

    # the float32 tiny MoE, card against CPU: logits, aux and grads
    tcfg = mt.models.tiny_config(moe_num_experts=4, n_layers=3)
    nets = {"cuda": mt.models.TransformerLM(tcfg, device=dev).initialize(
        torch.Generator(device=dev).manual_seed(1), std=0.1)}
    nets["cpu"] = mt.convert.load_params(
        mt.models.TransformerLM(tcfg, device="cpu"),
        mt.convert.export_params(nets["cuda"]))
    t = torch.randint(0, tcfg.vocab_size, (2, 48),
                      generator=torch.Generator().manual_seed(9))
    margin = _router_margins(mt, nets["cpu"], t).min().item()
    check(margin > 1e-4, "moe tiny: a token's router margin is %.2e: "
          "routing could flip between devices" % margin)
    out = {}
    with exact_fp32():
        for name, d in (("cuda", dev), ("cpu", "cpu")):
            n = nets[name]
            logits = n(t.to(d))
            aux_t = n.moe_aux_loss()
            (logits.float().square().mean() + aux_t).backward()
            out[name] = (logits.detach().cpu(), aux_t.item(),
                         [p.grad.cpu() for p in n.parameters()])
    lrel = _rel(out["cuda"][0], out["cpu"][0])
    grel = max(_rel(a, b) for a, b in zip(out["cuda"][2], out["cpu"][2]))
    arel = abs(out["cuda"][1] - out["cpu"][1]) / abs(out["cpu"][1])
    print("moe tiny_config float32 card vs CPU: logits ||d||/||cpu|| %.2e, "
          "aux %.2e, max grad %.2e (limit %.0e); min router margin %.3e"
          % (lrel, arel, grel, TINY_GRAD_REL, margin))
    check(max(lrel, arel, grel) <= TINY_GRAD_REL,
          "moe tiny: card and CPU differ")
    return launches


def remat_phase(mt, co, dev, card, B=2, T=1024):
    """The 8-layer LM step with ``remat=True`` against ``remat=False``,
    on the same weights: 3 AdamW steps each, losses, peak memory and
    step time."""
    runs = {}
    for remat in (False, True):
        net = build_model(mt, dev, TRAIN_LAYERS)
        V = net.cfg.vocab_size
        gen = torch.Generator(device=dev).manual_seed(7)
        toks, labels = (torch.randint(0, V, (B, T), device=dev,
                                      generator=gen) for _ in range(2))
        step = mt.parallel.TrainStep(net, None,
                                     mt.optimizer.AdamW(learning_rate=1e-3),
                                     forward_fn=_lm_loss(mt, net, V),
                                     remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        co.reset_launch_counts()
        losses = []
        t0 = time.monotonic()
        for _ in range(3):
            losses.append(step(toks, labels).item())
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3 / 3
        runs[remat] = (losses, ms, torch.cuda.max_memory_allocated(),
                       dict(co.LAUNCHES))
        del step, net
        gc.collect()
        torch.cuda.empty_cache()
    (l0, ms0, p0, _), (l1, ms1, p1, launches) = runs[False], runs[True]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l1, l0))
    print("remat: %d layers B=%d T=%d, losses plain %s remat %s (max rel "
          "diff %.2e, limit %.0e); step %.1f ms -> %.1f ms, peak memory "
          "%.2f GB -> %.2f GB [%s]" % (TRAIN_LAYERS, B, T, l0, l1, rel,
                                       REMAT_LOSS_RTOL, ms0, ms1, p0 / 1e9,
                                       p1 / 1e9, card))
    check(l0[0] == l1[0] and rel <= REMAT_LOSS_RTOL,
          "remat: the losses differ from the plain step's")
    # the forward runs twice a step: once, then again in the backward
    check(launches["flash_fwd"] == 2 * 3 * TRAIN_LAYERS and
          launches["flash_bwd_dq"] == 3 * TRAIN_LAYERS,
          "remat: launches %s" % launches)
    return launches


def checkpoint_phase(mt, co, dev, card):
    """A small MoE model on the card: save at step 2, restore into a
    fresh step over other weights; steps 3-4 equal the uninterrupted
    run's bit for bit, and so do the weights."""
    import tempfile
    cfg = mt.models.tiny_config(moe_num_experts=4, n_layers=3, dim=256,
                                n_heads=4, n_kv_heads=2, hidden_dim=512,
                                dtype="bfloat16")
    gen = torch.Generator().manual_seed(10)
    toks, labels = (torch.randint(0, cfg.vocab_size, (2, 64),
                                  generator=gen).to(dev) for _ in range(2))

    def make(seed):
        net = mt.models.TransformerLM(cfg, device=dev).initialize(
            torch.Generator(device=dev).manual_seed(seed), std=0.05)
        return net, mt.parallel.TrainStep(
            net, None, mt.optimizer.AdamW(learning_rate=1e-2),
            forward_fn=_lm_loss(mt, net, cfg.vocab_size, MOE_AUX_WEIGHT))
    co.reset_launch_counts()
    net, step = make(0)
    whole = [step(toks, labels).item() for _ in range(4)]
    with tempfile.TemporaryDirectory(prefix="mx_ckpt_") as d:
        net_a, step_a = make(0)
        for _ in range(2):
            step_a(toks, labels)
        step_a.save_checkpoint(d)
        net_b, step_b = make(1)
        step_b.load_checkpoint(d)
        resumed = [step_b(toks, labels).item() for _ in range(2)]
    torch.cuda.synchronize()
    launches = dict(co.LAUNCHES)
    same = all(torch.equal(a, b) for a, b in zip(net.parameters(),
                                                   net_b.parameters()))
    print("checkpoint: losses uninterrupted %s, resumed at step 2 %s; "
          "weights after step 4 equal: %s [%s]"
          % (whole, resumed, same, card))
    check(resumed == whole[2:] and same,
          "checkpoint: the resumed run differs from the uninterrupted one")
    return launches


# ----------------------------------------------------------------------
# phase 18: the serving control plane on the full-width server
# ----------------------------------------------------------------------
TP_MAX_NEW = 16
# a greedy token of two bf16 paths may differ from the exact one by up
# to SERVED_LOGIT_TOL each, so a flip between the tensor-parallel and the
# one-rank server is allowed only where the one-rank run's top-2 logit
# gap is at most twice that
TP_TIE_MARGIN = 2 * SERVED_LOGIT_TOL


def make_tp_requests(vocab, seed=5):
    """8 greedy requests, prompts of 20..500 tokens."""
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randint(1, vocab, (n,), generator=gen).tolist(), None)
            for n in (20, 48, 97, 130, 200, 255, 380, 500)]


def serve_requests(srv, reqs, max_new, timeout=600):
    """Every request through a started-and-stopped ``srv``: (results,
    wall s)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with srv:
        rids = [srv.submit(p, max_new=max_new, sampling=sp) for p, sp in reqs]
        res = [srv.result(r, timeout=timeout) for r in rids]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for r in res:
        check(r is not None and r["state"] == "done"
              and len(r["tokens"]) == max_new,
              "request did not complete: %r" % (r and r.get("state"),))
    return res, wall


def _ttft_p50(res):
    ttft = sorted(r["t_first"] - r["t_submit"] for r in res)
    return 1e3 * ttft[len(ttft) // 2]


def _cold_scheduler(mt, srv):
    """A fresh scheduler (an empty prefix cache) on ``srv``'s warm pool:
    the same prompts served twice would otherwise hit the cache the
    first run filled and prefill through the chunk program the second
    time, so two runs compare prefill for prefill."""
    spec = srv.pool.spec
    srv.sched = mt.serve.SlotScheduler(
        spec.slots, spec.pages, spec.page_size, spec.max_pages_per_slot,
        prefix_cache=srv.cfg.prefix_cache, ladder=srv.cfg.ladder)


def control_plane_phase(mt, co, net, srv, reqs, res, wall, card):
    """The control plane on the bf16 Llama-3-8B-width server of
    ``serve_phase``: its telemetry gauges and SLO sketches, a transient
    decode fault, an elastic drain, a two-replica ``ReplicaGroup`` with
    one engine killed, the flight recorder; returns the tensor-parallel
    phase's requests and their one-rank greedy tokens (the fault-free
    control run)."""
    import types
    from mxnet_tpu_torch import fault, flightrec, profiler, telemetry
    from mxnet_tpu_torch.serve_router import ReplicaGroup
    fault.clear()
    # room for every event of the phase (the default ring keeps 4096)
    flightrec.configure(capacity=1 << 16)
    sess = srv.attach_telemetry(telemetry.TelemetrySession())
    gauges = {k: v for k, v in sess.payload()["full"].items()
              if k in ("serve::queue_depth", "serve::running",
                       "serve::free_pages")}
    check(len(gauges) == 3, "control: gauges %s" % gauges)
    slo = srv.slo_snapshot()
    check(slo["latency_ms"]["count"] == len(res), "control: SLO counted "
          "%d of %d requests" % (slo["latency_ms"]["count"], len(res)))
    print("control: gauges %s; SLO over %d requests: latency p50/p95/p99 "
          "%.1f/%.1f/%.1f ms, TTFT p50/p95/p99 %.1f/%.1f/%.1f ms, queued "
          "p50/p95/p99 %.1f/%.1f/%.1f ms (sketch buckets: 12%% wide), "
          "tokens/s in decode %.1f; serve phase's own TTFT p50 %.1f ms [%s]"
          % (gauges, slo["latency_ms"]["count"],
             *(slo[k][p] for k in ("latency_ms", "ttft_ms", "queued_ms")
               for p in ("p50", "p95", "p99")), slo["tokens_per_s"],
             _ttft_p50(res), card))
    # the hooks cost: the same 16 requests again, gauges and an elastic
    # runner attached (never fired), profiler off
    runner = types.SimpleNamespace(on_resize=None)
    srv.attach_elastic(runner)
    hooked, hwall = serve_requests(srv, [(p, sp) for p, sp in reqs], 32)
    ntok = sum(len(r["tokens"]) for r in res)
    print("control: %d requests, %d tokens: %.1f tokens/s with the gauges "
          "and the elastic hook attached, against %.1f tokens/s of the "
          "serve phase in this run (the scheduler's flight-recorder and "
          "counter hooks are on in both; every hook is host Python "
          "between graph replays) [%s]"
          % (len(reqs), ntok, ntok / hwall, ntok / wall, card))
    # the fault-free control run of the tensor-parallel requests
    tp_reqs = make_tp_requests(net.cfg.vocab_size)
    _cold_scheduler(mt, srv)
    control, _ = serve_requests(srv, tp_reqs, TP_MAX_NEW)
    want = [list(r["tokens"]) for r in control]
    # a transient decode failure mid-run: the step is dropped and replayed
    _cold_scheduler(mt, srv)
    before = profiler.get_counter("serve::decode_retries")
    fault.inject("serve_decode_fail", at=6)
    faulted, _ = serve_requests(srv, tp_reqs, TP_MAX_NEW)
    fault.clear()
    retries = profiler.get_counter("serve::decode_retries") - before
    check(retries == 1, "control: %d decode retries, want 1" % retries)
    check([list(r["tokens"]) for r in faulted] == want, "control: the "
          "tokens after a transient decode fault differ from the "
          "fault-free run")
    print("control: serve_decode_fail at the 6th decode commit: 1 retry "
          "(serve::decode_retries), the 8 requests' %d tokens equal the "
          "fault-free run's bit for bit" % sum(map(len, want)))
    # an elastic resize fired mid-decode: every slot drained and
    # re-prefilled
    fired = {"n": 0}

    def on_decode(info):
        fired["n"] += 1
    runner = types.SimpleNamespace(on_resize=on_decode)
    _cold_scheduler(mt, srv)
    srv.attach_elastic(runner)
    torch.cuda.synchronize()
    with srv:
        rids = [srv.submit(p, max_new=TP_MAX_NEW) for p, _ in tp_reqs]
        t0 = time.monotonic()
        while srv.sched.stats()["running"] < 4 \
                and time.monotonic() - t0 < 60:
            time.sleep(0.001)
        drained_before = profiler.get_counter("serve::elastic_drains")
        runner.on_resize(types.SimpleNamespace(gen=2, world=2))
        drained = profiler.get_counter("serve::elastic_drains") \
            - drained_before
        mid = (srv.sched.check_conservation(), srv.sched.check_refcounts())
        elastic = [srv.result(r, timeout=600) for r in rids]
    check(fired["n"] == 1 and drained >= 1, "control: the elastic hook "
          "drained %d slot(s), chained hook fired %d" % (drained,
                                                          fired["n"]))
    check(mid == ([], []) and srv.sched.check_conservation() == []
          and srv.sched.check_refcounts() == [],
          "control: conservation / refcounts after the drain %s" % (mid,))
    check(all(r["state"] == "done" and len(r["tokens"]) == TP_MAX_NEW
              for r in elastic), "control: a drained request did not "
          "complete with its budget")
    same = sum(list(r["tokens"]) == w for r, w in zip(elastic, want))
    print("control: elastic drain mid-decode: %d slot(s) drained, every "
          "request completed with its %d tokens, conservation and "
          "refcounts clean; %d of %d requests' tokens equal the fault-free "
          "run's bit for bit (a drained request re-prefills its tail "
          "through the flash forward, not the decode's products)"
          % (drained, TP_MAX_NEW, same, len(want)))
    consistency_phase(net, tp_reqs, elastic, net.output.weight.device,
                      tag="consistency elastic")
    # two replicas over the same net (own pools and graphs), one killed
    group = ReplicaGroup.build(net, serve_cfg=srv.cfg, replicas=2)
    with group:
        gids = [group.submit(p, max_new=TP_MAX_NEW) for p, _ in tp_reqs]
        t0 = time.monotonic()
        while time.monotonic() - t0 < 60:
            live = {r["replica"] for r in group.requests().values()
                    if r["state"] == "inflight"}
            if {0, 1} <= live:
                break
            time.sleep(0.001)
        fault.inject("serve_engine_kill", at=1)
        routed = [group.result(g, timeout=600) for g in gids]
    fault.clear()
    ledger = group.delivery_log()
    stats = group.stats()
    check(len(ledger) == len(gids) and len({g for g, _ in ledger})
          == len(gids), "control: delivery ledger %s" % (ledger,))
    check([list(r["tokens"]) for r in routed] == want, "control: the "
          "failed-over tokens differ from the fault-free run")
    check(len(stats["dead"]) == 1, "control: replicas dead %s"
          % (stats["dead"],))
    print("control: ReplicaGroup of 2 replicas, serve_engine_kill on one: "
          "dead %s, %d failover(s), %d deliveries for %d requests (each "
          "once), tokens equal the fault-free run's bit for bit"
          % (stats["dead"], stats["failovers"], len(ledger), len(gids)))
    del group
    gc.collect()
    torch.cuda.empty_cache()
    import tempfile
    events = flightrec.events()
    kinds = sorted({e["kind"] for e in events})
    with tempfile.TemporaryDirectory(prefix="mx_flightrec_") as d:
        path = flightrec.dump(os.path.join(d, "flightrec.rank0.json"),
                              reason="chip_smoke")
        with open(path) as f:
            dumped = json.load(f)
    check(dumped["flightrec"]["seq"] >= len(events) and "serve.decode_retry"
          in kinds and "router.failover" in kinds, "control: flight "
          "recorder kinds %s" % kinds)
    print("control: flight recorder holds %d events (%d recorded, ring of "
          "%d), kinds %s; its dump parses (%d events, %d counters)"
          % (len(events), dumped["flightrec"]["seq"],
             dumped["flightrec"]["capacity"], kinds,
             len(dumped["flightrec"]["events"]), len(dumped["counters"])))
    return tp_reqs, want


# ----------------------------------------------------------------------
# phase 19: tensor-parallel serving over ranks
# ----------------------------------------------------------------------
SERVE_TP_LAYERS = 32
SERVE_TP_TIMEOUT_S = 600


def _eager_program(pool, which):
    """Run a pool program's captured function eagerly (both ranks of a
    tensor-parallel replica, as a plan)."""
    program = pool._decode if which == "decode" else pool._prefill[512]
    with torch.no_grad():
        program.fn()
    return (pool._dec_out if which == "decode" else pool._pre_out).cpu()


def _tp_step_inputs(pool, reqs, res):
    import numpy as onp
    S, MP = pool.spec.slots, pool.spec.max_pages_per_slot
    table = onp.arange(1, 1 + S * MP, dtype=onp.int32).reshape(S, MP)
    lengths = onp.array([min(len(p) + TP_MAX_NEW, MP * 128 - 1)
                         for p, _ in reqs[:S]], onp.int32)
    tokens = onp.array([r["tokens"][-1] for r in res[:S]], onp.int32)
    prompt = onp.asarray(reqs[-1][0], onp.int32)          # 500 tokens
    padded = onp.zeros(512, onp.int32)
    padded[:len(prompt)] = prompt
    row = onp.arange(41, 41 + MP, dtype=onp.int32)
    return ({"page_table": table, "lengths": lengths, "tokens": tokens,
             "active": onp.ones(S, bool)},
            {"tokens_padded": padded, "page_row": row,
             "true_len": len(prompt)})


def serve_tp_rank(rank, out_dir, backend, world):
    """One rank of the tensor-parallel serving phase (``chip_smoke.py
    --serve-tp-rank R DIR BACKEND WORLD``): the Llama-3-8B-width model
    from ``build_model``'s seed, a ``Server(mesh=create_mesh(tp=WORLD))``
    in bf16 and int8 serving the 8 requests; rank 0, the leader, times
    the decode and prefill programs and (NCCL: graphs) holds each
    graph's replay against its eager function; a JSON report into DIR.
    Rank r runs on card r % device_count."""
    import torch.distributed as dist
    if backend == "nccl":
        # a collective's buffers are pool allocations of the graph that
        # holds it: no cross-stream record on them
        os.environ.setdefault("TORCH_NCCL_AVOID_RECORD_STREAMS", "1")
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(out_dir, "store"),
                                      world), rank=rank, world_size=world)
    mt, parallel, co, comm = ring_rank_modules()
    from mxnet_tpu_torch import serve
    mesh = parallel.create_mesh(tp=world)
    dev = mesh.device
    net = build_model(mt, dev, SERVE_TP_LAYERS)
    report = {"rank": rank, "device": str(dev), "backend": mesh.backend,
              "weights_sum": float(net.output.weight.detach().double()
                                   .sum()),
              "runs": {}}
    reqs = make_tp_requests(net.cfg.vocab_size)
    checks = []

    def replay_vs_eager(pool, which, args):
        program = {"decode": pool._decode, "prefill": pool._prefill[512],
                   "chunk": pool._chunk[256]}[which]
        run = (lambda: pool.run_decode(**args)) if which == "decode" \
            else (lambda: pool.run_prefill(**args))
        ok = _replay_vs_eager(pool, program, run)
        checks.append((which, ok))
        return ok
    serve._RUN["replay_vs_eager"] = replay_vs_eager
    serve._RUN["eager"] = _eager_program
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        scfg = mt.serve.ServeConfig(slots=8, page_size=128, pages=64,
                                    ladder=(128, 256, 512),
                                    max_new=TP_MAX_NEW, int8=int8)
        dist.barrier()
        t0 = time.monotonic()
        srv = serve.Server(net, scfg, mesh=mesh)
        run = {"init_s": time.monotonic() - t0,
               "stats": dict(srv.pool.stats),
               "pool_heads": int(srv.pool.k_pages.shape[2]),
               "local_params": sum(p.numel() for p in net.parameters())}
        checks.clear()
        co.reset_launch_counts()
        comm.reset_transport()
        if srv.leader:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            srv.start()
            rids = [srv.submit(p, max_new=TP_MAX_NEW) for p, _ in reqs]
            res = [srv.result(r, timeout=SERVE_TP_TIMEOUT_S) for r in rids]
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            run["launches"] = dict(co.LAUNCHES)
            run["transport"] = dict(comm.TRANSPORT)
            run["tokens"] = [list(r["tokens"]) for r in res]
            run["states"] = [r["state"] for r in res]
            run["wall_s"] = wall
            run["ttft_p50_ms"] = _ttft_p50(res)
            dec, pre = _tp_step_inputs(srv.pool, reqs, res)
            if srv.pool.stats["programs"]:
                # each graph against its eager function first: the timed
                # runs below rewrite the same K / V into the same pages
                chunk = dict(pre, tokens_padded=pre["tokens_padded"][:256]
                             .copy(), true_len=44, start=256)
                # another prompt's tokens after the 256 cached ones, so
                # the chunk writes K / V the prefill did not
                chunk["tokens_padded"][:] = 0
                chunk["tokens_padded"][:44] = reqs[-2][0][:44]
                for which, args in (("decode", dec), ("prefill", pre),
                                    ("chunk", chunk)):
                    srv._run("replay_vs_eager", which=which, args=args)
            # the programs one at a time, plans to the followers first
            for name, kind, args, reps in (
                    ("decode", "decode", dec, 5),
                    ("decode eager", "eager", {"which": "decode"}, 5),
                    ("prefill 512", "prefill", pre, 2),
                    ("prefill 512 eager", "eager", {"which": "prefill"},
                     2)):
                out = srv._run(kind, **args)
                torch.cuda.synchronize()
                comm.reset_transport()
                t0 = time.perf_counter()
                for _ in range(reps):
                    out = srv._run(kind, **args)
                    if isinstance(out, torch.Tensor):
                        out = out.cpu()
                torch.cuda.synchronize()
                run[name] = {"ms": (time.perf_counter() - t0) * 1e3 / reps,
                             "staged_bytes": comm.TRANSPORT["staged_bytes"]
                             / reps,
                             "staged_calls": comm.TRANSPORT["staged_calls"]
                             / reps,
                             "device_calls": comm.TRANSPORT["device_calls"]
                             / reps}
            srv.stop()
        else:
            srv.start()
            srv.stop()          # returns at the leader's stop plan
            run["launches"] = dict(co.LAUNCHES)
            run["transport"] = dict(comm.TRANSPORT)
        run["replay_vs_eager"] = list(checks)
        report["runs"][tag] = run
        del srv
        gc.collect()
        torch.cuda.empty_cache()
    report["imported_jax"] = any(m.split(".")[0] in ("jax", "jaxlib",
                                                     "mxnet_tpu")
                                 for m in sys.modules)
    dump_json(os.path.join(out_dir, "rank%d.json" % rank), report)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _tp_gaps(net, reqs, tokens, dev, int8_layers=None):
    """The one-rank teacher-forced top-2 logit gap at every generated
    position of each request."""
    from mxnet_tpu_torch.contrib.quantization import int8_weights
    gaps = []
    with torch.no_grad(), int8_weights(int8_layers or {}, "prefill"):
        for (prompt, _), toks in zip(reqs, tokens):
            seq = torch.tensor([prompt + toks[:-1]], device=dev)
            logits = net(seq)[0, len(prompt) - 1:].float()
            top2 = logits.topk(2, dim=-1).values
            gaps.append((top2[:, 0] - top2[:, 1]).tolist())
    return gaps


def serve_tp_phase(mt, co, net, dev, card, reqs, one_rank, backend="gloo",
                   world=2):
    """Tensor-parallel serving over ``world`` ranks (gloo ranks sharing
    the one card, or NCCL ranks one a card with ``--ring-nccl``): the
    leader's tokens against the one-rank server's (``one_rank``: {"bf16":
    tokens, "int8": tokens}) wherever the one-rank top-2 gap exceeds
    TP_TIE_MARGIN, and through the teacher-forced forward
    (``consistency_phase``); per-rank figures; returns rank 0's serving
    launches {"bf16": ..., "int8": ...}."""
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mx_serve_tp_") as out_dir:
        wall = _run_ranks(out_dir, backend, world, "--serve-tp-rank")
        reports = []
        for r in range(world):
            with open(os.path.join(out_dir, "rank%d.json" % r)) as f:
                reports.append(json.load(f))
    tag0 = "serve_tp %s tp=%d" % (backend, world)
    check(not any(rep["imported_jax"] for rep in reports),
          "%s: a rank child imported JAX" % tag0)
    ref_sum = float(net.output.weight.detach().double().sum())
    check(all(rep["weights_sum"] == ref_sum for rep in reports),
          "%s: the ranks' weights differ from this process's" % tag0)
    print("%s: %d ranks on %s, %d layers of Llama-3-8B width; %.1f s in "
          "all, model build and rank start-up included [%s]"
          % (tag0, world, ", ".join(sorted({r["device"] for r in reports})),
             SERVE_TP_LAYERS, wall, card))
    out = {}
    int8_layers = None
    for tag in ("bf16", "int8"):
        lead = reports[0]["runs"][tag]
        tokens = lead["tokens"]
        check(all(s == "done" for s in lead["states"])
              and all(len(t) == TP_MAX_NEW for t in tokens),
              "%s %s: requests did not complete" % (tag0, tag))
        stats = lead["stats"]
        graphs = backend == "nccl"
        on_card = reports[0]["device"].startswith("cuda")
        check(stats["programs"] == (1 + 2 * 3 if graphs else 0)
              and (stats["eager"] is not None) == (on_card and not graphs),
              "%s %s: programs %s" % (tag0, tag, stats))
        for rep in reports:
            run = rep["runs"][tag]
            kernels = ("flash_fwd", "paged_decode") + (
                ("int8_linear", "int8_dequant") if tag == "int8" else ())
            check(all(run["launches"][k] > 0 for k in kernels),
                  "%s %s rank %d: a kernel of the path was not launched: %s"
                  % (tag0, tag, rep["rank"], run["launches"]))
            check(len(run["replay_vs_eager"]) == (3 if graphs else 0)
                  and all(ok for _, ok in run["replay_vs_eager"]),
                  "%s %s rank %d: a graph's replay differs from its eager "
                  "function" % (tag0, tag, rep["rank"]))
        if tag == "int8":
            int8_layers = mt.serve._int8_layers(net)
        gaps = _tp_gaps(net, reqs, one_rank[tag], dev, int8_layers)
        equal = flips = 0
        for i, (got, want) in enumerate(zip(tokens, one_rank[tag])):
            for pos, (a, b) in enumerate(zip(got, want)):
                if a != b:
                    flips += 1
                    check(gaps[i][pos] <= TP_TIE_MARGIN,
                          "%s %s request %d position %d: token %d against "
                          "the one-rank %d where its top-2 gap is %.4f "
                          "(margin %.2f)" % (tag0, tag, i, pos, a, b,
                                             gaps[i][pos], TP_TIE_MARGIN))
                    break
                equal += 1
        consistency_phase(net, reqs, [{"tokens": t} for t in tokens], dev,
                          int8_layers if tag == "int8" else None,
                          tag="consistency %s %s" % (tag0, tag))
        ntok = sum(map(len, tokens))
        print("%s %s: %d requests, %d tokens in %.3f s = %.1f tokens/s, "
              "TTFT p50 %.1f ms; programs %d%s%s; %d positions equal the "
              "one-rank server's, %d request(s) part at a near-tie (top-2 "
              "gap <= %.2f) [%s]"
              % (tag0, tag, len(tokens), ntok, lead["wall_s"],
                 ntok / lead["wall_s"], lead["ttft_p50_ms"],
                 stats["programs"], " (eager: %s)" % stats["eager"]
                 if stats["eager"] else "", "; every rank's decode, "
                 "prefill 512 and chunk 256 replays equal their eager "
                 "functions bit for bit" if graphs else "", equal, flips,
                 TP_TIE_MARGIN,
                 card))
        for name in ("decode", "decode eager", "prefill 512",
                     "prefill 512 eager"):
            t = lead[name]
            print("%s %s %s: %.2f ms (leader, plans to the followers "
                  "included), staged %.2f MB in %.1f calls, %.1f device "
                  "calls a step [%s]"
                  % (tag0, tag, name, t["ms"], t["staged_bytes"] / 1e6,
                     t["staged_calls"], t["device_calls"], card))
        for rep in reports:
            run = rep["runs"][tag]
            print("%s %s rank %d: KV heads %d, %.3f G local params, pool "
                  "init %.2f s; launches %s %s; transport %s"
                  % (tag0, tag, rep["rank"], run["pool_heads"],
                     run["local_params"] / 1e9, run["init_s"],
                     "of the serving run" if rep["rank"] == 0 else
                     "of the serving run and the timed plans",
                     {k: v for k, v in run["launches"].items() if v},
                     {k: (round(v, 1) if isinstance(v, float) else v)
                      for k, v in run["transport"].items()}))
        out[tag] = lead["launches"]
    return out


# ----------------------------------------------------------------------
# phase 17: resilient multi-worker training (fault_dist, fault_elastic)
# ----------------------------------------------------------------------
ELASTIC_WORLD = 2
ELASTIC_B, ELASTIC_T = 4, 512   # per rank: BERT-base at full width
ELASTIC_STEPS = 3               # (a)-(c); the elastic runs take 4
ELASTIC_RUN_STEPS = 4
ELASTIC_LR = 2e-5
#: the knobs the rank children set (seconds): a heartbeat round waits
#: 5 s for a silent peer, a vote 10 s, a gloo collective 30 s
ELASTIC_KNOBS = {"MXNET_FAULT_HEARTBEAT_TIMEOUT": "5",
                 "MXNET_FAULT_CONSENSUS_TIMEOUT": "10",
                 "MXNET_FAULT_COLLECTIVE_TIMEOUT": "30",
                 "MXNET_FAULT_ELASTIC_DRAIN": "5",
                 "MXNET_FAULT_BOOTSTRAP_TIMEOUT": "60"}
#: (d): the peer's loss must surface within the heartbeat timeout plus
#: this much (the FileComm's poll and the scheduler)
ELASTIC_LOST_SLACK_S = 2.0
ELASTIC_TIMEOUT_S = 400
ELASTIC_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "multi_adam")


def _timed_file_comm(fd, *args, **kwargs):
    """A ``FileComm`` that notes when each of its rounds began
    (``.starts``: how long a lost peer takes to surface)."""
    comm = fd.FileComm(*args, **kwargs)
    comm.starts = []
    inner = comm.allgather

    def allgather(payload, timeout=None):
        comm.starts.append(time.monotonic())
        return inner(payload, timeout=timeout)
    comm.allgather = allgather
    return comm


def _digest(net):
    import hashlib
    h = hashlib.sha256()
    for _, p in sorted(net.collect_params().items()):
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _counters(profiler, names):
    return {n: profiler.get_counter(n) for n in names}


def elastic_rank(rank, out_dir, part):
    """One rank of the elastic phase (``chip_smoke.py --elastic-rank R
    DIR PART``, gloo through a ``FileStore`` in DIR, both ranks on card
    0): PART ``abcd`` runs (a) a control, (b) a coordinated retry, (c)
    the step lease with fleet telemetry (f), then (d) a lost rank; PART
    ``e`` a maintenance drain.  A JSON report into DIR."""
    os.environ.update(ELASTIC_KNOBS)
    store = "file://" + os.path.join(out_dir, "store")
    os.environ.update(MX_COORD_ADDR=store, MX_NUM_WORKERS=str(ELASTIC_WORLD),
                      MX_WORKER_ID=str(rank))
    torch.cuda.set_device(0)
    import shutil
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import fault, flightrec, profiler, telemetry
    from mxnet_tpu_torch import fault_dist as fd
    from mxnet_tpu_torch import fault_elastic as fe
    from mxnet_tpu_torch.ops import cuda_ops as co
    check(fd.initialize(store, ELASTIC_WORLD, rank, backend="gloo"),
          "elastic: rank %d did not join" % rank)
    dev = torch.device("cuda", 0)
    cfg = mt.models.bert_base_config(dtype="bfloat16")
    report = {"rank": rank, "part": part}

    def build():
        net = mt.models.BERTForPretrain(cfg).initialize(
            device=dev, generator=torch.Generator(device=dev).manual_seed(0))
        tr = mt.gluon.Trainer(net.collect_params(), "adamw",
                              {"learning_rate": ELASTIC_LR, "wd": 0.01},
                              kvstore="dist_sync", update_on_kvstore=True)
        return net, tr

    def one_step(net, tr, t, lr_scale=1.0):
        batch = bert_batch(cfg, dev, ELASTIC_B, ELASTIC_T, 1000 * rank + t)
        tr.set_learning_rate(ELASTIC_LR * lr_scale)
        with mt.autograd.record():
            loss = bert_loss(mt, net, *batch)
        mt.autograd.backward(loss)
        tr.step(1)
        return loss.item()

    def run(steps, net, tr):
        losses, ms = [], []
        for t in range(steps):
            _sync(dev)
            t0 = time.perf_counter()
            losses.append(one_step(net, tr, t))
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    dist_counters = ["fault::dist::" + k for k in (
        "coordinated_retries", "generation_bumps", "vote_rounds",
        "heartbeats", "lease_ops", "lease_activations", "gave_up")]
    co.reset_launch_counts()
    if part == "abcd":
        # (a) control: N steps at world 2, every push and pull voted
        fault.clear()
        torch.manual_seed(8)     # dropout: the same masks every run
        net, tr = build()
        tr._init_kvstore()
        grad_bytes = sum(p.numel() * p.element_size()
                         for p in net.parameters())
        c0 = _counters(profiler, dist_counters)
        losses, ms = run(ELASTIC_STEPS, net, tr)
        c1 = _counters(profiler, dist_counters)
        report["a"] = {"losses": losses, "digest": _digest(net), "ms": ms,
                       "params": len(list(net.parameters())),
                       "grad_bytes": grad_bytes,
                       "counters": {k: c1[k] - c0[k] for k in c0}}
        print("elastic (a) rank %d: losses %s, step ms %s" % (
            rank, losses, ["%.0f" % x for x in ms]), flush=True)
        del net, tr
        gc.collect()
        # (b) kvstore_fail on rank 1 only, at a pull of the 2nd step (a
        # pull is local: the fault is visible where its peer is not
        # parked in a collective); both vote, bump and re-issue
        fault.clear()
        torch.manual_seed(8)     # dropout: the same masks every run
        net, tr = build()
        n = report["a"]["params"]
        if rank == 1:
            # the broadcast at the kvstore's start pulls each key once,
            # and each step pulls each key once
            fault.inject("kvstore_fail", at=2 * n + 3, op="pull")
        tr._init_kvstore()
        c0 = _counters(profiler, dist_counters)
        losses, ms = run(ELASTIC_STEPS, net, tr)
        c1 = _counters(profiler, dist_counters)
        report["b"] = {"losses": losses, "digest": _digest(net), "ms": ms,
                       "fired": fault.stats().get("kvstore_fail", 0),
                       "generation": fd.generation().value,
                       "counters": {k: c1[k] - c0[k] for k in c0}}
        print("elastic (b) rank %d: losses %s, step ms %s, %s" % (
            rank, losses, ["%.0f" % x for x in ms], report["b"]),
            flush=True)
        del net, tr
        gc.collect()
        # (c) the step lease, and (f) fleet telemetry after one beat
        fault.clear()
        hb = fd.enable_step_heartbeat(every=1)
        lease = fd.enable_step_lease()
        torch.manual_seed(8)     # dropout: the same masks every run
        net, tr = build()
        tr._init_kvstore()
        votes0 = fd.default_comm()._round
        c0 = _counters(profiler, dist_counters)
        losses, ms, view = [], [], None
        for t in range(ELASTIC_STEPS):
            _sync(dev)
            t0 = time.perf_counter()
            losses.append(one_step(net, tr, t))
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            if t == 0:
                sess = telemetry.enable_fleet_telemetry()
            elif view is None:
                view = sess.fleet_view()
        c1 = _counters(profiler, dist_counters)
        report["c"] = {"losses": losses, "digest": _digest(net), "ms": ms,
                       "per_op_rounds": fd.default_comm()._round - votes0,
                       "beat_rounds": hb.comm._round, "beats": hb.beats,
                       "lease": lease.state(),
                       "fleet_ranks": sorted(view.ranks) if view else None,
                       "counters": {k: c1[k] - c0[k] for k in c0}}
        print("elastic (c) rank %d: losses %s, step ms %s, %s" % (
            rank, losses, ["%.0f" % x for x in ms], report["c"]),
            flush=True)
        fd.disable_step_heartbeat()
        del net, tr
        gc.collect()
    # (d) a lost rank / (e) a drain, under the ElasticRunner
    fault.clear()
    torch.manual_seed(8)     # dropout: the same masks every run
    net, tr = build()
    post, comms, notice = [], [], {}
    ckpt_dir = os.path.join(out_dir, "ckpt%d" % rank)
    kept = os.path.join(out_dir, "restored_from")

    def step_fn(t, info):
        if notice.get("at") == t:
            notice["set"]()
        loss = one_step(net, tr, t, info.lr_scale)
        if info.epoch:
            post.append(loss)
        return loss

    def save_fn(path, t):
        os.makedirs(path)
        net.save_parameters(os.path.join(path, "net.params"))
        tr.save_states(os.path.join(path, "trainer.states"))

    def restore_fn(path, info):
        net.load_parameters(os.path.join(path, "net.params"))
        tr.reset_kvstore()
        tr.load_states(os.path.join(path, "trainer.states"))
        shutil.copytree(path, kept)
        for f in (fault.ELASTIC_STATE, fault.ELASTIC_MANIFEST):
            shutil.copy(os.path.join(ckpt_dir, f), kept)

    def comm_factory(r, w, epoch):
        comms.append(_timed_file_comm(fd, os.path.join(out_dir, "hb"), r,
                                      w, namespace="el%d" % epoch))
        return comms[-1]

    runner = fe.ElasticRunner(
        step_fn, board=fe.FileBoard(os.path.join(out_dir, "board")),
        comm_factory=comm_factory, rank=rank, world=ELASTIC_WORLD,
        save_fn=save_fn, restore_fn=restore_fn, ckpt_dir=ckpt_dir,
        ckpt_every=2, min_world=1, telemetry=False)
    server = None
    if part == "abcd" and rank == 1:
        fault.inject("peer_hang", at=3)   # its 3rd beat: after the ckpt
    if part == "e" and rank == 1:
        server, url = _metadata_stub()
        poller = runner.watch_maintenance(url=url, interval=0.05)

        def announce():
            server.value = "TERMINATE_ON_HOST_MAINTENANCE"
            deadline = time.monotonic() + 10
            while not runner._notice_pending():
                check(time.monotonic() < deadline,
                      "elastic (e): the poller never saw the notice")
                time.sleep(0.01)
        notice.update(at=1, set=announce)
    el_names = ["fault::elastic::" + k for k in (
        "resizes", "rebootstraps", "restores", "drains", "votes",
        "checkpoints")]
    c0 = _counters(profiler, el_names + ["fault::dist::peer_lost"])
    t0 = time.monotonic()
    out = {"voted_out": False}
    try:
        status = runner.run(ELASTIC_RUN_STEPS)
        out.update(completed=status.completed, drained=status.drained)
    except fe.VotedOutError as e:
        out.update(voted_out=True, error=str(e)[:200])
    out["wall_s"] = time.monotonic() - t0
    if server is not None:
        poller.stop()
        server.shutdown()
    c1 = _counters(profiler, el_names + ["fault::dist::peer_lost"])
    events = flightrec.events()
    lost = [e for e in events if e["kind"] == "error.peer_lost"]
    resumed = [e for e in events
               if e["kind"] == "step.begin" and e.get("epoch") == 1]
    out.update(
        history=[list(h) for h in runner.history], post=post,
        world=runner.info.world, survivors=runner.info.survivors,
        lr_scale=runner.info.lr_scale, generation=runner.info.gen.value,
        counters={k.split("::")[-1]: c1[k] - c0[k] for k in c0},
        lost_ranks=[list(e["ranks"]) for e in lost],
        # the last beat that did not complete: how long the silence took
        # to surface
        lost_after_s=(lost[0]["t"] - time.time() + time.monotonic()
                      - comms[0].starts[-1]) if lost and comms[0].starts
        else None,
        # from the loss to the first step at the new world (the vote, the
        # re-bootstrap and the restore)
        resize_s=(resumed[0]["t"] - lost[0]["t"]) if lost and resumed
        else None)
    _sync(dev)
    report["launches"] = dict(co.LAUNCHES)   # the path's, not the solo's
    if out.get("completed") and runner.resizes and rank == 0:
        # the one-rank run restored from the same checkpoint (weights,
        # optimizer states, RNG) at the same scaled LR
        del net, tr
        gc.collect()
        net, tr = build()
        net.load_parameters(os.path.join(kept, "net.params"))
        tr.load_states(os.path.join(kept, "trainer.states"))
        st = fault.load_elastic_state(kept)
        out["solo"] = [one_step(net, tr, t, runner.info.lr_scale)
                       for t in range(st["step"], ELASTIC_RUN_STEPS)]
    report["run"] = out
    print("elastic (%s) rank %d: %s" % (part, rank, out), flush=True)
    report["imported_jax"] = any(m.split(".")[0] in ("jax", "jaxlib",
                                                     "mxnet_tpu")
                                 for m in sys.modules)
    dump_json(os.path.join(out_dir, "rank%d.json" % rank), report)
    return 0


def _metadata_stub():
    """A stub instance-metadata server on 127.0.0.1 whose answer is its
    ``value`` (the maintenance notice of (e))."""
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = server.value.encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass
    server = http.server.HTTPServer(("127.0.0.1", 0), Handler)
    server.value = "NONE"
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, "http://127.0.0.1:%d/maintenance-event" % \
        server.server_port


def elastic_phase(mt, co, dev, card):
    """dp=2 BERT-base (full width, bf16, per-rank B=4 T=512) on 2 gloo
    ranks sharing the card, through the Gluon Trainer with a dist_sync
    kvstore (AdamW on the store): (a) a control, (b) a coordinated
    retry, (c) the step lease, (f) fleet telemetry, (d) a lost rank and
    (e) a drain, each checked here.  Returns the launch counts, summed
    over both runs' rank 0."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="mx_elastic_") as root:
        reps = {}
        for part in ("abcd", "e"):
            d = os.path.join(root, part)
            os.makedirs(d)
            wall = _run_ranks(d, part, world=ELASTIC_WORLD,
                              mode="--elastic-rank",
                              timeout=ELASTIC_TIMEOUT_S)
            reps[part] = []
            for r in range(ELASTIC_WORLD):
                with open(os.path.join(d, "rank%d.json" % r)) as f:
                    reps[part].append(json.load(f))
            print("elastic %s: 2 gloo ranks on one card, %.1f s [%s]"
                  % (part, wall, card))
    for part, rr in reps.items():
        check(not any(r["imported_jax"] for r in rr),
              "elastic: a rank child imported JAX")
        for r in rr:
            check(all(r["launches"][k] > 0 for k in ELASTIC_KERNELS),
                  "elastic %s: rank %d missed a kernel of the path: %s"
                  % (part, r["rank"], r["launches"]))
    a0, a1 = (r["a"] for r in reps["abcd"])
    check(all(math.isfinite(x) for x in a0["losses"] + a1["losses"]),
          "elastic (a): a loss is not finite")
    check(a0["digest"] == a1["digest"],
          "elastic (a): the ranks' parameters differ")
    print("elastic (a) control: BERT-base bf16, dp=2, B=%d T=%d a rank, %d "
          "steps: losses rank 0 %s, rank 1 %s; parameters %s; host ms a "
          "step %s / %s; %d per-op vote rounds; %.1f MB of gradients "
          "all-reduced a step, each staged through pinned host memory "
          "[%s]" % (ELASTIC_B, ELASTIC_T, ELASTIC_STEPS, a0["losses"],
                    a1["losses"], a0["digest"],
                    ["%.1f" % x for x in a0["ms"]],
                    ["%.1f" % x for x in a1["ms"]],
                    a0["counters"]["fault::dist::vote_rounds"],
                    a0["grad_bytes"] / 1e6, card))
    b = [r["b"] for r in reps["abcd"]]
    for r, bb, aa in zip(reps["abcd"], b, (a0, a1)):
        check(bb["losses"] == aa["losses"] and bb["digest"] == aa["digest"],
              "elastic (b): rank %d's run differs from (a)" % r["rank"])
    keys = ("fault::dist::coordinated_retries",
            "fault::dist::generation_bumps")
    check(b[1]["fired"] == 1 and b[0]["fired"] == 0,
          "elastic (b): the fault fired %s" % [x["fired"] for x in b])
    check(all(bb["counters"][k] == 1 for bb in b for k in keys) and
          b[0]["generation"] == b[1]["generation"],
          "elastic (b): retries / bumps / generations %s"
          % [(bb["counters"], bb["generation"]) for bb in b])
    # the retry is in step 1 on both ranks: its cost beside (a)'s step 1
    retry_ms = [bb["ms"][1] - aa["ms"][1] for bb, aa in zip(b, (a0, a1))]
    print("elastic (b) coordinated retry: kvstore_fail on rank 1's pull; "
          "both ranks voted, bumped the generation once (retries %s, "
          "bumps %s, final generations %s) and re-issued; losses and "
          "parameters equal (a)'s bit for bit; the retried step's host ms "
          "less (a)'s step 1: %s [%s]"
          % ([bb["counters"][keys[0]] for bb in b],
             [bb["counters"][keys[1]] for bb in b],
             [bb["generation"] for bb in b],
             ["%.1f" % x for x in retry_ms], card))
    c = [r["c"] for r in reps["abcd"]]
    for r, cc, aa in zip(reps["abcd"], c, (a0, a1)):
        check(cc["losses"] == aa["losses"] and cc["digest"] == aa["digest"],
              "elastic (c): rank %d's leased run differs from (a)"
              % r["rank"])
        check(cc["per_op_rounds"] == 0 and cc["lease"] == "active" and
              cc["beat_rounds"] == cc["beats"] == ELASTIC_STEPS,
              "elastic (c): rank %d: %s" % (r["rank"], cc))
    med = [sorted(x["ms"])[len(x["ms"]) // 2] for x in (a0, c[0])]
    print("elastic (c) step lease: 0 per-op vote rounds over %d steps, %d "
          "beat rounds (= beats), losses equal (a)'s bit for bit; host ms "
          "a step, rank 0 median: %.1f per-op voting, %.1f leased [%s]"
          % (ELASTIC_STEPS, c[0]["beat_rounds"], med[0], med[1], card))
    check(c[0]["fleet_ranks"] == [0, 1],
          "elastic (f): rank 0's FleetView names %s" % c[0]["fleet_ranks"])
    print("elastic (f) fleet telemetry: enable_fleet_telemetry() after one "
          "beat; rank 0's FleetView names ranks %s [%s]"
          % (c[0]["fleet_ranks"], card))
    d0, d1 = (r["run"] for r in reps["abcd"])
    hb_s = float(ELASTIC_KNOBS["MXNET_FAULT_HEARTBEAT_TIMEOUT"])
    check(d0["lost_ranks"] == [[1]] and d0["lost_after_s"] is not None and
          d0["lost_after_s"] <= hb_s + ELASTIC_LOST_SLACK_S,
          "elastic (d): rank 0 lost %s after %s s" % (d0["lost_ranks"],
                                                      d0["lost_after_s"]))
    check(d0["completed"] and d0["world"] == 1 and d0["lr_scale"] == 0.5
          and all(d0["counters"][k] == 1 for k in
                  ("resizes", "rebootstraps", "restores")),
          "elastic (d): rank 0 %s" % d0)
    check(len(d0["post"]) == ELASTIC_RUN_STEPS - 2 and
          d0["post"] == d0["solo"],
          "elastic (d): after the resize %s, one-rank restore %s"
          % (d0["post"], d0.get("solo")))
    check(d1["voted_out"], "elastic (d): rank 1 was not voted out: %s" % d1)
    print("elastic (d) lost rank: peer_hang on rank 1 after the step-2 "
          "checkpoint; rank 0 got PeerLostError naming %s after %.2f s "
          "(heartbeat timeout %.0f s + slack %.0f s), committed world 1, "
          "voted, re-bootstrapped and restored: %.2f s to its next step; at lr_scale "
          "%.1f: losses %s == the one-rank restore's %s bit for bit; "
          "resizes/rebootstraps/restores %s; rank 1 voted out "
          "(VotedOutError), exit 0 [%s]"
          % (d0["lost_ranks"][0], d0["lost_after_s"], hb_s,
             ELASTIC_LOST_SLACK_S, d0["resize_s"] or float("nan"),
             d0["lr_scale"], d0["post"], d0["solo"],
             [d0["counters"][k] for k in ("resizes", "rebootstraps",
                                          "restores")], card))
    e0, e1 = (r["run"] for r in reps["e"])
    check(e1.get("drained") and e1["counters"]["drains"] == 1,
          "elastic (e): rank 1 did not drain: %s" % e1)
    check(e0["completed"] and e0["world"] == 1 and
          e0["counters"]["resizes"] == 1,
          "elastic (e): rank 0 did not resize without it: %s" % e0)
    print("elastic (e) drain: a TERMINATE notice from the stub metadata "
          "server reached rank 1's MaintenancePoller; it checkpointed, "
          "posted its leave record and exited 0 (drains %d); rank 0 "
          "resized to world %d and finished, losses after %s [%s]"
          % (e1["counters"]["drains"], e0["world"], e0["post"], card))
    launches = dict.fromkeys(co.LAUNCHES, 0)
    for part in reps:
        for k, v in reps[part][0]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


# ----------------------------------------------------------------------
# the analysis phase: mx.monitor at BERT-base width and on a hybridized
# ResNet-50, then the checkers' gates
# ----------------------------------------------------------------------
#: encoder layer whose FFN weight gets the NaN
MON_NAN_LAYER = 6
ANALYSIS_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                    "multi_adam")


def _host_reads(fn):
    """The calls ``fn()`` made that copy a tensor to the host
    (``Tensor.item`` / ``cpu`` / ``tolist`` / ``numpy``), by name."""
    names = ("item", "cpu", "tolist", "numpy")
    real = {n: getattr(torch.Tensor, n) for n in names}
    counts = dict.fromkeys(names, 0)

    def counting(n):
        def call(self, *a, **k):
            counts[n] += 1
            return real[n](self, *a, **k)
        return call
    try:
        for n in names:
            setattr(torch.Tensor, n, counting(n))
        fn()
    finally:
        for n in names:
            setattr(torch.Tensor, n, real[n])
    return {n: c for n, c in counts.items() if c}


def _block_names(net, root):
    """The monitor's name of every block of ``net`` (no suffix)."""
    return {root + ("." + n if n else "") for n, _ in net.named_modules()}


def _finite_stats(res):
    return all(math.isfinite(float(v)) for _, _, v in res)


def monitor_bert(mt, co, dev, card):
    """``Monitor(interval=1)`` on BERT-base bf16 (B=16, T=512, the flash
    path): 3 Trainer / AdamW steps unmonitored, then the same 3 from the
    same weights, dropout seed and fresh optimizer with the monitor
    installed; the losses and the final weights must be equal bit for
    bit (the hooks only read), every block's output and every parameter
    must have a finite stat, and the monitored steps must launch the
    flash kernels and ``multi_adam``.  Then a NaN in encoder layer 6's
    FFN weight must be the first ``"nan"`` of ``toc()``'s unsorted
    output, at that layer's FFN output.  Returns the launch counts of
    the monitored steps."""
    from mxnet_tpu_torch import monitor as monitor_mod
    cfg = mt.models.bert_base_config(dtype="bfloat16")
    net = mt.models.BERTForPretrain(cfg).initialize(
        device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    batch = bert_batch(cfg, dev, BERT_B, BERT_T, 7)
    init = [p.detach().clone() for p in net.parameters()]
    state = {}

    def fresh():
        with torch.no_grad():
            for p, v in zip(net.parameters(), init):
                p.copy_(v)
        state["trainer"] = mt.gluon.Trainer(
            net.collect_params(), "adamw", {"learning_rate": 2e-5,
                                            "wd": 0.01})
        torch.cuda.manual_seed(8)     # dropout's masks: the same each run

    def step(mon=None):
        if mon is not None:
            mon.tic()
        with mt.autograd.record():
            loss = bert_loss(mt, net, *batch)
        mt.autograd.backward(loss)
        state["trainer"].step(1)
        res = mon.toc() if mon is not None else None
        return loss.item(), res

    def run(mon=None):
        fresh()
        losses, times, results = [], [], []
        for _ in range(BERT_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            loss, res = step(mon)
            times.append((time.monotonic() - t0) * 1e3)
            losses.append(loss)
            results.append(res)
        return losses, times, results, [p.detach().clone()
                                        for p in net.parameters()]
    fresh()
    step()                        # warm-up: the library's first calls
    plain_losses, plain_ms, _, plain_w = run()
    mon = mt.monitor.Monitor(interval=1)
    mon.install(net)
    t0 = monitor_mod.TRANSFERS["count"]
    co.reset_launch_counts()
    mon_losses, mon_ms, results, mon_w = run(mon)
    torch.cuda.synchronize()
    launches = dict(co.LAUNCHES)
    transfers = (monitor_mod.TRANSFERS["count"] - t0) / BERT_STEPS
    same_w = all(torch.equal(a, b) for a, b in zip(plain_w, mon_w))
    del plain_w, mon_w
    if mon_losses != plain_losses or not same_w:
        again, _, _, _ = run()       # is the step itself deterministic?
        check(False, "monitor bert: monitored losses %s (weights equal "
              "%s) differ from unmonitored %s (a second unmonitored run "
              "%s)" % (mon_losses, same_w, plain_losses, again))
    res = results[-1]
    names = [n for _, n, _ in res]
    blocks = _block_names(net, "bertforpretrain")
    params = set(net.collect_params())
    seen = {n.rsplit("_output", 1)[0] for n in names if "_output" in n}
    check(blocks <= seen and params <= set(names),
          "monitor bert: missing stats for %s"
          % sorted((blocks - seen) | (params - set(names)))[:8])
    check(len(names) == len(set(names)), "monitor bert: duplicate names")
    check(all(_finite_stats(r) for r in results),
          "monitor bert: a stat is not finite: %s"
          % [x for x in res if not math.isfinite(float(x[2]))][:4])
    for name in ANALYSIS_KERNELS[:3]:
        check(launches[name] == cfg.num_layers * BERT_STEPS,
              "monitor bert: %s launched %d times in %d steps"
              % (name, launches[name], BERT_STEPS))
    check_opt_launches("monitor bert", launches, "multi_adam", BERT_STEPS,
                       net.parameters())
    # host reads of one step without and with the monitor, then both
    # steps timed in turns (host synchronized; kernels by the profiler)
    reads = (_host_reads(lambda: step()), _host_reads(lambda: step(mon)))
    busy = [device_busy(lambda: step(), reps=5),
            device_busy(lambda: step(mon), reps=5),
            device_busy(lambda: step(mon), reps=5),
            device_busy(lambda: step(), reps=5)]
    plain_b, mon_b = (busy[0], busy[3]), (busy[1], busy[2])
    print("monitor bert-base (bf16, B=%d, T=%d, %d blocks, %d parameters): "
          "losses unmonitored %s monitored %s (bit for bit: %s, weights "
          "bit for bit: %s); those steps' ms unmonitored %s monitored %s; "
          "host transfers a monitored step: %g by toc(); host reads a step "
          "unmonitored %s, monitored %s; launches %s [%s]"
          % (BERT_B, BERT_T, len(blocks), len(params), plain_losses,
             mon_losses, mon_losses == plain_losses, same_w,
             ["%.2f" % t for t in plain_ms], ["%.2f" % t for t in mon_ms],
             transfers, reads[0], reads[1],
             {k: v for k, v in launches.items() if v}, card))
    print("monitor bert-base step, in turns unmonitored / monitored / "
          "monitored / unmonitored (5 steps each): host ms %s, kernel ms "
          "%s, device busy %s, device events %s; monitored - unmonitored: "
          "host %+.2f ms (%+.1f%%), kernels %+.2f ms, %+.0f device events "
          "[%s]"
          % (["%.2f" % b[0] for b in busy], ["%.2f" % b[1] for b in busy],
             ["%.1f%%" % (100 * b[1] / b[0]) for b in busy],
             [b[3]["device events"] for b in busy],
             sum(b[0] for b in mon_b) / 2 - sum(b[0] for b in plain_b) / 2,
             100 * (sum(b[0] for b in mon_b) / sum(b[0] for b in plain_b)
                    - 1),
             sum(b[1] for b in mon_b) / 2 - sum(b[1] for b in plain_b) / 2,
             sum(b[3]["device events"] for b in mon_b) / 2
             - sum(b[3]["device events"] for b in plain_b) / 2, card))
    added = {}
    for sign, pair in ((1, mon_b), (-1, plain_b)):
        for b in pair:
            for k, (ms, n) in b[4].items():
                was = added.get(k, (0.0, 0.0))
                added[k] = (was[0] + sign * ms / 2, was[1] + sign * n / 2)
    print("monitor bert-base: kernels the monitor adds a step (ms, "
          "launches): %s" % "; ".join(
              "%s %.3f, %+.0f" % (k[:60], ms, n) for k, (ms, n) in
              sorted(added.items(), key=lambda kv: -kv[1][0])[:5]))
    check(transfers == 1, "monitor bert: %g host transfers by toc() a "
          "step, want 1" % transfers)
    # the first NaN: one weight of layer 6's FFN
    layer = getattr(net.bert, "layer%d" % MON_NAN_LAYER)
    w = layer.inter.weight
    with torch.no_grad():
        keep = w[0, 0].clone()
        w[0, 0] = float("nan")
    mon.tic()
    with mt.autograd.pause():
        net(*batch[:2])
    res = mon.toc()
    with torch.no_grad():
        w[0, 0] = keep
    first = next(i for i, (_, _, v) in enumerate(res) if v == "nan")
    want = "bertforpretrain.bert.layer%d.inter_output" % MON_NAN_LAYER
    print("monitor bert: NaN in bert.layer%d.inter.weight[0, 0]: first "
          "\"nan\" is entry %d of %d, %s; the %d before it finite"
          % (MON_NAN_LAYER, first, len(res), res[first][1], first))
    check(res[first][1] == want, "monitor bert: the first NaN is %s, want "
          "%s" % (res[first][1], want))
    check(_finite_stats(res[:first]), "monitor bert: a stat before the "
          "NaN layer is not finite")
    mon.uninstall()
    return launches


def monitor_hybridized(mt, co, dev, card):
    """``Monitor`` on ResNet-50 bf16 hybridized (B=32): the capture with
    the hooks installed succeeds, its warm-ups and capture queue nothing
    (each block once, from the first call's eager forward), a replay
    queues the net's own output only, and the replayed output equals
    the unmonitored replay bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(RESNET_B, 3, 224, 224, generator=gen, device=dev).to(
        torch.bfloat16)
    net = _resnet50(mt, dev).cast("bfloat16")
    with mt.autograd.pause():
        net(x)                                   # materialise
        net.hybridize()
        net(x)                                   # eager, then capture
        want = net(x)                            # unmonitored replay
        net.hybridize()                          # drop the graph
        mon = mt.monitor.Monitor(interval=1, pattern=".*_output")
        mon.install(net)
        mon.tic()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        net(x)                                   # eager, then capture
        torch.cuda.synchronize()
        capture_s = time.monotonic() - t0
        first = [n for _, n, _ in mon.queue]
        got = net(x)                             # replay
        extra = [n for _, n, _ in mon.queue[len(first):]]
        res = mon.toc()
    mon.uninstall()
    blocks = {n + "_output" for n in _block_names(net, "resnetv1")}
    print("monitor resnet50 hybridized (bf16, B=%d): first call %.2f s "
          "(eager + 2 warm-ups + capture) queued %d entries for %d "
          "blocks, %d duplicates; a replay queued %s; replay bit for bit "
          "with the unmonitored one: %s [%s]"
          % (RESNET_B, capture_s, len(first), len(blocks),
             len(first) - len(set(first)), extra, torch.equal(got, want),
             card))
    check(len(net._graphs) == 1, "monitor resnet50: no graph captured")
    check(len(first) == len(set(first)) and set(first) <= blocks,
          "monitor resnet50: the capture queued entries")
    check(extra == ["resnetv1_output"], "monitor resnet50: a replay "
          "queued %s" % extra)
    check(torch.equal(got, want), "monitor resnet50: the monitored replay "
          "differs from the unmonitored one")
    check(_finite_stats(res), "monitor resnet50: a stat is not finite")


def analysis_gates(card):
    """The checkers' gates as ``python -m mxnet_tpu_torch.analysis``
    runs them, in this process: verify --smoke (every scenario clean,
    every mutation found), racecheck --smoke, lint and race against
    their baselines.  Returns each gate's seconds."""
    from mxnet_tpu_torch.analysis.__main__ import main as analysis
    secs = {}
    for argv in (["verify", "--smoke"], ["racecheck", "--smoke"],
                 ["lint", "--smoke"], ["race", "--smoke"]):
        t0 = time.monotonic()
        rc = analysis(argv)
        secs[" ".join(argv)] = round(time.monotonic() - t0, 2)
        check(rc == 0, "analysis %s: exit %d" % (" ".join(argv), rc))
    print("analysis gates (seconds): %s [%s]" % (secs, card))
    return secs


def analysis_phase(mt, co, dev, card):
    """``mx.monitor`` at BERT-base width and on a hybridized ResNet-50,
    then the analysis gates.  Returns the monitored BERT steps' launch
    counts."""
    t0 = time.monotonic()
    launches = monitor_bert(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    monitor_hybridized(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    analysis_gates(card)
    print("analysis phase %.1f s" % (time.monotonic() - t0))
    return launches


# ----------------------------------------------------------------------
# the data phase: recordio, the native reader, ImageRecordIter feeding
# ResNet-50's TrainStep, a killed worker, a DataLoader feeding the LM
# ----------------------------------------------------------------------
DATA_RECORDS, DATA_B, DATA_SIDE = 1024, 128, 224
DATA_STEPS = 10                 # fed steps whose metric reads are counted
DATA_LM_LAYERS, DATA_LM_T, DATA_LM_STEPS = 2, 1024, 3
DATA_RESNET_KERNELS = ("multi_sgd",)
DATA_LM_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "multi_adam")


class _RawImages:
    """HWC uint8 images from raw records (no cv2 on the machine): the
    payload reshaped, labels the headers', ToTensor in numpy."""

    def __init__(self, mt, path):
        self.ds = mt.gluon.data.RecordFileDataset(path)
        self.unpack = mt.recordio.unpack

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        import numpy as onp
        header, body = self.unpack(self.ds[i])
        img = onp.frombuffer(body, onp.uint8).reshape(DATA_SIDE, DATA_SIDE,
                                                      3)
        return (img.astype("float32") / 255.0).transpose(2, 0, 1), \
            float(header.label)


def data_records(mt, tmp):
    """1024 synthetic 224x224x3 records, labels i % 1000: JPEG at quality
    85 through ``pack_img`` (``bench.py``'s), or raw HWC bytes through
    ``pack`` where cv2 is missing.  Every record is read through the
    native reader and the Python one, which must agree.  Returns (path,
    cv2 present)."""
    import numpy as onp
    try:
        import cv2
        have_cv2 = True
        print("data: cv2 %s present: JPEG records" % cv2.__version__)
    except ImportError:
        have_cv2 = False
        print("data: cv2 is not installed on this machine: raw HWC uint8 "
              "records through recordio.pack, read back by a numpy "
              "reshape")
    rec = os.path.join(tmp, "synth.rec")
    t0 = time.monotonic()
    rs = onp.random.RandomState(0)
    w = mt.recordio.MXIndexedRecordIO(os.path.join(tmp, "synth.idx"), rec,
                                      "w")
    for i in range(DATA_RECORDS):
        img = rs.randint(0, 255, (DATA_SIDE, DATA_SIDE, 3)).astype("uint8")
        header = mt.recordio.IRHeader(0, float(i % 1000), i, 0)
        w.write_idx(i, mt.recordio.pack_img(header, img, quality=85)
                    if have_cv2 else mt.recordio.pack(header, img.tobytes()))
    w.close()
    write_s = time.monotonic() - t0
    native = mt.gluon.data.RecordFileDataset(rec)
    check(native.native, "data: the native reader was not used")
    from mxnet_tpu_torch import _native
    os.environ["MXNET_NATIVE_DISABLE"] = "1"
    try:
        plain = mt.gluon.data.RecordFileDataset(rec)
    finally:
        del os.environ["MXNET_NATIVE_DISABLE"]
    check(not plain.native and len(native) == len(plain) == DATA_RECORDS,
          "data: the readers disagree on the records")
    t0 = time.monotonic()
    a = [native[i] for i in range(DATA_RECORDS)]
    native_s = time.monotonic() - t0
    t0 = time.monotonic()
    b = [plain[i] for i in range(DATA_RECORDS)]
    plain_s = time.monotonic() - t0
    check(a == b, "data: native and Python readers disagree")
    mb = sum(map(len, a)) / 1e6
    print("data: %d records (%.1f MB) written in %.2f s; read back equal "
          "through the native reader (%s, %.1f ms) and the Python reader "
          "(%.1f ms)" % (DATA_RECORDS, mb, write_s, _native.library_path(),
                         native_s * 1e3, plain_s * 1e3))
    return rec, have_cv2


class _LoaderIter:
    """A ``DataLoader`` of (data, label) batches read as a DataIter."""

    def __init__(self, mt, loader):
        self._mt, self._loader, self._it = mt, loader, None

    def reset(self):
        self._it = iter(self._loader)

    def next(self):
        if self._it is None:
            self.reset()
        try:
            data, label = next(self._it)
        except StopIteration:
            self._it = None
            raise
        return self._mt.io.DataBatch(data=[data], label=[label], pad=0)


def _data_iter(mt, rec, have_cv2, threads, thread_pool=False):
    """The fed iterator: ``ImageRecordIter`` with the reference's
    settings (decode in forked workers); with ``thread_pool`` a
    ``DataLoader`` of the same transforms on worker threads; without
    cv2, a ``DataLoader`` over the raw records."""
    if have_cv2 and not thread_pool:
        return mt.io.ImageRecordIter(
            path_imgrec=rec, data_shape=(3, DATA_SIDE, DATA_SIDE),
            batch_size=DATA_B, shuffle=False, preprocess_threads=threads,
            prefetch_buffer=6, round_batch=True)
    if have_cv2:
        T = mt.gluon.data.vision.transforms
        ds = mt.gluon.data.vision.ImageRecordDataset(rec).transform_first(
            T.Compose([T.CenterCrop((DATA_SIDE, DATA_SIDE)), T.ToTensor()]))
    else:
        ds = _RawImages(mt, rec)
    return _LoaderIter(mt, mt.gluon.data.DataLoader(
        ds, batch_size=DATA_B, num_workers=threads, last_batch="rollover",
        prefetch=6, thread_pool=thread_pool))


def _batches(it):
    """Endless (data bf16, label int32) batches of ``it``, epoch after
    epoch."""
    while True:
        it.reset()
        while True:
            try:
                b = it.next()
            except StopIteration:
                break
            yield (b.data[0]._data.to(torch.bfloat16),
                   b.label[0]._data.to(torch.int32))


def loader_alone(it, dev, card, n=16):
    """Images/s of the iterator with no step behind it."""
    gen = _batches(it)
    for _ in range(2):
        next(gen)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        x, y = next(gen)
    torch.cuda.synchronize()
    rate = n * DATA_B / (time.monotonic() - t0)
    check(tuple(x.shape) == (DATA_B, 3, DATA_SIDE, DATA_SIDE) and
          x.device.type == y.device.type == dev.type,
          "data: a batch is %s on %s" % (tuple(x.shape), x.device))
    print("data loader alone, %s: %.1f images/s (B=%d, %d workers, "
          "prefetch 6; os.cpu_count() %d) [%s]"
          % (_feed_name(it), rate, DATA_B, it._loader._num_workers,
             os.cpu_count(), card))
    return rate


def _feed_name(it):
    if not isinstance(it, _LoaderIter):
        return "ImageRecordIter (worker processes, shared memory)"
    return "DataLoader on worker %s" % ("threads" if it._loader._thread_pool
                                        else "processes (raw records)")


def data_resnet(mt, co, dev, card, it, it_threads, tmp):
    """ResNet-50 (bf16 NCHW, BatchNorm float32) through ``TrainStep`` and
    SGD(lr 0.1, momentum 0.9, wd 1e-4) at B=128, fed by ``it``, then fed
    by ``it_threads`` and by one synthetic device batch; Accuracy and
    CrossEntropy updated every step.  Returns the fed steps' launch
    counts."""
    import numpy as onp
    net = _resnet50(mt, dev).cast("bfloat16")
    for m in net.modules():
        if isinstance(m, mt.gluon.nn.BatchNorm):
            m.cast("float32")
    with mt.autograd.pause():
        net(torch.zeros(2, 3, DATA_SIDE, DATA_SIDE, device=dev,
                        dtype=torch.bfloat16))
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    kept = {}

    def fwd(model, x, y):
        out = model(x)
        kept["out"] = out.detach()
        return loss_fn(out.float(), y).mean()
    step = mt.parallel.TrainStep(net, None, mt.optimizer.SGD(
        learning_rate=0.1, momentum=0.9, wd=1e-4), forward_fn=fwd)
    gen = _batches(it)
    acc, ce = mt.metric.Accuracy(), mt.metric.CrossEntropy()
    x, y = next(gen)
    step(x, y)                                  # warm-up
    torch.cuda.synchronize()
    co.reset_launch_counts()
    losses, preds, labels = [], [], []

    def fed_steps():
        for _ in range(DATA_STEPS):
            x, y = next(gen)
            losses.append(step(x, y))
            probs = kept["out"].float().softmax(-1)
            acc.update([y], [kept["out"]])
            ce.update([y], [probs])
            preds.append((kept["out"].argmax(-1), probs))
            labels.append(y)
        vals = torch.stack(losses).tolist()
        return vals, acc.get()[1], ce.get()[1]
    t0 = time.monotonic()
    reads = _host_reads(lambda: kept.__setitem__("res", fed_steps()))
    wall = time.monotonic() - t0
    launches = dict(co.LAUNCHES)
    vals, acc_v, ce_v = kept["res"]
    check(all(math.isfinite(v) for v in vals),
          "data_resnet: a loss is not finite: %s" % vals)
    check(reads == {"tolist": 3}, "data_resnet: the loop read %s to the "
          "host; want its own losses once and one read per metric get()"
          % reads)
    lab = torch.cat(labels).cpu().numpy()
    am = torch.cat([p[0] for p in preds]).cpu().numpy()
    pr = torch.cat([p[1] for p in preds]).double().cpu().numpy()
    want_acc = float((am == lab).mean())
    want_ce = float(-onp.log(pr[onp.arange(len(lab)), lab] + 1e-12).mean())
    check(acc_v == want_acc and abs(ce_v - want_ce) <= 1e-6 * want_ce,
          "data_resnet: metrics %s / %s, numpy float64 %s / %s"
          % (acc_v, ce_v, want_acc, want_ce))
    check_opt_launches("data_resnet", launches, "multi_sgd", DATA_STEPS,
                       net.parameters())
    del preds, labels, losses
    print("data_resnet: %d fed steps in %.2f s (%.1f images/s with the "
          "metrics and their reads), losses %s; host reads %s; accuracy "
          "%.6f, cross-entropy %.6f = numpy float64 [%s]"
          % (DATA_STEPS, wall, DATA_STEPS * DATA_B / wall,
             ["%.4f" % v for v in vals], reads, acc_v, ce_v, card))
    rows = {}
    xs, ys = next(gen)
    gen_t = _batches(it_threads)
    for feed, fn in ((_feed_name(it), lambda: step(*next(gen))),
                     (_feed_name(it_threads), lambda: step(*next(gen_t))),
                     ("synthetic device batch", lambda: step(xs, ys))):
        ms, dev_ms, top, _, _ = device_busy(fn, reps=5)
        rows[feed] = (DATA_B / ms * 1e3, 100 * dev_ms / ms)
        print("data_resnet fed by %s: step %.1f ms host, %.1f ms of kernels "
              "(device busy %.1f%%), %.1f images/s [%s]; top kernels (ms "
              "per step): %s" % (feed, ms, dev_ms, 100 * dev_ms / ms,
                                 DATA_B / ms * 1e3, card,
                                 "; ".join("%s %.3f" % t for t in top)))
    syn = rows["synthetic device batch"]
    for feed in (_feed_name(it), _feed_name(it_threads)):
        fed = rows[feed]
        print("data_resnet: fed by %s %.1f images/s (busy %.1f%%) against "
              "synthetic %.1f images/s (busy %.1f%%): the feed costs %.1f%% "
              "of the throughput [%s]" % (feed, fed[0], fed[1], syn[0],
                                          syn[1], 100 * (1 - fed[0] / syn[0]),
                                          card))
    # the profiler's data counters over one more epoch of fed steps
    prof = mt.profiler
    prof.set_config(profile_all=False, profile_imperative=False,
                    profile_memory=False, profile_data=True,
                    filename=os.path.join(tmp, "data.json"))
    before = {k: prof.get_counter(k) for k in ("dataloader::batches",
                                               "dataloader::samples")}
    prof.set_state("run")
    try:
        for _ in range(DATA_RECORDS // DATA_B):
            step(*next(gen))
        torch.cuda.synchronize()
    finally:
        prof.set_state("stop")
    agg = prof._state["agg"].get("DataLoader::next", [0, 0.0])
    print("data_resnet profiler: %s; DataLoader::next %d fetches, mean wait "
          "%.2f ms [%s]" % ({k: prof.get_counter(k) - v for k, v in
                             before.items()}, agg[0],
                            1e3 * agg[1] / max(agg[0], 1), card))
    check(prof.get_counter("dataloader::batches") > before[
        "dataloader::batches"], "data_resnet: the profiler counted no batch")
    del step, net
    return launches


class _Slowed:
    """``ds`` with each item 10 ms slower: a worker killed at a submit
    then always leaves a batch outstanding, which the loader must see."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        time.sleep(0.01)
        return self.ds[i]


def data_worker_kill(mt, rec, have_cv2, card):
    """A worker killed at the third submit, after CUDA is up: the pool is
    rebuilt once and the epoch equals an unfaulted one, batch by batch
    in order."""
    def epoch():
        if have_cv2:
            T = mt.gluon.data.vision.transforms
            ds = mt.gluon.data.vision.ImageRecordDataset(rec) \
                .transform_first(T.Compose([T.CenterCrop(DATA_SIDE),
                                            T.ToTensor()]))
        else:
            ds = _RawImages(mt, rec)
        with mt.gluon.data.DataLoader(_Slowed(ds.take(256)), batch_size=32,
                                      num_workers=4, prefetch=4) as loader:
            return [[t._data for t in b] for b in loader]
    want = epoch()
    base = mt.profiler.get_counter("fault::worker_restarts")
    mt.fault.clear()
    mt.fault.inject("worker_kill", at=3)
    try:
        got = epoch()
    finally:
        mt.fault.clear()
    restarts = mt.profiler.get_counter("fault::worker_restarts") - base
    check(restarts == 1, "data: worker_restarts moved by %d, want 1"
          % restarts)
    check(len(got) == len(want) and all(
        all(torch.equal(a, b) for a, b in zip(g, w))
        for g, w in zip(got, want)), "data: the faulted epoch differs")
    print("data worker kill: a worker SIGKILLed at the 3rd submit (CUDA up "
          "in the parent), the pool rebuilt once (fault::worker_restarts "
          "%d), %d batches of the epoch equal to an unfaulted epoch, in "
          "order [%s]" % (restarts, len(got), card))


def data_lm(mt, co, dev, card):
    """``llama3_8b_config`` at full width, 2 of 32 layers, T=1024: 3
    AdamW ``TrainStep`` steps fed by a ``DataLoader`` over an
    ``ArrayDataset`` of seeded int32 token windows and targets
    (``batchify.Stack()``), ``Perplexity`` updated on the device each
    step.  Returns the run's launch counts."""
    import numpy as onp
    net = build_model(mt, dev, DATA_LM_LAYERS)
    V, T = net.cfg.vocab_size, DATA_LM_T
    rng = onp.random.RandomState(4)
    seq = rng.randint(0, V, (6, T + 1)).astype("int32")
    ds = mt.gluon.data.ArrayDataset(seq[:, :-1], seq[:, 1:])
    loader = mt.gluon.data.DataLoader(
        ds, batch_size=2, batchify_fn=mt.gluon.data.batchify.Stack())
    loss_fn = mt.gluon.loss.SoftmaxCELoss()
    ppl = mt.metric.Perplexity()
    kept = {}

    def fwd(model, tokens, lab):
        logits = model(tokens).float()
        kept["logits"] = logits.detach()
        return loss_fn(logits.reshape(-1, V), lab.reshape(-1)).mean()
    step = mt.parallel.TrainStep(net, None,
                                 mt.optimizer.AdamW(learning_rate=1e-3),
                                 forward_fn=fwd)
    torch.cuda.synchronize()
    co.reset_launch_counts()
    t0 = time.monotonic()
    losses = []
    for batch in loader:
        b = batch._data
        check(b.device.type == dev.type and tuple(b.shape) == (2, 2, T),
              "data_lm: a batch is %s on %s" % (tuple(b.shape), b.device))
        toks, lab = b[:, 0], b[:, 1]
        losses.append(step(toks, lab))
        ppl.update([lab], [kept["logits"].softmax(-1)])
    vals = torch.stack(losses).tolist()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(co.LAUNCHES)
    value = ppl.get()[1]
    check(len(vals) == DATA_LM_STEPS and all(math.isfinite(v) for v in vals)
          and math.isfinite(value), "data_lm: losses %s, perplexity %s"
          % (vals, value))
    check(abs(math.log(value) - sum(vals) / len(vals)) < 1e-2,
          "data_lm: log perplexity %.5f against the mean loss %.5f"
          % (math.log(value), sum(vals) / len(vals)))
    print("data_lm: %d AdamW steps (llama3_8b widths, %d layers, B=2, T=%d) "
          "fed by a DataLoader in %.2f s, losses %s, perplexity %.2f; "
          "launches %s [%s]" % (len(vals), DATA_LM_LAYERS, T, wall,
                                ["%.4f" % v for v in vals], value,
                                {k: launches[k] for k in DATA_LM_KERNELS},
                                card))
    return launches


def data_phase(mt, co, dev, card):
    """The data pipeline on the card; returns the launch counts of the
    ``data_resnet`` and ``data_lm`` paths."""
    import tempfile
    t0 = time.monotonic()
    threads = min(16, os.cpu_count() or 4)
    with tempfile.TemporaryDirectory(prefix="mx_data_") as tmp:
        rec, have_cv2 = data_records(mt, tmp)
        it = _data_iter(mt, rec, have_cv2, threads)
        it_threads = _data_iter(mt, rec, have_cv2, threads, thread_pool=True)
        try:
            loader_alone(it, dev, card)
            loader_alone(it_threads, dev, card)
            resnet = data_resnet(mt, co, dev, card, it, it_threads, tmp)
        finally:
            it._loader.close()
            it_threads._loader.close()
        gc.collect()
        torch.cuda.empty_cache()
        data_worker_kill(mt, rec, have_cv2, card)
    lm = data_lm(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    print("data phase %.1f s [%s]" % (time.monotonic() - t0, card))
    return resnet, lm


# -- the imperative surface (mx.nd legacy ops, np.linalg / fft,
# nd.image, nd.sparse + kvstore, nd.contrib detection) -----------------
IMP_B = 32
IMP_LEGACY_REL = 1e-2         # of max|logit| where the spellings' calls differ
IMP_LINALG_N = 4096
IMP_LINALG_TOL = 1e-4
IMP_FFT_TOL = 1e-5            # round trips, of max|x|
IMP_FFT_REF_TOL = 1e-4        # rfft2 against float64 numpy, of max|ref|
IMP_IMAGES = 128
IMP_SPARSE_DIM = 1000000      # avazu-app's feature count (LIBSVM data sets)
IMP_SPARSE_ROWS = 2048
IMP_SPARSE_NNZ = 20
IMP_SPARSE_B = 256
IMP_SPARSE_RTOL = 1e-5
IMP_SPARSE_LR = 0.5
IMP_DET_TOL = 1e-5
# SSD-300 (Liu et al., 2016): six maps, their anchor sizes and ratios ->
# 4 / 6 / 6 / 6 / 4 / 4 anchors a cell, 8732 in all
SSD_MAPS = [(38, (0.1, 0.141), (1, 2, 0.5)),
            (19, (0.2, 0.272), (1, 2, 0.5, 3, 1 / 3)),
            (10, (0.37, 0.447), (1, 2, 0.5, 3, 1 / 3)),
            (5, (0.54, 0.619), (1, 2, 0.5, 3, 1 / 3)),
            (3, (0.71, 0.79), (1, 2, 0.5)),
            (1, (0.88, 0.961), (1, 2, 0.5))]
SSD_CLASSES = 21


def legacy_resnet_v1(mt, net, x):
    """``net`` (a Gluon ResNet V1 of the port) applied to the NDArray
    ``x`` in the legacy ``mx.nd`` spelling: its blocks walked in order,
    each layer one ``mx.nd`` op (``Convolution``, ``BatchNorm`` with the
    running statistics, ``Activation``, ``Pooling``, ``elemwise_add``,
    ``Flatten``, ``FullyConnected``) on the net's own parameters."""
    nd = mt.nd
    nn = mt.gluon.nn
    vision = mt.gluon.model_zoo.vision

    def p(param):
        return None if param is None else param.data()

    def layer(blk, x):
        if isinstance(blk, nn.Conv2D):
            return nd.Convolution(
                x, p(blk.weight), p(blk.bias), kernel=blk._kernel,
                stride=blk._strides, pad=blk._padding,
                dilate=blk._dilation, num_filter=blk._channels,
                num_group=blk._groups, no_bias=blk.bias is None,
                layout=blk._layout)
        if isinstance(blk, nn.BatchNorm):
            return nd.BatchNorm(x, p(blk.gamma), p(blk.beta),
                                p(blk.running_mean), p(blk.running_var),
                                eps=blk._epsilon, fix_gamma=not blk._scale,
                                use_global_stats=True, axis=blk._axis)
        if isinstance(blk, nn.Activation):
            return nd.Activation(x, act_type=blk._act_type)
        if isinstance(blk, (nn.MaxPool2D, nn.GlobalAvgPool2D)):
            return nd.Pooling(x, kernel=blk._kernel, stride=blk._stride,
                              pad=blk._pad, pool_type=blk._pool_type,
                              global_pool=blk._global,
                              count_include_pad=blk._count_include_pad,
                              layout=blk._layout)
        if isinstance(blk, nn.Flatten):
            return nd.Flatten(x)
        if isinstance(blk, nn.Dense):
            return nd.FullyConnected(x.astype(blk.weight.dtype),
                                     p(blk.weight), p(blk.bias),
                                     num_hidden=blk._units,
                                     no_bias=blk.bias is None)
        if isinstance(blk, (vision.BasicBlockV1, vision.BottleneckV1)):
            res = x if blk.downsample is None else layer(blk.downsample, x)
            return nd.Activation(nd.elemwise_add(layer(blk.body, x), res),
                                 act_type="relu")
        if isinstance(blk, (nn.HybridSequential, nn.Sequential)):
            for child in blk:
                x = layer(child, x)
            return x
        if isinstance(blk, vision.ResNetV1):
            return layer(blk.output, layer(blk.features, x))
        raise TypeError("legacy_resnet_v1: no legacy spelling of %s"
                        % type(blk).__name__)
    return layer(net, x)


def _wall_ms(fn, iters=10, warmup=2):
    """Mean host-clocked ms of ``fn()`` (synchronized before and after)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def imp_legacy_resnet(mt, dev, card):
    """ResNet-50 v1, B=32 bf16 NCHW, spelled in legacy ``mx.nd`` against
    ``net(x)``: the same torch calls, so bit for bit."""
    net = _resnet50(mt, dev).cast("bfloat16")
    x = torch.randn(IMP_B, 3, 224, 224, generator=torch.Generator(
        device=dev).manual_seed(21), device=dev).to(torch.bfloat16)
    xn = mt.nd.NDArray(x)
    with mt.autograd.pause():
        want = net(x)
        got = legacy_resnet_v1(mt, net, xn)._data
        same = torch.equal(got, want)
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        check(same or err <= IMP_LEGACY_REL * top,
              "legacy resnet50: max|d| %.4g over %.0e of max|logit| %.4g"
              % (err, IMP_LEGACY_REL, top))
        gluon_ms = _wall_ms(lambda: net(x))
        legacy_ms = _wall_ms(lambda: legacy_resnet_v1(mt, net, xn))
    print("imperative legacy resnet50 (B=%d bf16 NCHW, eager): legacy "
          "mx.nd spelling == net(x) bit for bit: %s (max|d| %.4g, max|logit| "
          "%.4g); %.0f images/s legacy (%.2f ms), %.0f images/s net(x) "
          "(%.2f ms), host-clocked [%s]"
          % (IMP_B, same, err, top, IMP_B / legacy_ms * 1e3, legacy_ms,
             IMP_B / gluon_ms * 1e3, gluon_ms, card))
    del net
    return {"same": same, "legacy_ms": legacy_ms, "gluon_ms": gluon_ms}


def _res(a, b):
    """||a - b||_F / ||b||_F in float64 on the card."""
    a, b = a.double(), b.double()
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def _orth(q):
    """||Q^T Q - I||_F / sqrt(n) in float64."""
    q = q.double()
    eye = torch.eye(q.shape[-1], dtype=torch.float64, device=q.device)
    return (torch.linalg.norm(q.mT @ q - eye) / q.shape[-1] ** 0.5).item()


def imp_linalg(mt, dev, card, n=IMP_LINALG_N):
    """``mx.np.linalg`` and ``mx.nd.linalg`` at n x n float32 (a Gaussian
    A, and S = A A^T / n + I, SPD with eigenvalues in about [1, 5]), each
    held by a residual computed in float64 on the card; the singular
    values and eigenvalues of a 12 x 64 x 64 batch against float64 numpy."""
    import numpy as onp
    np_, la, nd = mt.np, mt.np.linalg, mt.nd
    gen = torch.Generator(device=dev).manual_seed(22)
    A = torch.randn(n, n, generator=gen, device=dev) / n ** 0.5
    S = A @ A.T + torch.eye(n, device=dev)
    b = torch.randn(n, 1, generator=gen, device=dev)
    An, Sn, bn = (mt.nd.NDArray(t) for t in (A, S, b))
    eye64 = torch.eye(n, dtype=torch.float64, device=dev)
    res, ms = {}, {}

    def timed(name, fn):
        fn()                          # the library's first-call set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out
    q, r = timed("qr", lambda: la.qr(An))
    res["qr"] = max(_res(q._data @ r._data, A), _orth(q._data))
    u, s, vh = timed("svd", lambda: la.svd(An))
    res["svd"] = max(_res(u._data * s._data @ vh._data, A), _orth(u._data),
                     _orth(vh._data.T))
    # torch's default CUDA driver (gesvdj), which the port does not use:
    # its residuals for the record
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u2, s2, vh2 = torch.linalg.svd(A, full_matrices=False)
    torch.cuda.synchronize()
    gesvdj = ((time.perf_counter() - t0) * 1e3, _res(u2 * s2 @ vh2, A),
              _orth(u2), _orth(vh2.T))
    del u2, s2, vh2
    w, v = timed("eigh", lambda: la.eigh(Sn))
    res["eigh"] = max(_res(S.double() @ v._data.double(),
                           v._data.double() * w._data.double()),
                      _orth(v._data))
    L = timed("cholesky", lambda: la.cholesky(Sn))._data
    res["cholesky"] = _res(L @ L.T, S)
    x = timed("solve", lambda: la.solve(Sn, bn))._data
    res["solve"] = _res(S.double() @ x.double(), b)
    inv = timed("inv", lambda: la.inv(Sn))._data
    res["inv"] = (torch.linalg.norm(S.double() @ inv.double() - eye64)
                  / n ** 0.5).item()
    sign, logdet = timed("slogdet", lambda: la.slogdet(Sn))
    ref_sign, ref_logdet = torch.linalg.slogdet(S.double())
    check(sign.item() == ref_sign.item(), "slogdet: sign")
    res["slogdet"] = abs(logdet.item() - ref_logdet.item()) / abs(
        ref_logdet.item())
    xl = timed("lstsq", lambda: la.lstsq(Sn, bn))[0]._data
    res["lstsq"] = _res(S.double() @ xl.double(), b)
    pinv = timed("pinv", lambda: la.pinv(Sn))._data
    res["pinv"] = (torch.linalg.norm(S.double() @ pinv.double() - eye64)
                   / n ** 0.5).item()
    nrm = timed("norm", lambda: la.norm(An))
    res["norm"] = abs(nrm.item() - torch.linalg.norm(A.double()).item()) \
        / torch.linalg.norm(A.double()).item()
    C = timed("nd.gemm2", lambda: nd.linalg.gemm2(An, Sn))._data
    res["nd.gemm2"] = _res(C, A.double() @ S.double())
    Lp = timed("nd.potrf", lambda: nd.linalg.potrf(Sn))
    res["nd.potrf"] = _res(Lp._data @ Lp._data.T, S)
    Pi = timed("nd.potri", lambda: nd.linalg.potri(Lp))._data
    res["nd.potri"] = (torch.linalg.norm(S.double() @ Pi.double() - eye64)
                       / n ** 0.5).item()
    X = timed("nd.trsm", lambda: nd.linalg.trsm(Lp, An))._data
    res["nd.trsm"] = _res(torch.tril(Lp._data).double() @ X.double(), A)
    T = timed("nd.trmm", lambda: nd.linalg.trmm(Lp, An))._data
    res["nd.trmm"] = _res(T, torch.tril(Lp._data).double() @ A.double())
    K = timed("nd.syrk", lambda: nd.linalg.syrk(An))._data
    res["nd.syrk"] = _res(K, A.double() @ A.double().T)
    U, lam = timed("nd.syevd", lambda: nd.linalg.syevd(Sn))
    res["nd.syevd"] = max(_res(U._data.double().T * lam._data.double()
                               @ U._data.double(), S), _orth(U._data.T))
    Lq, Q = timed("nd.gelqf", lambda: nd.linalg.gelqf(An))
    res["nd.gelqf"] = max(_res(Lq._data @ Q._data, A), _orth(Q._data.T))
    Ii = timed("nd.inverse", lambda: nd.linalg.inverse(Sn))._data
    res["nd.inverse"] = (torch.linalg.norm(S.double() @ Ii.double() - eye64)
                         / n ** 0.5).item()
    sld = timed("nd.sumlogdiag", lambda: nd.linalg.sumlogdiag(Lp))
    ref = torch.log(torch.diagonal(Lp._data.double())).sum().item()
    res["nd.sumlogdiag"] = abs(sld.item() - ref) / abs(ref)
    bad = {k: v for k, v in res.items() if not v <= IMP_LINALG_TOL}
    check(not bad, "linalg residuals over %.0e: %s" % (IMP_LINALG_TOL, bad))
    # the batch at BERT-base's heads
    Bt = torch.randn(12, 64, 64, generator=gen, device=dev)
    St = Bt @ Bt.mT / 64 + torch.eye(64, device=dev)
    sv = la.svd(mt.nd.NDArray(Bt), compute_uv=False).asnumpy()
    ev = la.eigvalsh(mt.nd.NDArray(St)).asnumpy()
    sv64 = onp.linalg.svd(Bt.double().cpu().numpy(), compute_uv=False)
    ev64 = onp.linalg.eigvalsh(St.double().cpu().numpy())
    # a singular value within 1e-4 of its matrix's largest (float32's
    # normwise bound; the smallest of a Gaussian 64 x 64 are ~1e-2 of
    # it), an eigenvalue of S (in [1, 5]) within 1e-4 of itself
    batch_err = max(
        float((onp.abs(sv - sv64) / sv64.max(-1, keepdims=True)).max()),
        float((onp.abs(ev - ev64) / onp.abs(ev64)).max()))
    check(batch_err <= 1e-4, "linalg batch: singular values / eigenvalues "
          "off by %.3e (limit 1e-4)" % batch_err)
    w_eig, _ = la.eig(mt.nd.NDArray(St[0]))
    eig_err = float(onp.abs(onp.sort(w_eig.asnumpy().real) - ev64[0]).max()
                    / ev64[0].max())
    check(eig_err <= 1e-4, "linalg eig on CUDA: eigenvalues off by %.3e"
          % eig_err)
    print("imperative linalg n=%d float32, residual in float64 (limit "
          "%.0e) and ms: %s; 12x64x64 batch svd / eigvalsh vs float64 numpy "
          "rel err %.3e, eig (torch %s) %.3e; torch's default CUDA svd "
          "(gesvdj, not used) %.1f ms, ||USV-A|| %.2e, ||UtU-I|| %.2e, "
          "||VtV-I|| %.2e [%s]"
          % ((n, IMP_LINALG_TOL, ", ".join("%s %.2e %.1f ms" % (k, res[k],
                                                                ms[k])
                                           for k in res), batch_err,
              torch.__version__, eig_err) + gesvdj + (card,)))
    return {"n": n, "residual": res, "ms": ms, "batch_err": batch_err,
            "gesvdj": gesvdj}


def imp_fft(mt, dev, card):
    """``mx.np.fft`` on the ResNet-50 input batch: two round trips and
    rfft2 against float64 numpy."""
    import numpy as onp
    x = torch.randn(IMP_B, 3, 224, 224, generator=torch.Generator(
        device=dev).manual_seed(23), device=dev)
    xn = mt.nd.NDArray(x)
    fft = mt.np.fft
    top = x.abs().max().item()
    ms = {"rfft2": time_ms(lambda: fft.rfft2(xn)),
          "irfft2": 0.0, "fftn": time_ms(lambda: fft.fftn(xn))}
    spec = fft.rfft2(xn)
    ms["irfft2"] = time_ms(lambda: fft.irfft2(spec, s=(224, 224)))
    back = fft.irfft2(spec, s=(224, 224))._data
    full = fft.fftn(xn)
    ms["ifftn"] = time_ms(lambda: fft.ifftn(full))
    backn = fft.ifftn(full)._data.real
    e1 = (back - x).abs().max().item() / top
    e2 = (backn - x).abs().max().item() / top
    ref = onp.fft.rfft2(x.double().cpu().numpy())
    e3 = float(onp.abs(spec.asnumpy() - ref).max() / onp.abs(ref).max())
    check(e1 <= IMP_FFT_TOL and e2 <= IMP_FFT_TOL,
          "fft round trips off by %.3e / %.3e of max|x|" % (e1, e2))
    check(e3 <= IMP_FFT_REF_TOL, "rfft2 off float64 numpy by %.3e" % e3)
    print("imperative fft (%d, 3, 224, 224) float32: rfft2->irfft2 %.2e, "
          "fftn->ifftn %.2e of max|x| (limit %.0e), rfft2 vs float64 numpy "
          "%.2e of max|ref| (limit %.0e); ms %s [%s]"
          % (IMP_B, e1, e2, IMP_FFT_TOL, e3, IMP_FFT_REF_TOL,
             ", ".join("%s %.3f" % kv for kv in ms.items()), card))
    return {"ms": ms, "errs": (e1, e2, e3)}


def _image_pipeline(mt, imgs):
    img = mt.nd.image
    r = img.resize(imgs, 256, keep_ratio=True)
    c = img.crop(r, 16, 16, 224, 224)
    f = img.flip_left_right(c)
    t = img.to_tensor(f)
    return r, c, f, t, img.normalize(t, mean=(0.485, 0.456, 0.406),
                                     std=(0.229, 0.224, 0.225))


def imp_image(mt, dev, card):
    """``mx.nd.image`` on 128 uint8 224^2 x 3 images: resize (short side
    256), crop, flip, to_tensor, normalize, against the same calls on the
    CPU: resize within one step in uint8 and 1e-5 of max|x| in float32,
    the later steps (given the card's resize) bit for bit, normalize
    within 1e-5."""
    img = mt.nd.image
    gen = torch.Generator(device=dev).manual_seed(24)
    raw = torch.randint(0, 256, (IMP_IMAGES, 224, 224, 3), generator=gen,
                        device=dev, dtype=torch.uint8)
    got = _image_pipeline(mt, mt.nd.NDArray(raw))
    rf = img.resize(mt.nd.NDArray(raw.float()), 256, keep_ratio=True)._data
    with mt.cpu():
        r_cpu = img.resize(mt.nd.NDArray(raw.cpu()), 256, keep_ratio=True)
        rf_cpu = img.resize(mt.nd.NDArray(raw.float().cpu()), 256,
                            keep_ratio=True)._data
        c2 = img.crop(mt.nd.NDArray(got[0]._data.cpu()), 16, 16, 224, 224)
        f2 = img.flip_left_right(c2)
        t2 = img.to_tensor(f2)
        n2 = img.normalize(t2, mean=(0.485, 0.456, 0.406),
                           std=(0.229, 0.224, 0.225))
    diff = {"resize_uint8": (got[0]._data.cpu().int() - r_cpu._data.int())
            .abs().max().item(),
            "resize_float32": (rf.cpu() - rf_cpu).abs().max().item()
            / rf_cpu.abs().max().item(),
            "normalize": (got[4]._data.cpu() - n2._data).abs().max().item()}
    exact = all(torch.equal(a._data.cpu(), b._data) for a, b in
                zip(got[1:4], (c2, f2, t2)))
    check(diff["resize_uint8"] <= 1 and diff["resize_float32"] <= 1e-5
          and diff["normalize"] <= 1e-5 and exact,
          "nd.image card vs CPU: %s, crop / flip / to_tensor exact %s"
          % (diff, exact))
    ms = _wall_ms(lambda: _image_pipeline(mt, mt.nd.NDArray(raw)))
    print("imperative nd.image %d uint8 224^2 x 3: card vs CPU %s (limits: "
          "resize uint8 1, float32 1e-5 of max|x|, normalize 1e-5); crop / "
          "flip / to_tensor bit for bit: %s; the pipeline %.2f ms a batch, "
          "host-clocked [%s]"
          % (IMP_IMAGES, {k: "%.3g" % v for k, v in diff.items()}, exact, ms,
             card))
    return {"ms": ms, "diff": diff}


def _libsvm_file(path, seed=25):
    """IMP_SPARSE_ROWS rows of ~IMP_SPARSE_NNZ distinct sorted features
    out of IMP_SPARSE_DIM, values N(0, 1), labels 0 / 1."""
    import numpy as onp
    from mxnet_tpu_torch.utils.serialization import atomic_write
    rng = onp.random.RandomState(seed)
    rows = []
    with atomic_write(path, "w") as f:
        for _ in range(IMP_SPARSE_ROWS):
            k = rng.randint(IMP_SPARSE_NNZ // 2, IMP_SPARSE_NNZ * 3 // 2 + 1)
            cols = onp.sort(rng.choice(IMP_SPARSE_DIM, k, replace=False))
            vals = rng.randn(k).astype(onp.float32)
            lab = int(rng.rand() < 0.5)
            rows.append((cols, vals, lab))
            f.write("%d %s\n" % (lab, " ".join(
                "%d:%r" % (c, float(v)) for c, v in zip(cols, vals))))
    return rows


def _sparse_plain(rows, w0, steps):
    """The same 8 steps in scipy CSR float64 on the host: logistic loss,
    dense momentum SGD (lazy_update changes nothing)."""
    import numpy as onp
    import scipy.sparse as sps
    w = w0.astype(onp.float64).copy()
    mom = onp.zeros_like(w)
    losses = []
    for s in range(steps):
        part = rows[s * IMP_SPARSE_B:(s + 1) * IMP_SPARSE_B]
        X = sps.csr_matrix(
            (onp.concatenate([v for _, v, _ in part]).astype(onp.float64),
             onp.concatenate([c for c, _, _ in part]),
             onp.concatenate([[0], onp.cumsum([len(c) for c, _, _ in part])])),
            shape=(len(part), IMP_SPARSE_DIM))
        y = onp.asarray([lab for _, _, lab in part], onp.float64)[:, None]
        z = X @ w
        losses.append(float((onp.logaddexp(0, z) - y * z).mean()))
        g = X.T @ (1 / (1 + onp.exp(-z)) - y) / len(part)
        mom = 0.9 * mom - IMP_SPARSE_LR * g
        w = w + mom
    return losses, w


def imp_sparse(mt, co, dev, card, tmp):
    """Sparse logistic regression at avazu-app's width: LibSVMIter CSR
    batches, ``nd.sparse.dot``, a row_sparse gradient pushed to a local
    kvstore with SGD(momentum=0.9, lazy_update=True) (``multi_sgd`` on
    the card), rows pulled by the batch's indices; against scipy float64.
    Returns the launch counts of the steps."""
    import numpy as onp
    path = os.path.join(tmp, "avazu_like.libsvm")
    rows = _libsvm_file(path)
    it = mt.io.LibSVMIter(path, (IMP_SPARSE_DIM,), batch_size=IMP_SPARSE_B)
    w0 = onp.random.RandomState(26).randn(IMP_SPARSE_DIM, 1).astype(
        onp.float32) * 0.01
    kv = mt.kv.create("local")
    kv.init("w", mt.nd.array(w0))
    kv.set_optimizer(mt.optimizer.SGD(learning_rate=IMP_SPARSE_LR,
                                      momentum=0.9, lazy_update=True))
    w = mt.nd.zeros((IMP_SPARSE_DIM, 1))
    steps = IMP_SPARSE_ROWS // IMP_SPARSE_B
    losses, build_ms, step_ms = [], [], []
    co.reset_launch_counts()
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = it.next()
        csr, y = batch.data[0], batch.label[0].reshape((-1, 1))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kv.row_sparse_pull("w", out=w, row_ids=csr.indices)
        w.attach_grad()
        with mt.autograd.record():
            z = mt.nd.sparse.dot(csr, w)
            loss = (mt.np.logaddexp(0, z) - y * z).mean()
        loss.backward()
        kv.push("w", w.grad.tostype("row_sparse"))
        losses.append(loss.item())
        torch.cuda.synchronize()
        build_ms.append((t1 - t0) * 1e3)
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches = dict(co.LAUNCHES)
    final = mt.nd.zeros((IMP_SPARSE_DIM, 1))
    kv.pull("w", out=final)
    ref_losses, ref_w = _sparse_plain(rows, w0, steps)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    w_err = float(onp.abs(final.asnumpy() - ref_w).max()
                  / onp.abs(ref_w).max())
    check(loss_err <= IMP_SPARSE_RTOL and w_err <= IMP_SPARSE_RTOL,
          "sparse classifier vs scipy float64: losses %.3e, w %.3e (rtol "
          "%.0e)" % (loss_err, w_err, IMP_SPARSE_RTOL))
    check(launches["multi_sgd"] == steps, "sparse classifier: multi_sgd "
          "launched %d times in %d steps" % (launches["multi_sgd"], steps))
    nnz = sum(len(c) for c, _, _ in rows)
    print("imperative sparse logistic regression (%d x %d CSR batches of "
          "%d, %d nonzeros, dense-backed %.2f GB a batch): %d steps, losses "
          "%s vs scipy float64 max rel %.2e, final w %.2e of max|w| (rtol "
          "%.0e); %.2f ms a step, batch host build + copy %.2f ms (median); "
          "multi_sgd launches %d [%s]"
          % (IMP_SPARSE_ROWS, IMP_SPARSE_DIM, IMP_SPARSE_B, nnz,
             IMP_SPARSE_B * IMP_SPARSE_DIM * 4 / 1e9, steps,
             ["%.5f" % v for v in losses], loss_err, w_err,
             IMP_SPARSE_RTOL, sorted(step_ms)[steps // 2],
             sorted(build_ms)[steps // 2], launches["multi_sgd"], card))
    del it, kv, w, final
    return launches, {"step_ms": step_ms, "build_ms": build_ms}


def _ssd_inputs(mt, dev, seed=27):
    """SSD-300's six maps, B=32 labels (1-8 boxes, 20 classes), class
    scores and box offsets from a seed, on ``dev``."""
    import numpy as onp
    rng = onp.random.RandomState(seed)
    maps = [mt.nd.NDArray(torch.zeros(1, 1, s, s, device=dev))
            for s, _, _ in SSD_MAPS]
    lab = -onp.ones((IMP_B, 8, 5), onp.float32)
    for n in range(IMP_B):
        k = rng.randint(1, 9)
        xy = rng.rand(k, 2) * 0.7
        wh = 0.05 + rng.rand(k, 2) * 0.3
        lab[n, :k, 0] = rng.randint(0, SSD_CLASSES - 1, k)
        lab[n, :k, 1:3] = xy
        lab[n, :k, 3:5] = onp.minimum(xy + wh, 1.0)
    A = sum(s * s * (len(sz) + len(r) - 1) for s, sz, r in SSD_MAPS)
    cls = rng.randn(IMP_B, SSD_CLASSES, A).astype(onp.float32)
    loc = (rng.randn(IMP_B, A * 4) * 0.1).astype(onp.float32)
    nd = lambda a: mt.nd.NDArray(torch.from_numpy(a).to(dev))  # noqa
    return maps, nd(lab), nd(cls), nd(loc)


def _ssd_chain(mt, maps, lab, cls, prob, loc):
    c, npx = mt.nd.contrib, mt.npx
    out = {}
    for tag, prior, target, detect in (
            ("nd", c.MultiBoxPrior, c.MultiBoxTarget, c.MultiBoxDetection),
            ("npx", npx.multibox_prior, npx.multibox_target,
             npx.multibox_detection)):
        t0 = time.perf_counter()
        anchors = mt.np.concatenate([prior(m, sizes=sz, ratios=r)
                                     for m, (_, sz, r) in zip(maps,
                                                              SSD_MAPS)], 1)
        t1 = time.perf_counter()
        tgt = target(anchors, lab, cls, overlap_threshold=0.5,
                     negative_mining_ratio=3, negative_mining_thresh=0.5)
        t2 = time.perf_counter()
        det = detect(prob, loc, anchors, nms_threshold=0.45, nms_topk=400)
        det.wait_to_read()
        t3 = time.perf_counter()
        out[tag] = ([anchors] + list(tgt) + [det],
                    {"prior": (t1 - t0) * 1e3, "target": (t2 - t1) * 1e3,
                     "detection": (t3 - t2) * 1e3})
    return out


def imp_detection(mt, dev, card):
    """The SSD-300 MultiBox chain (nd.contrib and npx) on the card
    against the same calls on the CPU."""
    maps, lab, cls, loc = _ssd_inputs(mt, dev)
    # the class probabilities once, on the card: both chains decode the
    # same scores (a softmax on the CPU rounds differently, and the
    # order of near-equal scores decides NMS)
    prob = mt.npx.softmax(cls, axis=1)
    got = _ssd_chain(mt, maps, lab, cls, prob, loc)
    with mt.cpu():
        cpu_in = [[mt.nd.NDArray(m._data.cpu()) for m in maps]] + \
            [mt.nd.NDArray(a._data.cpu()) for a in (lab, cls, prob, loc)]
        want = _ssd_chain(mt, *cpu_in)
    report = {}
    for tag in ("nd", "npx"):
        (a, lt, lm, ct, det), ms = got[tag]
        (a2, lt2, lm2, ct2, det2), _ = want[tag]
        check(a.shape == (1, 8732, 4), "ssd anchors: %s" % (a.shape,))
        exact = all(torch.equal(x._data.cpu(), y._data) for x, y in
                    ((a, a2), (lt, lt2), (lm, lm2), (ct, ct2)))
        derr = (det._data.cpu() - det2._data).abs().max().item()
        kept = int((det._data[..., 0] >= 0).sum().item())
        pos = int((ct._data > 0).sum().item())
        check(exact and derr <= IMP_DET_TOL, "ssd %s: card vs CPU anchors / "
              "targets exact %s, detections max|d| %.3g" % (tag, exact, derr))
        report[tag] = ms
        print("imperative ssd300 %s MultiBox chain (B=%d, 8732 anchors, %d "
              "classes): anchors and targets == CPU %s, detections max|d| "
              "%.2g (limit %.0e); %d positive anchors, %d detections kept; "
              "ms %s [%s]" % (tag, IMP_B, SSD_CLASSES, exact, derr,
                              IMP_DET_TOL, pos, kept,
                              ", ".join("%s %.1f" % kv for kv in ms.items()),
                              card))
    return report


def imp_save_load(mt, dev, card, tmp):
    """``mx.nd.save`` / ``load`` of BERT-base's float32 parameters from the
    card, bit for bit."""
    net = mt.models.BERTForPretrain(mt.models.bert_base_config()).initialize(
        device=dev, generator=torch.Generator(device=dev).manual_seed(28))
    params = {n: mt.nd.NDArray(p.detach())
              for n, p in net.named_parameters()}
    count = sum(v.size for v in params.values())
    nbytes = sum(v.size * v.itemsize for v in params.values())
    path = os.path.join(tmp, "bert_base.params")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mt.nd.save(path, params)
    t1 = time.perf_counter()
    back = mt.nd.load(path)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(set(back) == set(params) and all(
        back[k]._data.device.type == "cuda" and
        torch.equal(back[k]._data, params[k]._data) for k in params),
        "nd.save / nd.load: BERT-base parameters differ")
    print("imperative nd.save / nd.load BERT-base float32 (%d arrays, %.1f M "
          "parameters, %.1f MB): bit for bit on the card; save %.0f MB/s, "
          "load %.0f MB/s (warm page cache) [%s]"
          % (len(params), count / 1e6, nbytes / 1e6, nbytes / 1e6 / (t1 - t0),
             nbytes / 1e6 / (t2 - t1), card))
    os.unlink(path)
    del net, params, back
    return {"save_mb_s": nbytes / 1e6 / (t1 - t0),
            "load_mb_s": nbytes / 1e6 / (t2 - t1)}


def imperative_phase(mt, co, dev, card):
    """The imperative surface on the card; returns the launch counts of
    the sparse classifier's steps (the ``imperative`` path)."""
    import tempfile
    t0 = time.monotonic()
    imp_legacy_resnet(mt, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    imp_linalg(mt, dev, card)
    imp_fft(mt, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    imp_image(mt, dev, card)
    with tempfile.TemporaryDirectory(prefix="mx_imp_") as tmp:
        launches, _ = imp_sparse(mt, co, dev, card, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        imp_detection(mt, dev, card)
        imp_save_load(mt, dev, card, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    print("imperative phase %.1f s [%s]" % (time.monotonic() - t0, card))
    return launches


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
    if argv[1:2] == ["--ring-rank"]:      # a child of ring_phase
        return ring_rank(int(argv[2]), *argv[3:5])
    if argv[1:2] == ["--serve-tp-rank"]:  # a child of serve_tp_phase
        return serve_tp_rank(int(argv[2]), argv[3], argv[4], int(argv[5]))
    if argv[1:2] == ["--elastic-rank"]:   # a child of elastic_phase
        return elastic_rank(int(argv[2]), argv[3], argv[4])
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
    if argv[1:] == ["--analysis"]:
        # only the analysis phase: the monitor and the checkers' gates
        launches = analysis_phase(mt, co, dev, card)
        check(all(launches[k] > 0 for k in ANALYSIS_KERNELS),
              "analysis: a kernel of the path was not launched: %s"
              % launches)
        print(card)
        return 0
    if argv[1:] == ["--data"]:
        # only the data phase
        resnet, lm = data_phase(mt, co, dev, card)
        check(all(resnet[k] > 0 for k in DATA_RESNET_KERNELS) and
              all(lm[k] > 0 for k in DATA_LM_KERNELS),
              "data: a kernel of the path was not launched: %s / %s"
              % (resnet, lm))
        print(card)
        return 0
    if argv[1:] == ["--imperative"]:
        # only the imperative surface's phase
        launches = imperative_phase(mt, co, dev, card)
        check(launches["multi_sgd"] > 0, "imperative: multi_sgd was not "
              "launched: %s" % launches)
        print(card)
        return 0
    if argv[1:] == ["--elastic"]:
        # only the elastic phase (its two pairs of rank children)
        elastic_phase(mt, co, dev, card)
        print(card)
        return 0
    if argv[1:] == ["--ring-nccl"]:
        # only the rank children's phases (ring, ep, dp_tp, pipeline,
        # kvstore), one NCCL rank a card (needs 4), then the
        # tensor-parallel server at tp=2 and tp=4 with its collectives
        # inside the captured graphs
        check(torch.cuda.device_count() >= RING_WORLD,
              "--ring-nccl needs %d cards" % RING_WORLD)
        ring_phase(co, dev, card, "nccl")
        gc.collect()
        torch.cuda.empty_cache()
        net = build_model(mt, dev, SERVE_TP_LAYERS)
        tp_reqs = make_tp_requests(net.cfg.vocab_size)
        one = {}
        for int8 in (False, True):
            srv = mt.serve.Server(net, mt.serve.ServeConfig(
                slots=8, page_size=128, pages=64, ladder=(128, 256, 512),
                max_new=TP_MAX_NEW, int8=int8))
            res, wall = serve_requests(srv, tp_reqs, TP_MAX_NEW)
            one["int8" if int8 else "bf16"] = [list(r["tokens"])
                                               for r in res]
            print("serve_tp one-rank %s: %.1f tokens/s, TTFT p50 %.1f ms "
                  "[%s]" % ("int8" if int8 else "bf16",
                            sum(len(r["tokens"]) for r in res) / wall,
                            _ttft_p50(res), card))
            del srv
            gc.collect()
            torch.cuda.empty_cache()
        for world in (2, 4):
            serve_tp_phase(mt, co, net, dev, card, tp_reqs, one, "nccl",
                           world)
        print(card)
        return 0
    check(len(argv) == 1, "usage: chip_smoke.py [--kernel-timing | "
          "--ring-nccl | --elastic | --analysis | --data | --imperative | "
          "--ring-rank "
          "RANK DIR "
          "[BACKEND] | "
          "--serve-tp-rank RANK DIR BACKEND WORLD | --elastic-rank RANK DIR "
          "PART]")
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
    srv, reqs, res, serve_launches, wall = serve_phase(mt, co, net, dev,
                                                       card)
    consistency_phase(net, reqs, res, dev)
    graph_phase(srv, reqs, res, "serve")
    step_timing(srv, reqs, res, card)
    tp_reqs, one_bf16 = control_plane_phase(mt, co, net, srv, reqs, res,
                                            wall, card)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    srv, reqs, res, serve_int8_launches, _ = serve_phase(mt, co, net, dev,
                                                         card, int8=True)
    consistency_phase(net, reqs, res, dev, srv.pool.int8)
    graph_phase(srv, reqs, res, "serve int8")
    step_timing(srv, reqs, res, card, "serve int8")
    one_int8 = [list(r["tokens"]) for r in
                serve_requests(srv, tp_reqs, TP_MAX_NEW)[0]]
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    serve_tp = serve_tp_phase(mt, co, net, dev, card, tp_reqs,
                              {"bf16": one_bf16, "int8": one_int8})
    del net                       # free the serving model for training
    gc.collect()
    torch.cuda.empty_cache()
    train_launches, lm_adamw, lm_finite = train_phase(mt, co, dev, card)
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
    gc.collect()
    torch.cuda.empty_cache()
    low_prec = low_precision_kernel_phase(co, dev, card)
    int8_resnet_launches, k2_rows = int8_resnet_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_paths, dw_rows = vision_zoo_phase(mt, co, dev, card)
    # K3 depthwise: its head is MobileNet v2's costliest shape
    k3_dw = low_prec[5]
    k3_dw["shapes"] = dw_rows
    k3_dw.update({k: max(dw_rows[:10], key=lambda r: r["launches"] *
                         r["ms"])[k]
                  for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms", "bf16_ms",
                            "general_ms")})
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    for rec, mode in ((low_prec[1], "nhwc"), (low_prec[2], "im2col")):
        rec["shapes"] = [r for r in k2_rows if r["mode"] == mode]
        rec.update({k: max(rec["shapes"], key=lambda r: r["bound_ms"])[k]
                    for k in keys})
    amp_bert_launches, amp_resnet_launches, guard_launches = amp_phase(
        mt, co, dev, card, low_prec[0])
    finite = low_prec[0]
    finite["shapes"].append(lm_finite)
    finite.update({k: finite["shapes"][0][k] for k in (
        "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    gc.collect()
    torch.cuda.empty_cache()
    (ring_launches, ring_block, dp_tp_launches, pipe_launches,
     kv_launches) = ring_phase(co, dev, card)
    moe_launches = moe_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    remat_launches = remat_phase(mt, co, dev, card)
    ckpt_launches = checkpoint_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    elastic_launches = elastic_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    analysis_launches = analysis_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    data_resnet_launches, data_lm_launches = data_phase(mt, co, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    imperative_launches = imperative_phase(mt, co, dev, card)

    for k in optim:
        if k["name"] == "multi_adam":
            k["shapes"] += lm_adamw
    # the ring's step shape and offsets, held against plain above
    flash["max_abs_err"] = max(flash["max_abs_err"], ring_block["o"])
    flash["max_abs_err_lse"] = max(flash["max_abs_err_lse"],
                                   ring_block["lse"])
    for k in flash_bwd:
        k["max_abs_err"] = max(k["max_abs_err"], ring_block["abs"])
        k["max_rel_err"] = max(k["max_rel_err"], ring_block["rel"])
    kernels = [flash] + flash_bwd + [paged] + general + optim + int8 \
        + low_prec
    paths = {"serve": serve_launches, "serve_int8": serve_int8_launches,
             "train": train_launches,
             "bert": bert_launches, "tiny_fp32": tiny_launches,
             "bert_fp32": bert_fp32_launches, "entry": entry_launches,
             "resnet": resnet_launches, "ring": ring_launches,
             "moe": moe_launches, "remat": remat_launches,
             "checkpoint": ckpt_launches, "dp_tp": dp_tp_launches,
             "pipeline": pipe_launches, "kvstore": kv_launches,
             "serve_tp": serve_tp["bf16"], "serve_tp_int8": serve_tp["int8"],
             "int8_resnet": int8_resnet_launches,
             "amp_bert": amp_bert_launches,
             "amp_resnet": amp_resnet_launches, "guard": guard_launches,
             "elastic": elastic_launches, "analysis": analysis_launches,
             "data_resnet": data_resnet_launches,
             "data_lm": data_lm_launches,
             "imperative": imperative_launches, **zoo_paths}
    for path, kernels_of_path in (
            ("int8_resnet", ("int8_quantize", "int8_quantize_im2col",
                             "int8_conv_hopper")),
            ("amp_bert", ("multi_all_finite", "flash_fwd_mma",
                          "flash_bwd_dq_mma", "flash_bwd_dkv_mma",
                          "multi_adam")),
            ("amp_resnet", ("multi_all_finite", "multi_sgd")),
            ("guard", ("multi_all_finite",)),
            ("serve_tp", ("flash_fwd", "paged_decode")),
            ("serve_tp_int8", ("flash_fwd", "paged_decode", "int8_linear",
                               "int8_dequant")),
            ("dp_tp", ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                       "multi_adam")),
            ("pipeline", ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
            ("kvstore", ("multi_sgd",)),
            ("elastic", ELASTIC_KERNELS),
            ("analysis", ANALYSIS_KERNELS),
            ("data_resnet", DATA_RESNET_KERNELS),
            ("data_lm", DATA_LM_KERNELS),
            ("imperative", ("multi_sgd",)),
            ("zoo_train", ("multi_sgd",)),
            ("zoo_int8", ("int8_quantize", "int8_quantize_im2col",
                          "int8_conv_hopper", "int8_conv_depthwise")),
            ("zoo_int8_v1", ("int8_quantize", "int8_quantize_im2col",
                             "int8_conv_hopper", "int8_conv_depthwise")),
            ("zoo_export", ("int8_quantize", "int8_quantize_im2col",
                            "int8_conv_hopper"))):
        check(all(paths[path][k] > 0 for k in kernels_of_path),
              "%s: a kernel of the path was not launched: %s"
              % (path, paths[path]))
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
