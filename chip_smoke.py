"""Chip smoke test of mxnet_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``mxnet_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, checks one
training step of a small bf16 model on the card against the CPU, serves
a Llama-3-8B-width ``TransformerLM`` (random weights from a seed)
through the port's ``Server`` and checks the served tokens against a
full-sequence forward, then trains an 8-layer Llama-3-8B-width model
through ``TrainStep`` and the Gluon ``Trainer``.  Each path runs with
the launch counts reset before it and read after it, and fails unless
every kernel it goes through was launched.
The last line is ``{"ok": true, "device": {...}}``; any failure exits
non-zero before it.  Without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import gc
import json
import os
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
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
FLUSH_BYTES = 256 << 20         # > the 50 MB L2: every timed call is cold


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
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
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


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
# phase 2: flash forward kernel vs plain _dense_with_lse
# ----------------------------------------------------------------------
def flash_phase(co, dev):
    gen = torch.Generator(device="cpu").manual_seed(1)
    H, Hkv, D = 32, 8, 128
    # (B, T, Tk, causal, q_off, k_off); the last is the training path's
    # shape, q (2,32,1024,128) causal over k/v (2,8,1024,128)
    cases = [(1, 128, 128, True, 0, 0), (1, 128, 128, False, 0, 0),
             (1, 512, 512, True, 0, 0), (1, 512, 512, False, 0, 0),
             (1, 300, 300, True, 0, 0), (1, 300, 300, False, 0, 0),
             # a later ring step: rows 0..99 of q see no key at all
             (1, 300, 428, True, 28, 128), (2, 1024, 1024, True, 0, 0)]
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
        print("flash B=%d T=%d Tk=%d causal=%s q_off=%d k_off=%d: max|dO| "
              "%.3e max|dlse| %.3e masked rows %d"
              % (B, T, Tk, causal, qo, ko, eo, el, int(masked.sum())))
        check(eo <= FLASH_O_ATOL and el <= FLASH_LSE_ATOL,
              "flash kernel disagrees with plain: %.3e / %.3e (limits "
              "%.0e / %.0e)" % (eo, el, FLASH_O_ATOL, FLASH_LSE_ATOL))
        err_o, err_l = max(err_o, eo), max(err_l, el)

    # timing at the main path's largest prefill: q (1,32,512,128) causal
    T = 512
    q = torch.randn(1, H, T, D, generator=gen).to(dev, torch.bfloat16)
    k = torch.randn(1, Hkv, T, D, generator=gen).to(dev, torch.bfloat16)
    v = torch.randn(1, Hkv, T, D, generator=gen).to(dev, torch.bfloat16)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: co.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: co._dense_with_lse(q, k, v, zero, zero, True,
                                                  D ** -0.5))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    nbytes = 2 * (2 * H * T * D + 2 * Hkv * T * D) + 4 * H * T
    flops = 4 * D * H * (T * (T + 1) // 2)          # visible pairs only
    b_ms, b_by = bound_ms(nbytes, flops)
    print("flash timing q(1,32,512,128) causal: kernel %.4f ms, plain %.4f "
          "ms, SDPA %.4f ms, bound %.4f ms (%s)"
          % (ms, plain_ms, lib_ms, b_ms, b_by))
    return {"name": "flash_fwd", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "mxnet_tpu/ops/pallas_ops.py:62",
            "max_abs_err": err_o, "max_abs_err_lse": err_l, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


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


def flash_bwd_phase(co, dev, card):
    gen = torch.Generator(device="cpu").manual_seed(4)
    H, Hkv = 32, 8
    # (B, T, Tk, causal, q_off, k_off, D); the last is the training
    # path's shape, q (2,32,1024,128) causal over k/v (2,8,1024,128),
    # whose inputs are also the timed ones
    cases = [(1, 128, 128, True, 0, 0, 128), (1, 128, 128, False, 0, 0, 128),
             (1, 300, 300, True, 0, 0, 128), (1, 300, 300, False, 0, 0, 128),
             (1, 1024, 1024, True, 0, 0, 128),
             (1, 1024, 1024, False, 0, 0, 128),
             # a later ring step: rows 0..99 of q see no key at all
             (1, 300, 428, True, 28, 128, 128), (1, 300, 300, True, 0, 0, 64),
             (2, 1024, 1024, True, 0, 0, 128)]
    worst = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    abs_err = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for B, T, Tk, causal, qo, ko, D in cases:
        q, k, v, do, o, lse, dlse, delta, offs = _bwd_inputs(
            co, gen, dev, B, H, Hkv, T, Tk, D, causal, qo, ko)
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
        got = co._flash_bwd_cuda(q, k, v, do, lse, delta, *offs, causal,
                                 D ** -0.5)
        want = co._flash_bwd_dense(q, k, v, do, lse, delta, *offs, causal,
                                   D ** -0.5)
        torch.cuda.synchronize()
        rel = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g.float() - w).abs().max().item()
            rel[name] = err / w.abs().max().item()
            abs_err[name] = max(abs_err[name], err)
            worst[name] = max(worst[name], rel[name])
        check(not got[0][masked[..., None].expand_as(got[0])].any(),
              "flash bwd: dq of a fully masked row is not zero")
        print("flash bwd B=%d T=%d Tk=%d causal=%s q_off=%d k_off=%d D=%d: "
              "forward max|dO| %.3e max|dlse| %.3e; max|d|/max|plain| dq "
              "%.3e dk %.3e dv %.3e, masked rows %d"
              % (B, T, Tk, causal, qo, ko, D, eo, el, rel["dq"], rel["dk"],
                 rel["dv"], int(masked.sum())))
        check(max(rel.values()) <= FLASH_BWD_TOL,
              "flash bwd kernels disagree with plain: %s (limit %.0e)"
              % (rel, FLASH_BWD_TOL))
        del got, want

    # timing on the training shape's inputs, the last case above
    args = (q, k, v, do, lse, delta, *offs, True, D ** -0.5)
    dq_ms = time_ms(lambda: co._flash_bwd_dq_cuda(*args))
    dkv_ms = time_ms(lambda: co._flash_bwd_dkv_cuda(*args))
    delta_ms = time_ms(lambda: (do.float() * o.float()).sum(-1) - dlse)
    plain_ms = time_ms(lambda: co._flash_bwd_dense(*args), iters=5)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out, lse_g = co.flash_attention_with_lse(qg, kg, vg, causal=True)
    port_ms = time_ms(lambda: torch.autograd.grad(
        (out, lse_g), (qg, kg, vg), (do, dlse), retain_graph=True))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ref = sdpa(qg, kg, vg, is_causal=True, enable_gqa=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        ref, (qg, kg, vg), do, retain_graph=True))
    pairs = B * H * T * (T + 1) // 2                 # visible pairs only
    reads = 2 * (2 * B * H * T * D + 2 * B * Hkv * T * D) + 2 * 4 * B * H * T
    dq_b = bound_ms(reads + 2 * B * H * T * D, 6 * D * pairs)
    dkv_b = bound_ms(reads + 2 * 2 * B * Hkv * T * D, 8 * D * pairs)
    print("flash bwd timing q(2,32,1024,128) causal, kv (2,8,1024,128): "
          "dq %.4f ms (bound %.4f, %s), dkv %.4f ms (bound %.4f, %s), "
          "delta pass %.4f ms, whole port backward %.4f ms, plain %.4f ms, "
          "SDPA backward %.4f ms [%s]"
          % (dq_ms, dq_b[0], dq_b[1], dkv_ms, dkv_b[0], dkv_b[1], delta_ms,
             port_ms, plain_ms, lib_ms, card))
    common = {"route": "cuda", "source": "mxnet_tpu_torch/csrc/flash_bwd.cu",
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "backward_ms": port_ms, "delta_ms": delta_ms}
    return [dict(common, name="flash_bwd_dq",
                 replaces="mxnet_tpu/ops/pallas_ops.py:149",
                 max_abs_err=abs_err["dq"], max_rel_err=worst["dq"],
                 ms=dq_ms, bound_ms=dq_b[0], bound_by=dq_b[1]),
            dict(common, name="flash_bwd_dkv",
                 replaces="mxnet_tpu/ops/pallas_ops.py:227",
                 max_abs_err=max(abs_err["dk"], abs_err["dv"]),
                 max_rel_err=max(worst["dk"], worst["dv"]),
                 ms=dkv_ms, bound_ms=dkv_b[0], bound_by=dkv_b[1])]


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
    gen = torch.Generator(device="cpu").manual_seed(2)
    S, H, Hkv, D, psz, MP, P = 8, 32, 8, 128, 128, 5, 64
    q = torch.randn(S, H, D, generator=gen).to(dev, torch.bfloat16)
    kp = torch.randn(P, Hkv, psz, D, generator=gen).to(dev, torch.bfloat16)
    vp = torch.randn(P, Hkv, psz, D, generator=gen).to(dev, torch.bfloat16)
    # scattered page ids (never the trash page), ragged lengths with an
    # empty slot, one exactly full page and a full table
    pt = (torch.randperm(P - 1, generator=gen)[:S * MP] + 1).reshape(S, MP)
    pt = pt.to(dev, torch.int32)
    lens_h = [0, 37, 128, 129, 300, 450, 531, 640]
    lens = torch.tensor(lens_h, dtype=torch.int32, device=dev)
    out = co.paged_attention(q, kp, vp, pt, lens)
    want = co._paged_dense(q, kp, vp, pt, lens, D ** -0.5)
    torch.cuda.synchronize()
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    # the largest excess over the limit atol + rtol*|plain|, <= 0 to pass
    excess = (diff - PAGED_ATOL - PAGED_RTOL * want.float().abs()).max()
    print("paged S=8 lengths %s: max|dO| %.3e, limit %.0e + %.0e*|O| "
          "exceeded by %.3e, empty slot max %.1f"
          % (lens_h, err, PAGED_ATOL, PAGED_RTOL, excess.item(),
             out[0].abs().max().item()))
    check(excess.item() <= 0, "paged kernel disagrees with plain: max|dO| "
          "%.3e, over the limit by %.3e" % (err, excess.item()))
    check(not out[0].any().item(), "paged: an empty slot is not zero")
    ms = time_ms(lambda: co.paged_attention(q, kp, vp, pt, lens))
    plain_ms = time_ms(lambda: co._paged_dense(q, kp, vp, pt, lens,
                                               D ** -0.5))
    live = sum(lens_h)
    nbytes = 2 * live * Hkv * D * 2 + 2 * 2 * S * H * D + 4 * (S * MP + S)
    flops = 4 * live * H * D
    b_ms, b_by = bound_ms(nbytes, flops)
    print("paged timing: kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s)"
          % (ms, plain_ms, b_ms, b_by))
    return {"name": "paged_decode", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/paged_decode.cu",
            "replaces": "mxnet_tpu/ops/pallas_ops.py:621",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


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


def serve_phase(mt, co, net, dev, card, max_new=32):
    scfg = mt.serve.ServeConfig(slots=8, page_size=128, pages=64,
                                ladder=(128, 256, 512), max_new=max_new)
    srv = mt.serve.Server(net, scfg)
    print("KV pool %.3f GB on %s" % (srv.pool.stats["pool_bytes"] / 1e9,
                                     dev))
    copies = []
    copy_page = srv.pool.copy_page

    def counting_copy(src, dst):
        copies.append((src, dst))
        copy_page(src, dst)

    srv.pool.copy_page = counting_copy
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
    for name in ("flash_fwd", "paged_decode"):
        check(launches[name] > 0, "kernel %s was not launched on the "
              "serve path" % name)
    ntok = sum(len(r["tokens"]) for r in res)
    ttft = sorted(r["t_first"] - r["t_submit"] for r in res)
    steps = launches["paged_decode"] // net.cfg.n_layers
    print("serve: %d requests, %d tokens in %.3f s = %.1f tokens/s; TTFT "
          "p50 %.1f ms; %d decode steps; launches %s; COW copies %d; "
          "prefix hits %d [%s]"
          % (len(res), ntok, wall, ntok / wall, 1e3 * ttft[len(ttft) // 2],
             steps, launches, len(copies),
             srv.sched.stats()["prefix_hits"], card))
    return srv, reqs, res, launches


def device_busy(fn, reps=5):
    """(host ms per call, device ms per call, top kernels, counts) of
    ``fn``: host time synchronized and unprofiled; device time the sum of
    the CUDA kernels' self time in a torch.profiler trace of the same
    calls; counts per call from that trace -- top-level aten ops, aten op
    events at every level, and device events (kernels, memcpy, memset)."""
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
                              / 1e3) for e in top], counts


def step_timing(srv, reqs, res, card):
    """Host time of one decode step (8 active slots at the lengths the
    served requests reached) and of one solo 500-token prefill (ladder
    rung 512), each synchronized, beside the device time of their
    kernels from a profiler trace."""
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
    out = {}
    for name, fn in (
            ("decode step", lambda: pool.run_decode(
                table, lengths, tokens, active).cpu()),
            ("prefill T=512", lambda: pool.run_prefill(
                padded, row, len(prompt)))):
        ms, dev_ms, top, counts = device_busy(fn)
        out[name] = ms
        print("%s: %.2f ms host, %.2f ms of kernels (device busy %.1f%%) "
              "[%s]; top kernels (ms per call): %s"
              % (name, ms, dev_ms, 100 * dev_ms / ms, card,
                 "; ".join("%s %.3f" % t for t in top)))
        ops = counts["top-level aten ops"]
        print("%s: per call %s; host us per top-level op %.2f"
              % (name, ", ".join("%s %.1f" % kv for kv in counts.items()),
                 1e3 * ms / ops if ops else float("nan")))
    return out


# ----------------------------------------------------------------------
# phase 7: served tokens vs a full-sequence forward (teacher forced)
# ----------------------------------------------------------------------
def consistency_phase(net, reqs, res, dev, gap_tol=0.1):
    greedy = [i for i, (p, sp) in enumerate(reqs) if sp is None
              and (len(p) + len(res[i]["tokens"]) - 1) % 64]
    ties = checked = 0
    with torch.no_grad():
        for i in greedy[-2:]:
            prompt, served = reqs[i][0], list(res[i]["tokens"])
            seq = torch.tensor([prompt + served[:-1]], device=dev)
            logits = net(seq)[0, len(prompt) - 1:].float()
            top2 = logits.topk(2, dim=-1).values
            gap = top2[:, 0] - top2[:, 1]
            am = logits.argmax(dim=-1).tolist()
            for pos, (a, s) in enumerate(zip(am, served)):
                checked += 1
                if gap[pos].item() < gap_tol:
                    ties += 1
                    continue
                check(a == s, "request %d position %d: served %d, full "
                      "forward %d (gap %.3f)" % (i, pos, s, a,
                                                 gap[pos].item()))
            print("consistency: request %d (T=%d) matches the full forward"
                  % (i, seq.shape[1]))
    print("consistency: %d positions checked, %d near-ties (top-2 gap < "
          "%.1f) skipped" % (checked, ties, gap_tol))
    check(checked - ties > 0, "no position was checked")


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
    unchanged = [n for n, p in net.named_parameters()
                 if torch.equal(p.detach().cpu(), before[n])]
    check(not unchanged, "train: parameters did not change: %s" % unchanged)
    del before, trainer, loss
    torch.cuda.empty_cache()

    params = list(net.parameters())
    fb_ms, fb_dev, _, _ = device_busy(
        lambda: torch.autograd.grad(fwd(net, toks, labels), params), reps=2)
    step = mt.parallel.TrainStep(net, None,
                                 mt.optimizer.AdamW(learning_rate=1e-3),
                                 forward_fn=fwd)
    ms, dev_ms, top, counts = device_busy(lambda: step(toks, labels).item(),
                                          reps=2)
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
          "of kernels" % (fb_ms, fb_dev, net.num_params() / 1e9,
                          dev_ms - fb_dev))
    print("train step: per step %s" % ", ".join("%s %.1f" % kv
                                                for kv in counts.items()))
    return launches


def main():
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

    flash = flash_phase(co, dev)
    flash_bwd = flash_bwd_phase(co, dev, card)
    parity_phase(mt, co, dev, card)
    paged = paged_phase(co, dev)

    n_layers = 32
    net = build_model(mt, dev, n_layers)
    print("model: llama3_8b_config widths, %d layers, %.2f GB of bf16 "
          "weights" % (n_layers, sum(p.numel() for p in net.parameters())
                       * 2 / 1e9))
    srv, reqs, res, serve_launches = serve_phase(mt, co, net, dev, card)
    consistency_phase(net, reqs, res, dev)
    step_timing(srv, reqs, res, card)
    del srv, net                  # free the serving model for training
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = train_phase(mt, co, dev, card)

    kernels = [flash] + flash_bwd + [paged]
    for k in kernels:
        by_path = {"serve": serve_launches[k["name"]],
                   "train": train_launches[k["name"]]}
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
    print("total %.1f s" % (time.monotonic() - t_start))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
