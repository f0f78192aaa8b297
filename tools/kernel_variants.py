"""Time variants of one kernel source against each other on one card.

    python3 tools/kernel_variants.py LIB VARIANT [VARIANT ...]

``LIB`` names a source of ``mxnet_tpu_torch/csrc`` (``int8_depthwise``:
``int8_conv.cu``'s depthwise route) with a timing case
here: ``flash_fwd_mma`` (BERT-base's float32 attention, q/k/v (16, 12,
512, 64) non-causal, and a causal GQA case for the error),
``paged_general`` (the float32 serving shape: 8 slots, lengths 51-347,
32/8 heads of 128, pages of 128), ``int8_conv`` (the hopper route at
``chip_smoke.INT8_CONV_TIMED``'s ResNet-50 shapes, B=32, float32 NCHW
out as ``QuantizedConv2D`` writes it, then bf16 NHWC and raw int32; each
by ``chip_smoke.graph_ms`` and ``chip_smoke.device_ms``) or
``int8_depthwise`` (K3's depthwise route at MobileNet v2's ten distinct
depthwise layers, B=32, float32 NCHW out with scale and bias, as
``QuantizedConv2D`` writes it; each by ``chip_smoke.graph_ms`` and
``chip_smoke.device_ms``, summed over the forward's 17 layers) or
``int8_linear`` (the bf16 decode's
five launches at M = 8, ``chip_smoke.INT8_SHAPES``, wq | wk | wv and
w1 | w3 stacked, each timed alone by ``chip_smoke.graph_ms`` and back to
back over distinct weights by ``chip_smoke.chain_ms``, both summed as a
decode step's 129 launches).
Each ``VARIANT`` is a ``.cu`` file written in place of ``csrc/LIB.cu`` (a
copy with text edits), optionally followed by ``@N`` to run it with
``cuda_ops.PAGED_TARGET_CTAS = N``.
Every variant is compiled with ``_build``'s flags (all ``nvcc`` at once,
into ``mxnet_tpu_torch/_build/variants``), loaded in place of the
library, held against the plain version on the card, and timed through
the public wrapper by ``chip_smoke.device_ms`` (own device time, L2
flushed), in the order given, in one process: list a variant twice to
see the spread.  It prints the card, each variant's registers, its
time, its error and its kernels' times.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.ops import _build, cuda_ops as co  # noqa: E402


def _compile(files):
    out = os.path.join(_build.BUILD, "variants")
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for i, f in enumerate(files):
        so = os.path.join(out, "%d_%s.so" % (i, os.path.basename(f)))
        jobs[f] = so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so,
             f], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for f, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print("FAILED", f, log[-3000:])
            continue
        regs = [ln.split("Used ")[1] for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f, "regs:", " | ".join(regs)[:600], flush=True)
        libs[f] = so
    return libs


# MobileNet v2 1.0's depthwise layers at 224^2, 3 x 3, padding 1: (C,
# H, stride, layers in the forward)
MOBILENET_V2_DW = [(32, 112, 1, 1), (96, 112, 2, 1), (144, 56, 1, 2),
                   (192, 56, 2, 1), (192, 28, 1, 2), (384, 28, 2, 1),
                   (384, 14, 1, 3), (576, 14, 1, 3), (960, 14, 2, 1),
                   (960, 7, 1, 2)]


def _case(lib_name, dev):
    """(run, errors, kernel-name match) of the timing case of LIB."""
    gen = torch.Generator().manual_seed(3)
    z = torch.zeros(1, dtype=torch.int32, device=dev)
    if lib_name == "flash_fwd_mma":
        B, H, Hkv, T, D, causal = cs.BERT_ATTN
        q, k, v = (torch.randn(B, n, T, D, generator=gen).to(dev)
                   for n in (H, Hkv, Hkv))
        qc, kc, vc = (torch.randn(1, n, 700, 64, generator=gen).to(dev)
                      for n in (32, 8, 8))
        with cs.exact_fp32():
            want = co._dense_with_lse(q, k, v, z, z, causal, D ** -0.5)[0]
            want_c = co._dense_with_lse(qc, kc, vc, z, z, True, 0.125)[0]

        def errors():
            return (cs._rel_err(co.flash_attention(q, k, v), want)[1],
                    cs._rel_err(co.flash_attention(qc, kc, vc, causal=True),
                                want_c)[1])
        return (lambda: co.flash_attention(q, k, v)), errors, "fwd_mma"
    if lib_name == "paged_general":
        S, H, Hkv, D, psz, MP = 8, 32, 8, 128, 128, 3
        lens = torch.tensor([51, 90, 128, 129, 200, 256, 300, 347],
                            dtype=torch.int32, device=dev)
        P = S * MP + 1
        q = torch.randn(S, H, D, generator=gen).to(dev)
        kp, vp = (torch.randn(P, Hkv, psz, D, generator=gen).to(dev)
                  for _ in range(2))
        pt = (torch.randperm(P - 1, generator=gen) + 1).reshape(S, MP).to(
            dev, torch.int32)

        def run():
            return co.paged_attention(q, kp, vp, pt, lens)

        def errors():
            with cs.exact_fp32():
                want = co._paged_dense(q, kp, vp, pt, lens, D ** -0.5)
            return (cs._rel_err(run(), want)[1],)
        return run, errors, "paged_general"
    if lib_name == "int8_conv":
        from mxnet_tpu_torch.ops import int8 as i8
        cases = []
        for name, N, C, H, W, O, k, s, p in cs.INT8_CONV_TIMED[1:]:
            x = torch.randn(N, C, H, W, generator=gen).to(dev)
            wq = torch.randint(-127, 128, (O, C, k, k), dtype=torch.int8,
                               generator=gen).to(dev)
            xq = i8.int8_quantize(x, 0.02).reshape(N, H, W, -1)
            wpk = i8.pack_conv_weight(wq, 1)
            sc, b = torch.full((O,), 1e-4, device=dev), torch.zeros(O,
                                                                    device=dev)
            for tag, kw in (("f32", dict(scale=sc, bias=b)),
                            ("bf16 nhwc", dict(scale=sc,
                                               out_dtype=torch.bfloat16,
                                               channels_last=True)),
                            ("i32", dict(out_dtype=torch.int32))):
                args = (xq, wpk, (k, k), (s, s), (p, p))
                cases.append(("%s %s" % (name, tag), args, kw,
                              i8.int8_conv_plain(*args, **kw)))

        def run():
            return {name: (cs.graph_ms(lambda: i8.int8_conv(*a, **kw)),
                           cs.device_ms(lambda: i8.int8_conv(*a, **kw),
                                        "conv_hopper")[0])
                    for name, a, kw, _ in cases}

        def errors():
            return (sum(not torch.equal(i8.int8_conv(*a, **kw), want)
                        for _, a, kw, want in cases),)
        return run, errors, None
    if lib_name == "int8_depthwise":
        from mxnet_tpu_torch.ops import int8 as i8
        cases = []
        for C, H, s, n in MOBILENET_V2_DW:
            x = torch.randn(32, C, H, H, generator=gen).to(dev)
            wq = torch.randint(-127, 128, (C, 1, 3, 3), dtype=torch.int8,
                               generator=gen).to(dev)
            args = (i8.int8_quantize(x, 0.02, C), i8.pack_conv_weight(wq, C),
                    (3, 3), (s, s), (1, 1), (1, 1), C)
            kw = dict(scale=torch.full((C,), 1e-4, device=dev),
                      bias=torch.zeros(C, device=dev))
            cases.append(("3x3/%d %d@%d" % (s, C, H), n, args, kw,
                          i8.int8_conv_plain(*args, **kw)))

        def run():
            return {name: (n, cs.graph_ms(lambda: i8.int8_conv(*a, **kw)),
                           cs.device_ms(lambda: i8.int8_conv(*a, **kw),
                                        "conv_depthwise")[0])
                    for name, n, a, kw, _ in cases}

        def errors():
            return (sum(not torch.equal(i8.int8_conv(*a, **kw), want)
                        for _, _, a, kw, want in cases),)
        return run, errors, None
    if lib_name == "int8_linear":
        from mxnet_tpu_torch.ops.int8 import (int8_linear_group,
                                              int8_linear_group_plain)
        cases = []
        for name, K, rows, per_step in cs.INT8_SHAPES:
            N, sc = sum(rows), [8e-4 * (1 + 0.25 * i) for i in range(
                len(rows))]
            # distinct weights past the 50 MB L2 for the back-to-back time
            qs = [torch.randint(-127, 128, (N, K), dtype=torch.int8,
                                device=dev)
                  for _ in range(max(2, -(-100 * 2 ** 20 // (N * K))))]
            x = torch.randn(8, K, generator=gen).to(dev, torch.bfloat16)
            cases.append((name, per_step, qs, x, rows, sc, torch.cat(
                int8_linear_group_plain(x, qs[0], rows, sc), 1).float()))

        def group(x, q, rows, sc):
            return torch.cat(int8_linear_group(x, q, rows, sc), 1)

        def run():
            return {name: (per, cs.graph_ms(lambda: int8_linear_group(
                x, qs[0], rows, sc)), cs.chain_ms([
                    lambda q=q: int8_linear_group(x, q, rows, sc)
                    for q in qs]),
                cs.device_ms(lambda: int8_linear_group(x, qs[0], rows, sc),
                             "int8_linear")[0])
                    for name, per, qs, x, rows, sc, _ in cases}

        def errors():
            return tuple((group(x, qs[0], rows, sc).float() - want).abs()
                         .max().item() / want.abs().max().item()
                         for _, _, qs, x, rows, sc, want in cases)
        return run, errors, None
    raise SystemExit("no timing case for %r" % lib_name)


def main(argv):
    if len(argv) < 3 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    lib_name, specs = argv[1], argv[2:]
    print(cs.card_line(), flush=True)
    _build.build_all()
    libs = _compile(list(dict.fromkeys(s.split("@")[0] for s in specs)))
    run, errors, match = _case(lib_name, torch.device("cuda"))
    target = co.PAGED_TARGET_CTAS
    for spec in specs:
        f, _, n = spec.partition("@")
        if f not in libs:
            continue
        lib = ctypes.CDLL(libs[f])
        source = "int8_conv" if lib_name == "int8_depthwise" else lib_name
        _build._declare(source, lib)
        _build._libs[source] = lib
        co.PAGED_TARGET_CTAS = int(n) if n else target
        errs = errors()
        if lib_name == "int8_conv":
            times = run()
            print("%-40s unequal cases %d; (graph_ms, device_ms) %s"
                  % (spec, errs[0], {k: (round(a, 4), round(b, 4))
                                     for k, (a, b) in times.items()}),
                  flush=True)
            continue
        if lib_name == "int8_depthwise":
            times = run()
            print("%-40s unequal cases %d; the forward's 17: %.4f ms by "
                  "graph_ms, %.4f ms by the profiler; per shape (graph_ms, "
                  "device_ms) %s"
                  % (spec, errs[0], sum(n * a for n, a, _ in times.values()),
                     sum(n * b for n, _, b in times.values()),
                     {k: (round(a, 4), round(b, 4))
                      for k, (_, a, b) in times.items()}), flush=True)
            continue
        if lib_name == "int8_linear":
            times = run()
            print("%-40s step %.4f ms alone, %.4f ms back to back, %.4f ms "
                  "by the profiler  err %s  per shape (alone, back to back, "
                  "profiler) %s"
                  % (spec, sum(n * a for n, a, _, _ in times.values()),
                     sum(n * b for n, _, b, _ in times.values()),
                     sum(n * c for n, _, _, c in times.values()),
                     ["%.2e" % e for e in errs],
                     {k: (round(a, 4), round(b, 4), round(c, 4))
                      for k, (_, a, b, c) in times.items()}),
                  flush=True)
            continue
        ms, per = cs.device_ms(run, match)
        print("%-40s %.4f ms  err %s  kernels %s"
              % (os.path.basename(spec), ms, ["%.2e" % e for e in errs],
                 {k.replace("void (anonymous namespace)::", "")
                  .split("(")[0]: round(v, 4) for k, v in per.items()}),
              flush=True)
    co.PAGED_TARGET_CTAS = target
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
