"""Compare the int8 paths of two checkouts of the port on one card, in
alternating pairs.

    python3 tools/int8_ab.py [--pairs N] [--out FILE] [--resnet-only]
        TREE_A TREE_B

Each ``TREE`` is the root of a checkout of this repository (say the
parent commit unpacked by ``git archive`` beside this one).  One worker
process a tree imports that tree's ``mxnet_tpu_torch`` (its kernels
built into its own ``_build``) and this file's ``chip_smoke.py`` for the
helpers, so both trees are driven by the same code: the int8 server (32
layers at Llama-3-8B width, random weights from seed 0, 8 slots, the 16
requests of ``chip_smoke.make_requests``, 32 new tokens) and the int8
ResNet-50 (``quantize_net`` naive, B=32, hybridized).  Both workers set
up once, then measure in turn: pair ``i`` runs A then B when ``i`` is
even and B then A when it is odd, one measurement at a time, so the
card runs one tree at a time.  A measurement is:

* ``tokens_per_s``: the 16 requests served three times over
  (``serve_requests``), all their tokens over all their wall time;
* ``decode_ms`` / ``decode_kernel_ms``: one decode step through the
  pool's graph (8 active slots at the lengths the served requests
  reached, as ``chip_smoke.step_timing`` times it), host time and the
  kernels' time, each over 50 steps (``chip_smoke.device_busy``);
* ``products_ms``: a decode step's 225 int8 products (32 layers of
  wq, wk, wv, wo, w1, w3, w2 and the head, distinct random weights,
  7.5 GB) back to back in one CUDA graph, L2 flushed
  (``chip_smoke.chain_ms``), launched as the tree's decode launches
  them: wq | wk | wv and w1 | w3 as one launch each where the tree has
  ``int8_linear_group``;
* ``images_per_s`` / ``resnet_kernel_ms``: one hybridized forward
  (``chip_smoke._forward_row``); ``k2_ms``: its ``int8_quantize``
  kernels' device time in that forward (every kernel whose name holds
  ``quantize_``: 54 launches); ``stem_ms``: the stem layer alone (its
  quantize and convolution, as the tree runs them) captured in one CUDA
  graph and replayed, L2 flushed (``chip_smoke.graph_ms``);
* ``eager_images_per_s`` / ``eager_host_ms``: one eager forward of a
  second net quantized the same way, host clock; ``eager_layer_us``:
  the host time of one quantized layer's call in it (forward hooks
  around each of the 54, mean), and ``eager_other_ms`` the forward's
  host time outside them.

``--resnet-only`` leaves the server out: the ResNet-50 metrics alone.

It prints the card, each run, and for each metric each side's median
and quartiles, the pairs B won (ties counting for neither) and the
spread of A's own runs (the distance between its quartiles), and writes
every run to ``--out`` as JSON.
"""
import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the decode's int8 products of one layer, in decode order: (K, the
#: rows of the weights that read the same input)
LAYER_ORDER = [(4096, (4096, 1024, 1024)), (4096, (4096,)),
               (4096, (14336, 14336)), (14336, (4096,))]
#: each metric and whether more is better
METRICS = {"tokens_per_s": True, "decode_ms": False,
           "decode_kernel_ms": False, "products_ms": False,
           "images_per_s": True, "resnet_kernel_ms": False, "k2_ms": False,
           "stem_ms": False, "eager_images_per_s": True,
           "eager_host_ms": False, "eager_layer_us": False,
           "eager_other_ms": False}
SERVE_METRICS = ("tokens_per_s", "decode_ms", "decode_kernel_ms",
                 "products_ms")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _decode_step(srv, reqs, res):
    """One decode step of 8 active slots, at the lengths ``res`` reached,
    through the pool's graph, synchronized by its copy back."""
    import numpy as onp
    pool = srv.pool
    S, MP = pool.spec.slots, pool.spec.max_pages_per_slot
    table = onp.arange(1, 1 + S * MP, dtype=onp.int32).reshape(S, MP)
    lengths = onp.array([min(len(p) + 31, MP * 128 - 1)
                         for p, _ in reqs[:S]], onp.int32)
    tokens = onp.array([r["tokens"][-1] for r in res[:S]], onp.int32)
    return pool.run_decode(table, lengths, tokens, onp.ones(S, bool)).cpu()


def _eager_host(mt, q, net, x):
    """Host ms of one eager forward of ``net`` on ``x`` (synchronized),
    and the host us of each quantized layer's call inside it (forward
    hooks around each), over 5 forwards after one warm-up."""
    import time

    import torch
    spans, starts = [], {}
    hooks = []
    for m in net.modules():
        if isinstance(m, (q.QuantizedConv2D, q.QuantizedDense)):
            hooks.append(m.register_forward_pre_hook(
                lambda b, a: starts.__setitem__(id(b), time.perf_counter())))
            hooks.append(m.register_forward_hook(
                lambda b, a, o: spans.append(time.perf_counter()
                                             - starts[id(b)])))
    with mt.autograd.pause():
        net(x)
        torch.cuda.synchronize()
        spans.clear()
        t0 = time.perf_counter()
        for _ in range(5):
            net(x)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / 5 * 1e3
    for h in hooks:
        h.detach()
    layer_us = sum(spans) / len(spans) * 1e6
    return host, layer_us, host - sum(spans) / 5 * 1e3


def worker(tree, resnet_only=False):
    """Set up ``tree``'s int8 server (unless ``resnet_only``) and
    ResNet-50, then answer each ``run`` line of stdin with one
    measurement, a JSON line on stdout (every other print goes to
    stderr)."""
    out, sys.stdout = sys.stdout, sys.stderr
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.contrib import quantization as q
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import int8 as i8
    assert os.path.dirname(os.path.dirname(mt.__file__)) == \
        os.path.abspath(tree), mt.__file__
    cs = _chip_smoke()
    dev = torch.device("cuda")
    card = cs.card_line()
    _build.build_all()
    if not resnet_only:
        net = cs.build_model(mt, dev, 32)
        srv = mt.serve.Server(net, mt.serve.ServeConfig(
            slots=8, page_size=128, pages=64, ladder=(128, 256, 512),
            max_new=32, int8=True))
        reqs = cs.make_requests(net.cfg.vocab_size)
        res, _ = cs.serve_requests(srv, reqs, 32)           # warm
    gen = torch.Generator(device=dev).manual_seed(41)
    xs = {K: torch.randn(8, K, generator=gen, device=dev).to(torch.bfloat16)
          for K in (4096, 14336)}
    shapes = [sh for _ in range(32) for sh in LAYER_ORDER] + [
        (4096, (128256,))]
    group = getattr(i8, "int8_linear_group", None)

    def products(K, rows, w):
        x = xs[K]
        if group is not None:
            return group(x, w, rows, [8e-4] * len(rows))
        r0 = 0
        for r in rows:
            i8.int8_linear(x, w[r0:r0 + r], 8e-4)
            r0 += r

    x = torch.rand(cs.INT8_RESNET_B, 3, 224, 224, generator=gen, device=dev)
    nets = []
    for _ in range(2):               # hybridized, and eager
        resnet = cs._resnet50(mt, dev)
        with mt.autograd.pause():
            resnet(x[:1])
        q.quantize_net(resnet, calib_data=[x], calib_mode="naive")
        nets.append(resnet)
    resnet, eager = nets
    stem = next(m for m in eager.modules()      # never hybridized
                if isinstance(m, q.QuantizedConv2D))
    resnet.hybridize()
    with mt.autograd.pause():
        resnet(x)
    print("ready", tree, card, flush=True)
    for line in sys.stdin:
        if line.strip() != "run":
            break
        got = {}
        if not resnet_only:
            ntok = wall = 0
            for _ in range(3):
                res, w = cs.serve_requests(srv, reqs, 32)
                ntok += sum(len(r["tokens"]) for r in res)
                wall += w
            got["tokens_per_s"] = ntok / wall
            got["decode_ms"], got["decode_kernel_ms"] = cs.device_busy(
                lambda: _decode_step(srv, reqs, res), reps=50)[:2]
            ws = [torch.randint(-127, 128, (sum(rows), K), generator=gen,
                                device=dev, dtype=torch.int8)
                  for K, rows in shapes]
            got["products_ms"] = len(ws) * cs.chain_ms(
                [lambda w=w, sh=sh: products(*sh, w)
                 for w, sh in zip(ws, shapes)], iters=5)
            del ws
            gc.collect()
            torch.cuda.empty_cache()
        row = cs._forward_row(mt, resnet, x, "int8 ab", card)
        got["images_per_s"] = row["images_per_s"]
        got["resnet_kernel_ms"] = row["kernel_ms"]
        got["k2_ms"] = row["int8"]["int8_quantize"][0]
        with mt.autograd.pause():
            got["stem_ms"] = cs.graph_ms(lambda: stem(x))
        (got["eager_host_ms"], got["eager_layer_us"],
         got["eager_other_ms"]) = _eager_host(mt, q, eager, x)
        got["eager_images_per_s"] = x.shape[0] / got["eager_host_ms"] * 1e3
        out.write(json.dumps(got) + "\n")
        out.flush()
    return 0


def _quartiles(v):
    v = sorted(v)

    def at(f):
        i = f * (len(v) - 1)
        lo = int(i)
        return v[lo] + (v[min(lo + 1, len(v) - 1)] - v[lo]) * (i - lo)
    return at(0.25), at(0.5), at(0.75)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out")
    ap.add_argument("--resnet-only", action="store_true")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv[1:])
    if args.worker:
        return worker(args.trees[0], args.resnet_only)
    import torch
    if not torch.cuda.is_available() or len(args.trees) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    cs = _chip_smoke()
    print(cs.card_line(), flush=True)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", t]
        + (["--resnet-only"] if args.resnet_only else []),
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for t in args.trees]
    runs = {t: [] for t in args.trees}
    try:
        for i in range(args.pairs):
            order = (0, 1) if i % 2 == 0 else (1, 0)
            for side in order:
                p = procs[side]
                p.stdin.write("run\n")
                p.stdin.flush()
                line = p.stdout.readline()
                if not line:
                    raise RuntimeError("worker %s ended (exit %s)"
                                       % (args.trees[side], p.wait()))
                runs[args.trees[side]].append(json.loads(line))
                print("pair %d %s %s" % (i, "AB"[side], line.strip()),
                      flush=True)
    finally:
        for p in procs:
            if p.poll() is None:
                p.stdin.close()
        for p in procs:
            p.wait(timeout=120)
    a, b = (runs[t] for t in args.trees)
    summary = {}
    for m, more in METRICS.items():
        if args.resnet_only and m in SERVE_METRICS:
            continue
        qa, qb = _quartiles([r[m] for r in a]), _quartiles([r[m] for r in b])
        wins = sum((rb[m] > ra[m]) if more else (rb[m] < ra[m])
                   for ra, rb in zip(a, b) if rb[m] != ra[m])
        summary[m] = {"A": qa, "B": qb, "B_wins": wins, "pairs": len(b),
                      "A_spread": qa[2] - qa[0]}
        print("%-18s A %s  B %s  B won %d of %d pairs; A's quartile spread "
              "%.6g" % (m, ["%.6g" % v for v in qa], ["%.6g" % v for v in qb],
                        wins, len(b), qa[2] - qa[0]), flush=True)
    if args.out:
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"trees": args.trees, "runs": runs,
                       "summary": summary}, f, indent=1)
        os.replace(tmp, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
