"""The port's data and tensor parallelism against the JAX package's.

Four gloo ranks on the CPU run the port's ``parallel`` layer once for the
whole module: this file is also their program (``python
tests/test_torch_sharding.py --rank R --world 4 --dir D``; the rank part
runs before the JAX imports below, so the ranks never import JAX).  They
meet through a ``FileStore`` in a temporary directory, run every case of
:data:`CASES` on its mesh and write the results to one npz each.  The
parametrised tests then hold them against the port on one device (run
here) and the JAX package on its 8 virtual CPU devices, with the same
seeded numpy weights and inputs:

* ``shard_params`` / ``TrainStep(mesh=, param_rules=, zero1=)`` and the
  checkpoints, mirroring ``tests/test_parallel.py`` :26, :36, :54, :74,
  :93, :416, :462, :588, :607, :619, :670, :715 and :769 (an 8-device
  mesh there is a 4-rank one here, and the JAX side runs the same mesh);
* a BatchNorm convolution net on ``dp=2`` (ranks 2 and 3 outside the
  mesh), ``resize`` / ``shrink_mesh`` / ``grow_mesh`` round trips, and
  the reference's loss convention (a ``sum`` loss comes out dp times
  smaller: ROADMAP section 3, quirks);
* the dp x tp x ZeRO-1 half of ``dryrun_multichip``
  (``__graft_entry__.py:104-155``) at its config on ``(dp=1, tp=4)``
  and ``(dp=2, tp=2)``: 3 AdamW losses against the port on one device
  at the driver's rtol 2e-5 / atol 1e-6, and against the JAX package's
  sharded run, with the flash kernel called on each rank's local heads.
"""
import os
import subprocess
import sys
import time

import numpy as onp
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DRYRUN = dict(n_heads=4, n_kv_heads=2, dim=64, hidden_dim=128, n_layers=2,
              vocab_size=128)
TRAJ = dict(n_heads=4, n_kv_heads=2, dim=64, hidden_dim=128, n_layers=2,
            vocab_size=64)
#: dryrun meshes: name -> (axis sizes, batch)
DRY_MESHES = {"tp4": ({"dp": 1, "tp": 4}, 2), "dp2tp2": ({"dp": 2, "tp": 2},
                                                         4)}


# ----------------------------------------------------------------------
# models, weights and data: both packages build from these
# ----------------------------------------------------------------------
def weights(shapes, seed, scale=0.3):
    """Seeded numpy weights by name: norm gains one, shifts and running
    means zero, running variances one, the rest normal."""
    rs = onp.random.RandomState(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(("gamma", "running_var")):
            out[name] = onp.ones(shape, "float32")
        elif name.endswith(("beta", "running_mean")):
            out[name] = onp.zeros(shape, "float32")
        else:
            out[name] = rs.normal(0, scale, shape).astype("float32")
    return out


def mlp(nn, out=1):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=4, activation="relu"),
            nn.Dense(out, in_units=16))
    return net


def mlp8(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"),
            nn.Dense(4, in_units=16))
    return net


def bn_net(nn, norm="BatchNorm"):
    """A ResNet-style stem: conv, BatchNorm (or ``norm``), relu, then a
    classifier."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3),
            getattr(nn, norm)(in_channels=4), nn.Activation("relu"),
            nn.Flatten(), nn.Dense(5, in_units=4 * 6 * 6))
    return net


def data(seed, *shapes, labels=None):
    rs = onp.random.RandomState(seed)
    out = [rs.normal(0, 1, s).astype("float32") for s in shapes]
    if labels is not None:
        n, k = labels
        out.append(rs.randint(0, k, (n,)).astype("int32"))
    return out


def lm_batch(seed, B, T, vocab):
    rs = onp.random.RandomState(seed)
    return (rs.randint(0, vocab, (B, T)).astype("int32"),
            rs.randint(0, vocab, (B, T)).astype("int32"))


# ----------------------------------------------------------------------
# the port's side (no JAX): one-device runs here, sharded runs in ranks
# ----------------------------------------------------------------------
def t_net(kind, seed, cfg=None, dtype=None):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.models import TransformerLM, tiny_config
    if kind == "lm":
        net = TransformerLM(tiny_config(**cfg), device="cpu")
    else:
        net = {"mlp": lambda: mlp(nn), "mlp2": lambda: mlp(nn, 2),
               "mlp8": lambda: mlp8(nn), "bn": lambda: bn_net(nn),
               "syncbn": lambda: bn_net(nn, "SyncBatchNorm"),
               "dense_3_2": lambda: nn.Dense(2, in_units=3),
               "dense_16_8": lambda: nn.Dense(8, in_units=16),
               "dense_8_16": lambda: nn.Dense(16, in_units=8),
               "dense_8_4": lambda: nn.Dense(4, in_units=8)}[kind]()
        net.initialize(device="cpu")
    shapes = {k: tuple(p.shape) for k, p in net.collect_params().items()}
    convert.load_params(net, weights(shapes, seed,
                                     0.02 if kind == "lm" else 0.3))
    if dtype is not None:
        net.cast(dtype)
    return net


def t_lm_fwd():
    from mxnet_tpu_torch.gluon import loss as gloss
    lf = gloss.SoftmaxCrossEntropyLoss()

    def fwd(net, tokens, labels):
        logits = net(tokens)
        return lf(logits.reshape(-1, logits.shape[-1]),
                  labels.reshape(-1)).mean()
    return fwd


def _t(a):
    return torch.from_numpy(onp.asarray(a))


def t_run(case, mesh=None, path=None):
    """The port's losses (and what else the case records) for ``case``;
    ``mesh`` None runs it on one device."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.convert import export_params
    from mxnet_tpu_torch.gluon import loss as gloss
    kind, seed, opt, loss, steps, batch, kw = CASES[case]
    cfg = kw.get("cfg")
    net = t_net(kind, seed, cfg, kw.get("dtype"))
    o = getattr(optimizer, opt[0])(**opt[1])
    lf = {"l2": gloss.L2Loss(), "sce": gloss.SoftmaxCrossEntropyLoss(),
          "lm": None, "sum": None}[loss]
    fwd = t_lm_fwd() if loss == "lm" else None
    if loss == "sum":
        def fwd(net, x, y):
            return ((net(x) - y) ** 2).sum()
    over = {}
    if mesh is not None:
        over = {k: kw[k] for k in ("param_rules", "zero1") if k in kw}
    step = parallel.TrainStep(net, lf, o, mesh, forward_fn=fwd, **over)
    xs = [_t(a) for a in batch]
    losses = [float(step(*xs)) for _ in range(steps)]
    res = {"losses": onp.array(losses)}
    res.update({"w/" + k: v for k, v in export_params(net).items()})
    return res, net, step


#: name -> (net, weight seed, (optimizer, args), loss, steps, batch, extra)
CASES = {}


def _cases():
    x32 = data(0, (32, 4))[0]
    y32 = x32 @ onp.random.RandomState(1).normal(0, 1, (4, 1)).astype(
        "float32")
    X = (onp.arange(24, dtype="float32").reshape(8, 3) / 10)
    Y = onp.ones((8, 2), "float32")
    x16, y16 = data(5, (16, 16), (16, 8))
    toks, labs = lm_batch(3, 4, 16, 64)
    CASES.update({
        "dp": ("mlp", 7, ("SGD", {"learning_rate": 0.3}), "l2", 50,
               (x32, y32), {"mesh": {"dp": 4}}),
        "match_single": ("dense_3_2", 11, ("SGD", {"learning_rate": 0.5}),
                         "l2", 1, (X, Y), {"mesh": {"dp": 4}}),
        "zero1": ("dense_16_8", 5, ("Adam", {"learning_rate": 0.01}), "l2",
                  6, (x16, y16), {"mesh": {"dp": 4}, "zero1": True}),
        "rules": ("dense_8_16", 13, ("SGD", {"learning_rate": 0.1}), "l2", 2,
                  (onp.ones((8, 8), "float32"), onp.ones((8, 16), "float32")),
                  {"mesh": {"dp": 2, "tp": 2},
                   "param_rules": [("weight", ("tp", None))]}),
        "dp_tp_traj": ("lm", 0, ("AdamW", {"learning_rate": 1e-2}), "lm", 5,
                       (toks, labs), {"mesh": {"dp": 2, "tp": 2},
                                      "cfg": TRAJ}),
        "dp_tp_traj6": ("lm", 0, ("AdamW", {"learning_rate": 1e-2}), "lm",
                        6, (toks, labs), {"mesh": {"dp": 2, "tp": 2},
                                          "cfg": TRAJ}),
        "bn": ("bn", 17, ("SGD", {"learning_rate": 0.1, "momentum": 0.9}),
               "sce", 3, tuple(data(9, (8, 3, 6, 6), labels=(8, 5))),
               {"mesh": {"dp": 2}}),
        "syncbn": ("syncbn", 17, ("SGD", {"learning_rate": 0.1,
                                          "momentum": 0.9}),
                   "sce", 3, tuple(data(9, (8, 3, 6, 6), labels=(8, 5))),
                   {"mesh": {"dp": 2}}),
        "sum_loss": ("dense_3_2", 11, ("SGD", {"learning_rate": 0.05}),
                     "sum", 2, (X, Y), {"mesh": {"dp": 4}}),
    })
    for name, (sizes, B) in DRY_MESHES.items():
        CASES["dry_" + name] = (
            "lm", 0, ("AdamW", {"learning_rate": 1e-3}), "lm", 3,
            lm_batch(0, B, 32, 128), {"mesh": sizes, "cfg": DRYRUN,
                                      "zero1": True})


_cases()


def ckpt_batch(seed):
    return data(seed, (8, 8), labels=(8, 4))


def _rank_main(rank, world, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.convert import export_params
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.parallel import _compat
    res = {}
    heads = []
    flash = transformer.flash_attention

    def recording(q, k, v, **kw):
        heads.append((q.shape[1], k.shape[1]))
        return flash(q, k, v, **kw)
    transformer.flash_attention = recording
    with mt.cpu():
        for case, (_, _, _, _, _, _, kw) in CASES.items():
            mesh = parallel.create_mesh(kw["mesh"])
            heads.clear()
            if not mesh.is_member:
                continue
            out, net, step = t_run(case, mesh)
            res.update({"%s/%s" % (case, k): v for k, v in out.items()})
            if heads:
                res[case + "/heads"] = onp.array(heads)
            if case == "zero1":
                st = step._states["weight"][0]
                res["zero1/state_shape"] = onp.array(st.shape)
                res["zero1/state_spec"] = onp.array(
                    [str(a) for a in step._state_spec("weight")])
            if case == "rules":
                w = net.weight
                res["rules/local_shape"] = onp.array(w.shape)
                res["rules/spec"] = onp.array(
                    [str(a) for a in w.sharding.spec])
        # :26 shard_params, and the sharded forward against the whole one
        mesh = parallel.create_mesh(dp=2, tp=2)
        for name, rule in (("out", ("tp", None)), ("in", (None, "tp")),
                           ("both", ("dp", "tp"))):
            net = t_net("dense_8_16", 3)
            x = _t(data(4, (5, 8))[0])
            want = net(x)
            parallel.shard_params(net, mesh, rules=[("weight", rule)])
            res["shard_%s/local" % name] = onp.array(net.weight.shape)
            res["shard_%s/err" % name] = float(
                (net(x) - want).abs().max().detach())
        emb = mt.gluon.nn.Embedding(16, 8)
        emb.initialize(device="cpu")
        mt.convert.load_params(emb, weights({"weight": (16, 8)}, 2))
        ids = torch.tensor([[0, 5, 9, 15], [3, 8, 2, 12]])
        want = emb.weight.detach()[ids]
        for name, rule in (("vocab", ("tp", None)), ("width", (None, "tp"))):
            parallel.shard_params(emb, mesh, rules=[("weight", rule)])
            res["emb_%s/err" % name] = float(
                (emb(ids) - want).abs().max().detach())
        # the explicit collectives and their conjugate backwards
        tp4 = parallel.create_mesh(tp=4)
        x = (torch.arange(12.).reshape(4, 3) * (rank + 1)).requires_grad_()
        y = _compat.psum_scatter(x, 0, "tp", tp4)
        res["coll/psum_scatter"] = y.detach().numpy()
        res["coll/psum_scatter_grad"] = torch.autograd.grad(
            (y * (rank + 1)).sum(), x)[0].numpy()
        x = torch.full((1, 3), float(rank)).requires_grad_()
        z = _compat.all_gather(x, 0, "tp", tp4)
        res["coll/all_gather"] = z.detach().numpy()
        res["coll/all_gather_grad"] = torch.autograd.grad(
            (z * (rank + 1)).sum(), x)[0].numpy()
        x = torch.full((2,), float(rank + 1)).requires_grad_()
        z = _compat.psum_partial(x, "tp", tp4)
        res["coll/psum_partial"] = z.detach().numpy()
        res["coll/psum_partial_grad"] = torch.autograd.grad(
            (z * (rank + 1)).sum(), x)[0].numpy()
        # :588 a spec on an axis the mesh lacks replicates
        dp4 = parallel.create_mesh(dp=4)
        net = t_net("dense_8_16", 3)
        net.weight.shard(("tp", None))
        parallel.shard_params(net, dp4)
        res["missing/spec"] = onp.array([str(a) for a in
                                         net.weight.sharding.spec])
        step = parallel.TrainStep(net, gloss.L2Loss(),
                                  optimizer.SGD(learning_rate=0.1), dp4)
        res["missing/loss"] = onp.float32(step(torch.ones(8, 8),
                                               torch.zeros(8, 16)))
        # whole-tensor-norm rules are refused on shards
        try:
            parallel.TrainStep(t_net("dense_8_16", 3), gloss.L2Loss(),
                               optimizer.LAMB(), dp4, zero1=True)
            res["lamb_refused"] = onp.bool_(False)
        except NotImplementedError as e:
            res["lamb_refused"] = onp.bool_("queue 3" in str(e))
        try:
            parallel.TrainStep(t_net("dense_8_16", 3), gloss.L2Loss(),
                               optimizer.SGD(), dp4)(torch.ones(6, 8),
                                                     torch.ones(6, 16))
            res["batch_refused"] = onp.bool_(False)
        except ValueError as e:
            res["batch_refused"] = onp.bool_("does not split" in str(e))
        # :670 / :715 / :769 checkpoints across topologies
        ck = os.path.join(out_dir, "ck")
        rules = [("weight", ("tp", None))]
        dptp = parallel.create_mesh(dp=2, tp=2)

        def ck_step(mesh, rules=None, kind="mlp8", opt=None, lf=None,
                    dtype=None):
            net = t_net(kind, 123, dtype=dtype)
            o = opt or optimizer.SGD(learning_rate=0.1, momentum=0.9)
            return net, parallel.TrainStep(
                net, lf or gloss.SoftmaxCrossEntropyLoss(), o, mesh,
                param_rules=rules if mesh is not None else None)
        net_a, step_a = ck_step(dptp, rules)
        for s in range(3):
            step_a(*map(_t, ckpt_batch(s)))
        step_a.save_checkpoint(ck)
        res["ck/ref"] = onp.array([float(step_a(*map(_t, ckpt_batch(10 + s))))
                                   for s in range(2)])
        for name, mesh in (("dp", dp4), ("single", None)):
            net_b, step_b = ck_step(mesh)
            step_b.load_checkpoint(ck)
            res["ck/%s_t" % name] = onp.int64(step_b._t)
            res["ck/%s" % name] = onp.array(
                [float(step_b(*map(_t, ckpt_batch(10 + s))))
                 for s in range(2)])
        net, step = ck_step(dptp, rules, "dense_8_4",
                            optimizer.SGD(learning_rate=0.05), gloss.L2Loss())
        xy = [_t(a) for a in data(7, (8, 8), (8, 4))]
        step(*xy)
        step.save_checkpoint(ck + "1")
        res["ck1/saved"] = export_params(net)["weight"]
        net2, step2 = ck_step(None, None, "dense_8_4",
                              optimizer.SGD(learning_rate=0.05),
                              gloss.L2Loss())
        step2.load_checkpoint(ck + "1")
        res["ck1/loaded"] = export_params(net2)["weight"]
        res["ck1/t"] = onp.int64(step2._t)
        net, step = ck_step(dp4, None, "dense_16_8",
                            optimizer.Adam(learning_rate=1e-3),
                            gloss.L2Loss(), "bfloat16")
        xy = [_t(a).bfloat16() for a in data(8, (8, 16), (8, 8))]
        step(*xy)
        step.save_checkpoint(ck + "bf")
        res["ckbf/saved"] = export_params(net)["weight"]
        net2, step2 = ck_step(None, None, "dense_16_8",
                              optimizer.Adam(learning_rate=1e-3),
                              gloss.L2Loss(), "bfloat16")
        step2.load_checkpoint(ck + "bf")
        res["ckbf/loaded"] = export_params(net2)["weight"]
        res["ckbf/dtype"] = onp.array(str(net2.weight.dtype))
        res["ckbf/m_dtype"] = onp.array(str(step2._states["weight"][0].dtype))
        res["ckbf/next"] = onp.float32(float(step2(*xy)))
        # resize: dp x tp -> shrink -> grow, each through a checkpoint,
        # then without one (weights kept, states fresh)
        toks, labs = (_t(a) for a in CASES["dp_tp_traj"][5])
        net, step = (lambda n: (n, parallel.TrainStep(
            n, None, optimizer.AdamW(learning_rate=1e-2), dptp,
            forward_fn=t_lm_fwd())))(t_net("lm", 0, TRAJ))
        losses = [float(step(toks, labs)) for _ in range(2)]
        step.save_checkpoint(ck + "r1")
        small = parallel.shrink_mesh(dptp, ranks=[0, 1])
        step.resize(small, checkpoint=ck + "r1")
        res["resize/small_shape"] = onp.array([small.shape["dp"],
                                               small.shape["tp"]])
        res["resize/small_member"] = onp.bool_(small.is_member)
        if small.is_member:
            losses += [float(step(toks, labs)) for _ in range(2)]
        step.save_checkpoint(ck + "r2") if small.is_member else None
        _compat.barrier(dptp)
        big = parallel.grow_mesh(small, ranks=[0, 1, 2, 3])
        step.resize(big, checkpoint=ck + "r2")
        res["resize/big_shape"] = onp.array([big.shape["dp"],
                                             big.shape["tp"]])
        losses += [float(step(toks, labs)) for _ in range(2)]
        res["resize/losses"] = onp.array(losses)
        before = export_params(net)
        step.resize(dp4)
        after = export_params(net)
        res["resize/kept"] = onp.float32(max(
            abs(before[k] - after[k]).max() for k in before))
        res["resize/fresh"] = onp.float32(max(
            float(s.abs().max()) for st in step._states.values()
            for s in st))
        ragged = parallel.shrink_mesh(dptp, ranks=[0, 1, 2])
        res["resize/ragged"] = onp.array([ragged.size,
                                          int(ragged.is_member)])
    res["flash_recorded"] = onp.int64(len(heads))
    res["imported_jax"] = onp.bool_(any(
        m.split(".")[0] in ("jax", "jaxlib", "mxnet_tpu")
        for m in sys.modules))
    onp.savez(os.path.join(out_dir, "rank%d.npz" % rank), **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    _rank_main(int(args["--rank"]), int(args["--world"]), args["--dir"])
    sys.exit(0)


# ----------------------------------------------------------------------
# the tests (JAX from here on)
# ----------------------------------------------------------------------
import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon import nn as jnn  # noqa: E402
from mxnet_tpu.models import TransformerLM as JLM  # noqa: E402
from mxnet_tpu.models import tiny_config as j_tiny  # noqa: E402
from mxnet_tpu_torch import parallel as tpar  # noqa: E402


def _spawn(out_dir, timeout=240):
    """Run the ranks; fail (and stop the others) if one fails."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(WORLD), "--dir", str(out_dir)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            bad = [p for p in procs if p.poll() not in (None, 0)]
            if bad or time.monotonic() - t0 > timeout:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, "rank %d failed:\n%s" % (r, log[-4000:])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("ranks")
    _spawn(out_dir)
    return [dict(onp.load(out_dir / ("rank%d.npz" % r)))
            for r in range(WORLD)]


_SINGLE = {}


def single(case):
    """The port on one device."""
    if case not in _SINGLE:
        _SINGLE[case] = t_run(case)[0]
    return _SINGLE[case]


_JAX = {}


def j_net(kind, seed, cfg=None):
    if kind == "lm":
        net = JLM(j_tiny(**cfg))
    else:
        net = {"mlp": lambda: mlp(jnn), "mlp8": lambda: mlp8(jnn),
               "bn": lambda: bn_net(jnn),
               "dense_3_2": lambda: jnn.Dense(2, in_units=3),
               "dense_16_8": lambda: jnn.Dense(8, in_units=16),
               "dense_8_16": lambda: jnn.Dense(16, in_units=8)}[kind]()
    net.initialize()
    params = net.collect_params()
    shapes = {k: tuple(p.shape) for k, p in params.items()}
    for k, w in weights(shapes, seed, 0.02 if kind == "lm" else 0.3).items():
        params[k].set_data(mx.np.array(w))
    return net


def jax_run(case, sharded):
    """The JAX package's losses for ``case``, on its mesh or one
    device."""
    key = (case, sharded)
    if key not in _JAX:
        kind, seed, opt, loss, steps, batch, kw = CASES[case]
        net = j_net(kind, seed, kw.get("cfg"))
        o = getattr(mx.optimizer, opt[0])(**opt[1])
        lf = {"l2": jgluon.loss.L2Loss(),
              "sce": jgluon.loss.SoftmaxCrossEntropyLoss()}.get(loss)
        fwd = None
        if loss == "lm":
            sce = jgluon.loss.SoftmaxCrossEntropyLoss()

            def fwd(net, tokens, labels):
                logits = net.forward(tokens)
                return sce(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1)).mean()
        elif loss == "sum":
            def fwd(net, x, y):
                return ((net(x) - y) ** 2).sum()
        mesh = jpar.create_mesh(**kw["mesh"]) if sharded else None
        over = {k: kw[k] for k in ("param_rules", "zero1")
                if k in kw and sharded}
        xs = [mx.np.array(a) for a in batch]
        with jpar.mesh_scope(mesh) if mesh is not None else _null():
            step = jpar.TrainStep(net, lf, o, mesh=mesh, forward_fn=fwd,
                                  **over)
            losses = [float(step(*xs)) for _ in range(steps)]
        _JAX[key] = (onp.array(losses), {
            k: onp.asarray(p.data()._data, dtype=onp.float32)
            for k, p in net.collect_params().items()})
    return _JAX[key]


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def _members(ranks, case):
    return [r for r in ranks if case + "/losses" in r]


def test_rank_children_import_no_jax(ranks):
    assert [bool(r["imported_jax"]) for r in ranks] == [False] * WORLD


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_losses_are_the_same_on_every_rank(ranks, case):
    members = _members(ranks, case)
    assert len(members) == (2 if case in ("bn", "syncbn") else WORLD)
    for r in members[1:]:
        onp.testing.assert_array_equal(r[case + "/losses"],
                                       members[0][case + "/losses"])


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c not in ("sum_loss",)))
def test_sharded_step_matches_the_port_on_one_device(ranks, case):
    """dp / dp x tp / zero1 reproduce the one-device trajectory and
    weights (:54, :93, :462; the dryrun's limits for its runs)."""
    got = ranks[0]
    want = single(case)
    rtol, atol = (2e-5, 1e-6) if case.startswith("dry_") else (1e-5, 1e-6)
    onp.testing.assert_allclose(got[case + "/losses"], want["losses"],
                                rtol=rtol, atol=atol)
    for k in want:
        if k.startswith("w/"):
            onp.testing.assert_allclose(got["%s/%s" % (case, k)], want[k],
                                        rtol=1e-4, atol=2e-5, err_msg=k)


@pytest.mark.parametrize("case", ["dp", "match_single", "zero1", "rules",
                                  "bn", "dry_tp4", "dry_dp2tp2"])
def test_sharded_step_matches_jax_sharded_step(ranks, case):
    """The same mesh in both packages: losses and final weights."""
    losses, params = jax_run(case, sharded=True)
    got = ranks[0]
    rtol = 2e-5 if case.startswith("dry_") else 1e-4
    onp.testing.assert_allclose(got[case + "/losses"], losses, rtol=rtol,
                                atol=1e-5 if case == "dp" else 1e-6)
    for k, w in params.items():
        onp.testing.assert_allclose(got["%s/w/%s" % (case, k)], w,
                                    rtol=2e-4, atol=5e-5, err_msg=k)


def test_train_step_dp_converges(ranks):
    """:36 (dp=8 there, dp=4 here): 50 SGD steps cut the loss tenfold."""
    losses = ranks[0]["dp/losses"]
    assert losses[-1] < losses[0] * 0.1


def test_train_step_zero1_shards_states(ranks):
    """:74: Adam's states split over dp on dim 0 of the rank's block."""
    r = ranks[0]
    assert r["zero1/losses"][-1] < r["zero1/losses"][0]
    assert r["zero1/state_shape"].tolist() == [8 // WORLD, 16]
    assert r["zero1/state_spec"].tolist() == ["dp", "None"]


def test_train_step_param_rules_applied(ranks):
    """:416: the rule shards the weight; the step runs sharded."""
    for r in ranks:
        assert r["rules/spec"].tolist() == ["tp", "None"]
        assert r["rules/local_shape"].tolist() == [8, 8]
        assert onp.isfinite(r["rules/losses"]).all()


def test_dp_tp_trajectory_descends(ranks):
    """:462: the dp x tp trajectory descends (and equals the one-device
    one: test_sharded_step_matches_the_port_on_one_device)."""
    losses = ranks[0]["dp_tp_traj/losses"]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name,local", [("out", [8, 8]), ("in", [16, 4]),
                                        ("both", [8, 4])])
def test_shard_params_local_blocks_compute_the_whole_product(ranks, name,
                                                             local):
    """:26: each rank holds its block, and the sharded Dense equals the
    whole one (out dimension, in dimension, both)."""
    for r in ranks:
        assert r["shard_%s/local" % name].tolist() == local
        assert float(r["shard_%s/err" % name]) < 1e-6


@pytest.mark.parametrize("name", ["vocab", "width"])
def test_sharded_embedding_equals_the_whole_lookup(ranks, name):
    for r in ranks:
        assert float(r["emb_%s/err" % name]) == 0.0


def test_explicit_collectives_and_their_conjugate_backwards(ranks):
    """``psum_scatter``'s gradient is the ``all_gather`` of the
    cotangents, ``all_gather``'s the rank's slice of their sum, and
    ``psum_partial``'s the sum of the cotangents."""
    rows = onp.arange(12.).reshape(4, 3) * 10
    for r, res in enumerate(ranks):
        onp.testing.assert_array_equal(res["coll/psum_scatter"],
                                       rows[r:r + 1])
        onp.testing.assert_array_equal(
            res["coll/psum_scatter_grad"],
            onp.repeat(onp.arange(1., 5.)[:, None], 3, 1))
        onp.testing.assert_array_equal(
            res["coll/all_gather"], onp.repeat(onp.arange(4.)[:, None], 3,
                                               1))
        onp.testing.assert_array_equal(res["coll/all_gather_grad"],
                                       onp.full((1, 3), 10.))
        onp.testing.assert_array_equal(res["coll/psum_partial"],
                                       onp.full((2,), 10.))
        onp.testing.assert_array_equal(res["coll/psum_partial_grad"],
                                       onp.full((2,), 10.))


def test_refusals_over_a_mesh(ranks):
    """LAMB on ZeRO-1 states (its trust ratio reads whole-tensor norms)
    and a batch that dp does not divide are errors."""
    for r in ranks:
        assert bool(r["lamb_refused"]) and bool(r["batch_refused"])


def test_param_spec_missing_axis_replicates(ranks):
    """:588: ("tp", None) on a dp-only mesh replicates, and the step
    runs."""
    for r in ranks:
        assert r["missing/spec"].tolist() == ["None", "None"]
        assert onp.isfinite(r["missing/loss"])


@pytest.mark.parametrize("spec,shape,mesh,want", [
    ((("dp", "tp"), None), (16, 4), {"dp": 8}, ("dp", None)),
    ((("dp", "tp"), None), (16, 4), {"dp": 2, "tp": 4},
     (("dp", "tp"), None)),
    (("tp", None), (8, 8), {"dp": 8}, (None, None)),
    (("dp",), (6,), {"dp": 8}, (None,)),
    (("tp", "dp"), (8, 4), {"dp": 2, "tp": 4}, ("tp", "dp")),
])
def test_valid_spec_matches_jax(spec, shape, mesh, want):
    """:607: composite axes keep their present sub-axes; absent axes and
    indivisible dimensions replicate."""
    from mxnet_tpu.parallel.sharding import _valid_spec as j_valid
    from mxnet_tpu_torch.parallel.sharding import _valid_spec as t_valid

    class Shape:
        shape = mesh
    got = t_valid(spec, shape, Shape(), warn=False)
    assert tuple(got) == want
    assert tuple(j_valid(spec, shape, jpar.create_mesh(**mesh),
                         warn=False)) == want


def test_valid_spec_drop_warns_once(caplog):
    """:619: a dropped parameter axis warns once per (parameter, axis)."""
    import logging

    from mxnet_tpu_torch.parallel.sharding import _valid_spec, _warned_drops

    class Mesh:
        shape = {"dp": 8}
    _warned_drops.clear()
    logger = "mxnet_tpu_torch.parallel.sharding"
    with caplog.at_level(logging.WARNING, logger=logger):
        assert tuple(_valid_spec(tpar.P("tp", None), (8, 8), Mesh(),
                                 param_name="w")) == (None, None)
    assert any("no axis 'tp'" in r.message and "w" in r.message
               and "REPLICATED" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=logger):
        assert tuple(_valid_spec(tpar.P("dp"), (6,), Mesh(),
                                 param_name="w2")) == (None,)
    assert any("not divisible" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=logger):
        _valid_spec(tpar.P("dp"), (6,), Mesh(), param_name="w2")
        _valid_spec(tpar.P("tp", None), (8, 8), Mesh(), param_name="w")
    assert not caplog.records


def test_sharded_checkpoint_reshard_roundtrip(ranks):
    """:670: saved on dp x tp with the weights over tp, resumed on dp
    only and on one device: the uninterrupted run's losses."""
    for r in ranks:
        for name in ("dp", "single"):
            assert int(r["ck/%s_t" % name]) == 3
            onp.testing.assert_allclose(r["ck/%s" % name], r["ck/ref"],
                                        rtol=1e-5)


def test_sharded_checkpoint_to_single_device(ranks):
    """:715."""
    for r in ranks:
        onp.testing.assert_allclose(r["ck1/loaded"], r["ck1/saved"],
                                    rtol=1e-6)
        assert int(r["ck1/t"]) == 1


def test_sharded_checkpoint_bf16_params(ranks):
    """:769: bf16 weights and float32 moments round-trip exactly."""
    for r in ranks:
        onp.testing.assert_array_equal(r["ckbf/loaded"], r["ckbf/saved"])
        assert str(r["ckbf/dtype"]) == "torch.bfloat16"
        assert str(r["ckbf/m_dtype"]) == "torch.float32"
        assert onp.isfinite(r["ckbf/next"])


def test_resize_through_shrink_and_grow_keeps_the_trajectory(ranks):
    """dp x tp -> shrink_mesh onto two ranks (dp absorbs it: dp=1, tp=2;
    ranks 2 and 3 idle) -> grow_mesh back, each resize restoring the
    last checkpoint: the six losses are the one-device trajectory's."""
    want = single("dp_tp_traj")["losses"][:4]
    want = onp.concatenate([want, single("dp_tp_traj6")["losses"][4:]])
    for r in ranks[:2]:
        assert r["resize/small_shape"].tolist() == [1, 2]
        assert bool(r["resize/small_member"])
        onp.testing.assert_allclose(r["resize/losses"], want, rtol=1e-5)
    for r in ranks[2:]:
        assert not bool(r["resize/small_member"])
        onp.testing.assert_allclose(r["resize/losses"],
                                    want[[0, 1, 4, 5]], rtol=1e-5)
    for r in ranks:
        assert r["resize/big_shape"].tolist() == [2, 2]


def test_resize_without_checkpoint_keeps_weights_and_restarts_states(ranks):
    for r in ranks:
        assert float(r["resize/kept"]) == 0.0
        assert float(r["resize/fresh"]) == 0.0


def test_shrink_mesh_idles_the_ragged_ranks(ranks):
    """Three survivors of a (dp=2, tp=2) mesh: dp=1 over ranks 0, 1;
    rank 2 idles outside the mesh, and rank 3 too."""
    assert [r["resize/ragged"].tolist() for r in ranks] == \
        [[2, 1], [2, 1], [2, 0], [2, 0]]


def test_shrink_mesh_needs_the_fixed_axes():
    mesh = tpar.create_mesh(dp=1, tp=1, device="cpu")
    with pytest.raises(ValueError, match="no axis"):
        tpar.shrink_mesh(mesh, ranks=[0], axis="pp")
    with pytest.raises(ValueError, match="ranks"):
        tpar.grow_mesh(mesh, ranks=[0, 1])


def test_sum_loss_comes_out_dp_times_smaller(ranks):
    """The port's convention (ROADMAP section 3, quirks): each rank's
    loss is averaged over dp, which equals the reference's global loss
    for a mean over the batch; a sum over the batch comes out dp times
    smaller than the JAX package's, at the first step."""
    want, _ = jax_run("sum_loss", sharded=False)
    got = ranks[0]["sum_loss/losses"]
    onp.testing.assert_allclose(got[0] * WORLD, want[0], rtol=1e-6)
    assert abs(got[1] * WORLD - want[1]) > 1e-3 * abs(want[1])


def test_batchnorm_reduces_its_moments_over_the_global_batch(ranks):
    """On dp=2 (ranks 2 and 3 outside the mesh) BatchNorm's moments and
    running statistics are the whole batch's: the reference's on one
    device, not each half's."""
    members = _members(ranks, "bn")
    assert [("bn/losses" in r) for r in ranks] == [True, True, False, False]
    losses, params = jax_run("bn", sharded=False)
    for r in members:
        onp.testing.assert_allclose(r["bn/losses"], losses, rtol=1e-4)
        for k in ("1.running_mean", "1.running_var"):
            onp.testing.assert_allclose(r["bn/w/" + k], params[k],
                                        rtol=1e-4, atol=1e-5)


def test_sync_batchnorm_on_dp2_is_batchnorm_on_the_whole_batch(ranks):
    """``SyncBatchNorm`` on dp=2: the losses and running statistics of
    the JAX package's ``BatchNorm`` over the whole batch on one device,
    and the port's ``BatchNorm`` on one device."""
    members = _members(ranks, "syncbn")
    assert len(members) == 2
    losses, params = jax_run("bn", sharded=False)
    mine = single("bn")
    for r in members:
        onp.testing.assert_allclose(r["syncbn/losses"], losses, rtol=1e-4)
        onp.testing.assert_allclose(r["syncbn/losses"], mine["losses"],
                                    rtol=1e-5)
        for k in ("1.running_mean", "1.running_var", "1.gamma", "1.beta"):
            onp.testing.assert_allclose(r["syncbn/w/" + k], params[k],
                                        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,local", [("dry_tp4", (1, 1)),
                                        ("dry_dp2tp2", (2, 1))])
def test_dryrun_runs_flash_on_the_local_heads(ranks, name, local):
    """The Megatron path: each rank's flash calls take its local query
    heads and the KV heads they read (at tp=4 half a KV head's
    projection a rank, gathered), every layer every step."""
    for r in ranks:
        heads = r[name + "/heads"]
        assert len(heads) == DRYRUN["n_layers"] * 3
        assert set(map(tuple, heads.tolist())) == {local}
