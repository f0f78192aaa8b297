"""The port's KVStore, gradient compression, ``gluon.utils`` and the
Trainer's kvstore options against the JAX package's.

The one-process cases mirror ``tests/test_kvstore.py`` (its 12 tests),
``tests/test_multidevice_trainer.py`` (3), ``tests/test_parallel.py:368``
and ``tests/test_trainer_behaviors.py:180-268`` (all but the AMP case at
:231, which waits for ``amp/``), each run in both packages on the same
seeded numpy values.  2-bit and 1-bit compression match the reference
bit for bit.  Two gloo ranks run the ``dist_sync`` cases once for the
module: this file is also their program (``python
tests/test_torch_kvstore.py --rank R --world 2 --dir D``; the rank part
runs before the JAX imports): the pulled value is the exact sum over
the workers, ``broadcast`` takes worker 0's value, and a Trainer over a
``dist_sync`` store (plain, compressed, and with ``update_on_kvstore``)
equals one process stepping on the whole batch.
"""
import os
import subprocess
import sys
import time

import numpy as onp
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def dense_weights(seed, units=3, in_units=4):
    rs = onp.random.RandomState(seed)
    return {"weight": rs.normal(0, 0.5, (units, in_units)).astype("float32"),
            "bias": rs.normal(0, 0.5, (units,)).astype("float32")}


def batch(seed, n=8, d=4, k=3):
    rs = onp.random.RandomState(seed)
    return (rs.normal(0, 1, (n, d)).astype("float32"),
            rs.normal(0, 1, (n, k)).astype("float32"))


def t_dense(w, *shape):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon import nn
    units, in_units = w["weight"].shape
    net = nn.Dense(units, in_units=in_units)
    net.initialize(device="cpu")
    return convert.load_params(net, w)


def t_trainer_run(kvstore, steps, xs, ys, w, update_on_kvstore=None,
                  compression=None, rank_slice=None):
    """Dense(3) with SGD + momentum over ``steps`` batches; each rank
    (``rank_slice``) takes its rows of every batch."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import autograd, gluon
    net = t_dense(w)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9},
                       kvstore=kvstore, update_on_kvstore=update_on_kvstore,
                       compression_params=compression)
    if rank_slice is not None:
        # the store (made at the first step otherwise) broadcasts worker
        # 0's weights before the first gradient
        tr._init_kvstore()
    for x, y in zip(xs, ys):
        if rank_slice is not None:
            x, y = x[rank_slice], y[rank_slice]
        with autograd.record():
            loss = ((net(mt.np.array(x)) - mt.np.array(y)) ** 2).sum()
        loss.backward()
        tr.step(len(xs[0]))
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _rank_main(rank, world, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    import mxnet_tpu_torch as mt
    res = {}
    with mt.cpu():
        kv = mt.kv.create("dist_sync")
        res["rank"], res["num_workers"] = onp.int64(kv.rank), \
            onp.int64(kv.num_workers)
        base = onp.arange(12, dtype="float32").reshape(3, 4)
        kv.init("k", mt.np.zeros((3, 4)))
        kv.push("k", mt.np.array(base * (rank + 1)))
        out = mt.np.zeros((3, 4))
        kv.pull("k", out=out)
        res["push_pull"] = out.asnumpy()
        # a list of device copies is summed first, then over workers
        outs = [mt.np.zeros((2, 2)), mt.np.zeros((2, 2))]
        kv.pushpull(["a", "b"], [[mt.np.ones((2, 2)), mt.np.ones((2, 2))],
                                 mt.np.full((2, 2), 10.0 * (rank + 1))],
                    out=outs)
        res["pushpull_a"], res["pushpull_b"] = (o.asnumpy() for o in outs)
        out = mt.np.zeros((2, 3))
        kv.broadcast("bc", mt.np.full((2, 3), 7.0 + rank), out=out)
        res["broadcast"] = out.asnumpy()
        ckv = mt.kv.create("dist_sync")
        ckv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
        ckv.init("g", mt.np.zeros((5, 7)))
        gs = [onp.random.RandomState((rank, s)).normal(0, 1, (5, 7))
              .astype("float32") for s in range(3)]
        for s, g in enumerate(gs):
            o = mt.np.zeros((5, 7))
            ckv.pushpull("g", mt.np.array(g), out=o)
            res["compressed_%d" % s] = o.asnumpy()
        # the Trainer over a dist store, each rank on half of each batch;
        # the ranks start from different weights: worker 0's are taken
        xs, ys = zip(*[batch(s) for s in range(3)])
        half = slice(rank * 4, (rank + 1) * 4)
        for name, kw in (("plain", {}), ("on_kv", {"update_on_kvstore":
                                                   True}),
                         ("compressed", {"compression": {
                             "type": "2bit", "threshold": 0.1}})):
            got = t_trainer_run("dist_sync", 3, xs, ys,
                                dense_weights(100 + rank), rank_slice=half,
                                **kw)
            for k, v in got.items():
                res["trainer_%s/%s" % (name, k)] = v
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
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu import gluon as jgluon  # noqa: E402
from mxnet_tpu.kvstore import compression as jcomp  # noqa: E402
from mxnet_tpu_torch import autograd as tautograd  # noqa: E402
from mxnet_tpu_torch import gluon as tgluon  # noqa: E402
from mxnet_tpu_torch.gluon import nn as tnn  # noqa: E402
from mxnet_tpu_torch.gluon.utils import split_and_load  # noqa: E402
from mxnet_tpu_torch.kvstore import compression as tcomp  # noqa: E402


@pytest.fixture(autouse=True)
def on_cpu():
    with mt.cpu():
        yield


def _spawn(out_dir, timeout=180):
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


def j_dense(w, *shape):
    units, in_units = w["weight"].shape
    net = jgluon.nn.Dense(units, in_units=in_units)
    net.initialize()
    for k, v in w.items():
        net.collect_params()[k].set_data(mx.np.array(v))
    return net


def j_trainer_run(kvstore, steps, xs, ys, w, update_on_kvstore=None):
    net = j_dense(w)
    tr = jgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9},
                        kvstore=kvstore, update_on_kvstore=update_on_kvstore)
    for x, y in zip(xs, ys):
        with mx.autograd.record():
            loss = ((net(mx.np.array(x)) - mx.np.array(y)) ** 2).sum()
        loss.backward()
        tr.step(len(xs[0]))
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


# ----------------------------------------------------------------------
# tests/test_kvstore.py, in both packages
# ----------------------------------------------------------------------
def _both(fn):
    """``fn(mx)`` in each package; the two results."""
    return fn(mx), fn(mt)


def test_init_push_pull_single_key():
    def run(m):
        kv = m.kv.create("local")
        kv.init("3", m.np.zeros((3, 4)))
        kv.push("3", m.np.ones((3, 4)) * 2)
        out = m.np.zeros((3, 4))
        kv.pull("3", out=out)
        return out.asnumpy()
    j, t = _both(run)
    onp.testing.assert_array_equal(t, j)
    assert onp.allclose(t, 2.0)


def test_push_multi_device_reduces():
    def run(m):
        kv = m.kv.create("device")
        kv.init("k", m.np.zeros((2, 2)))
        kv.push("k", [m.np.ones((2, 2)), m.np.ones((2, 2)) * 3])
        out = m.np.zeros((2, 2))
        kv.pull("k", out=out)
        return out.asnumpy()
    j, t = _both(run)
    onp.testing.assert_array_equal(t, j)
    assert onp.allclose(t, 4.0)


def test_pushpull_multi_key_out_fresh():
    def run(m):
        kv = m.kv.create("local")
        keys, shapes = ["a", "b", "c"], [(3, 3), (5, 2), (4,)]
        for k, s in zip(keys, shapes):
            kv.init(k, m.np.zeros(s))
        outs = [m.np.zeros(s) for s in shapes]
        kv.pushpull(keys, [m.np.ones(s) * (i + 1)
                           for i, s in enumerate(shapes)], out=outs)
        first = [o.asnumpy() for o in outs]
        kv.pushpull(keys, [m.np.ones(s) * 10 for s in shapes], out=outs)
        return first, [o.asnumpy() for o in outs]
    (j1, j2), (t1, t2) = _both(run)
    for i, (a, b) in enumerate(zip(t1, j1)):
        onp.testing.assert_array_equal(a, b)
        assert onp.allclose(a, i + 1)
    for a, b in zip(t2, j2):
        onp.testing.assert_array_equal(a, b)
        assert onp.allclose(a, 10.0)


def test_pushpull_multi_key_with_updater():
    def run(m):
        kv = m.kv.create("local")
        keys = ["x", "y"]
        for k in keys:
            kv.init(k, m.np.ones((2, 2)))

        def updater(index, grad, weight):
            weight[:] = weight - 0.5 * grad
        kv.set_updater(updater)
        outs = [m.np.zeros((2, 2)) for _ in keys]
        kv.pushpull(keys, [m.np.ones((2, 2)) * 2 for _ in keys], out=outs)
        return [o.asnumpy() for o in outs]
    j, t = _both(run)
    for a, b in zip(t, j):
        onp.testing.assert_array_equal(a, b)
        assert onp.allclose(a, 0.0)


def test_pull_dtype_cast_fp16():
    def run(m):
        kv = m.kv.create("local")
        kv.init("w", m.np.ones((4, 4)))
        out = m.np.zeros((4, 4), dtype="float16")
        kv.pull("w", out=out)
        return out
    j, t = _both(run)
    assert t.dtype == j.dtype == onp.float16
    onp.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_big_array_key():
    def run(m):
        kv = m.kv.create("local")
        big = (1200, 64)
        kv.init("99", m.np.zeros(big))
        kv.push("99", [m.np.ones(big), m.np.ones(big) * 2])
        out = m.np.zeros(big)
        kv.pull("99", out=out)
        return out.asnumpy()
    j, t = _both(run)
    onp.testing.assert_array_equal(t, j)
    assert onp.allclose(t, 3.0)


def test_row_sparse_pull():
    def run(m):
        kv = m.kv.create("local")
        kv.init("emb", m.np.arange(12.0).reshape(4, 3))
        out = m.np.zeros((4, 3))
        kv.row_sparse_pull("emb", out=out, row_ids=m.np.array([1, 3]))
        return out.asnumpy()
    j, t = _both(run)
    onp.testing.assert_array_equal(t, j)
    assert onp.allclose(t[1], [3, 4, 5]) and onp.allclose(t[2], 0)


def test_optimizer_states_save_load_roundtrip(tmp_path):
    """A restored store resumes Adam's states: one more step agrees with
    the uninterrupted store, a cold one does not, and both packages
    agree."""
    def run(m):
        kv = m.kv.create("local")
        kv.init("0", m.np.ones((3, 3)))
        kv.set_optimizer(m.optimizer.create("adam", learning_rate=0.1))
        for _ in range(3):
            kv.push("0", m.np.ones((3, 3)))
        fname = str(tmp_path / ("opt_%s.states" % m.__name__))
        kv.save_optimizer_states(fname)
        w_before = kv._store["0"].asnumpy()
        kv2 = m.kv.create("local")
        kv2.init("0", m.np.array(w_before))
        kv2.set_optimizer(m.optimizer.create("adam", learning_rate=0.1))
        kv2.load_optimizer_states(fname)
        assert set(kv2._opt_states) == set(kv._opt_states)
        kv.push("0", m.np.ones((3, 3)) * 0.5)
        kv2.push("0", m.np.ones((3, 3)) * 0.5)
        kv3 = m.kv.create("local")
        kv3.init("0", m.np.array(w_before))
        kv3.set_optimizer(m.optimizer.create("adam", learning_rate=0.1))
        kv3.push("0", m.np.ones((3, 3)) * 0.5)
        return [k._store["0"].asnumpy() for k in (kv, kv2, kv3)]
    j, t = _both(run)
    assert onp.allclose(t[0], t[1], atol=1e-6)
    assert not onp.allclose(t[2], t[0], atol=1e-6)
    for a, b in zip(t, j):
        onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_optimizer_states_file_crosses_packages(tmp_path):
    """The port's store restores a state file the JAX store wrote."""
    fname = str(tmp_path / "j.states")
    jkv = mx.kv.create("local")
    jkv.init("0", mx.np.ones((3, 3)))
    jkv.set_optimizer(mx.optimizer.create("adam", learning_rate=0.1))
    for _ in range(2):
        jkv.push("0", mx.np.ones((3, 3)))
    jkv.save_optimizer_states(fname)
    tkv = mt.kv.create("local")
    tkv.init("0", mt.np.array(jkv._store["0"].asnumpy()))
    tkv.set_optimizer(mt.optimizer.create("adam", learning_rate=0.1))
    tkv.load_optimizer_states(fname)
    jkv.push("0", mx.np.ones((3, 3)) * 0.5)
    tkv.push("0", mt.np.ones((3, 3)) * 0.5)
    onp.testing.assert_allclose(tkv._store["0"].asnumpy(),
                                jkv._store["0"].asnumpy(), rtol=1e-6)
    with open(fname, "wb") as f:
        f.write(b"not a pickle")
    with pytest.raises(ValueError, match="corrupt"):
        tkv.load_optimizer_states(fname)


def test_broadcast_local():
    def run(m):
        kv = m.kv.create("local")
        out = m.np.zeros((2, 3))
        kv.broadcast("bk", m.np.full((2, 3), 7.0), out=out)
        return out.asnumpy()
    j, t = _both(run)
    onp.testing.assert_array_equal(t, j)


def test_pushpull_initializes_key_like_push():
    def run(m):
        kv = m.kv.create("local")
        o = m.np.zeros((2, 2))
        kv.pushpull("fresh", m.np.ones((2, 2)) * 5, out=o)
        o2 = m.np.zeros((2, 2))
        kv.pull("fresh", out=o2)
        return o.asnumpy(), o2.asnumpy()
    j, t = _both(run)
    for a, b in zip(t, j):
        onp.testing.assert_array_equal(a, b)
        assert onp.allclose(a, 5.0)


def test_custom_kvstore_plugin_registry():
    """``KVStoreBase.register``: a user's store plugs into
    ``mx.kv.create`` by name (the port's NDArray is written in place
    through its tensor)."""
    from mxnet_tpu_torch.kvstore.base import KVStoreBase

    calls = []

    @KVStoreBase.register
    class TorchTestStore(KVStoreBase):
        @property
        def type(self):
            return "torchteststore"

        @property
        def rank(self):
            return 0

        @property
        def num_workers(self):
            return 1

        def broadcast(self, key, value, out=None):
            calls.append(("broadcast", key))

        def pushpull(self, key, value, out=None, priority=0):
            calls.append(("pushpull", key))
            if out is not None:
                out._data.copy_(value._data)

        def is_capable(self, capability):
            return True

    kv = mt.kv.create("torchteststore")
    assert kv.type == "torchteststore"
    v, o = mt.nd.ones((2, 2)), mt.nd.zeros((2, 2))
    kv.pushpull(3, v, out=o)
    onp.testing.assert_array_equal(o.asnumpy(), v.asnumpy())
    assert ("pushpull", 3) in calls


def test_unknown_kvstore_type_raises():
    with pytest.raises((ValueError, KeyError)):
        mt.kv.create("no_such_backend_xyz")
    with pytest.raises(TypeError):
        mt.kv.create(3)


@pytest.mark.parametrize("name", ["local", "device", "nccl", "dist_sync",
                                  "dist_device_sync", "dist_async", "dist",
                                  "p3", "horovod", "byteps"])
def test_every_reference_type_name_creates_a_store(name):
    kv = mt.kv.create(name)
    jkv = mx.kv.create(name)
    assert kv.type == jkv.type == name
    assert (kv.rank, kv.num_workers) == (0, 1)


# ----------------------------------------------------------------------
# compression, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["2bit", "1bit"])
@pytest.mark.parametrize("shape", [(5, 7), (16,), (3, 4, 5), (1,)])
@pytest.mark.parametrize("threshold", [0.5, 0.1])
def test_compression_matches_the_reference_bit_for_bit(kind, shape,
                                                       threshold):
    """Packed codes, residuals and the decompressed values over four
    pushes with error feedback (bf16 gradients in the last)."""
    params = {"type": kind, "threshold": threshold}
    jc, tc = jcomp.GradientCompression(params), \
        tcomp.GradientCompression(params)
    assert jc.get_compression_factor() == tc.get_compression_factor()
    rs = onp.random.RandomState(len(shape))
    for step in range(4):
        g = rs.normal(0, 0.4, shape).astype("float32")
        if step == 3:
            jg, tg = jnp.asarray(g, jnp.bfloat16), \
                torch.from_numpy(g).bfloat16()
        else:
            jg, tg = jnp.asarray(g), torch.from_numpy(g)
        jp, tp_ = jc.compress("k", jg), tc.compress("k", tg)
        onp.testing.assert_array_equal(tp_.numpy(), onp.asarray(jp))
        assert tp_.numel() == tc.compressed_nbytes(int(onp.prod(shape)))
        onp.testing.assert_array_equal(tc._residuals["k"].numpy(),
                                       onp.asarray(jc._residuals["k"]))
        onp.testing.assert_array_equal(
            tc.decompress(tp_, shape).numpy(),
            onp.asarray(jc.decompress(jp, shape)))


def test_compression_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="1bit"):
        tcomp.GradientCompression({"type": "3bit"})


def test_compressed_pushes_match_the_reference_store():
    def run(m):
        kv = m.kv.create("local")
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.3})
        kv.init("g", m.np.zeros((4, 6)))
        outs = []
        for s in range(3):
            g = onp.random.RandomState(s).normal(0, 0.5, (4, 6))
            o = m.np.zeros((4, 6))
            kv.pushpull("g", m.np.array(g.astype("float32")), out=o)
            outs.append(o.asnumpy())
        return outs
    j, t = _both(run)
    for a, b in zip(t, j):
        onp.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# gluon.utils and the multi-device Trainer loop
# (tests/test_multidevice_trainer.py, tests/test_parallel.py:368)
# ----------------------------------------------------------------------
def _loss(net, x, y):
    return ((net(x) - y) ** 2).sum()


def test_split_and_load_trainer_loop_matches_full_batch():
    x, y = batch(3)
    w = dense_weights(3)
    ctxs = [mt.cpu(0), mt.cpu(1)]
    net_a = t_dense(w)
    tr_a = tgluon.Trainer(net_a.collect_params(), "sgd",
                          {"learning_rate": 0.5}, kvstore="device")
    xs, ys = split_and_load(x, ctxs), split_and_load(y, ctxs)
    with tautograd.record():
        losses = [_loss(net_a, xi, yi) for xi, yi in zip(xs, ys)]
    tautograd.backward(losses)
    tr_a.step(batch_size=8)
    net_b = t_dense(w)
    tr_b = tgluon.Trainer(net_b.collect_params(), "sgd",
                          {"learning_rate": 0.5}, kvstore="device")
    with tautograd.record():
        loss = _loss(net_b, mt.np.array(x), mt.np.array(y))
    loss.backward()
    tr_b.step(batch_size=8)
    for k, p in net_a.collect_params().items():
        onp.testing.assert_allclose(p.data().asnumpy(),
                                    net_b.collect_params()[k].data()
                                    .asnumpy(), rtol=1e-5, atol=1e-6)


def test_split_and_load_shapes_and_devices():
    x = mt.np.arange(12.0).reshape(12, 1)
    shards = split_and_load(x, [mt.cpu(i) for i in range(4)])
    assert len(shards) == 4 and [s.shape for s in shards] == [(3, 1)] * 4
    onp.testing.assert_allclose(
        onp.concatenate([s.asnumpy() for s in shards]), x.asnumpy())
    from mxnet_tpu.gluon.utils import split_data as j_split
    from mxnet_tpu_torch.gluon.utils import split_data as t_split
    for n, even in ((5, False), (3, True)):
        got = [s.asnumpy() for s in t_split(x, n, even_split=even)]
        want = [s.asnumpy() for s in j_split(mx.np.arange(12.0).reshape(
            12, 1), n, even_split=even)]
        assert [g.shape for g in got] == [w.shape for w in want]
    with pytest.raises(ValueError, match="evenly"):
        t_split(x, 5)


def test_multi_device_loop_converges():
    rs = onp.random.RandomState(1)
    x = rs.normal(0, 1, (16, 4)).astype("float32")
    y = x @ rs.normal(0, 1, (4, 3)).astype("float32")
    net = t_dense(dense_weights(7))
    tr = tgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.05}, kvstore="device")

    def total():
        return float(_loss(net, mt.np.array(x), mt.np.array(y)))
    before = total()
    ctxs = [mt.cpu(0), mt.cpu(1)]
    for _ in range(10):
        xs, ys = split_and_load(x, ctxs), split_and_load(y, ctxs)
        with tautograd.record():
            losses = [_loss(net, xi, yi) for xi, yi in zip(xs, ys)]
        tautograd.backward(losses)
        tr.step(batch_size=16)
    assert total() < 0.5 * before


def test_kvstore_trainer_on_mesh_batch():
    """:368: the reference-style loop over a 'device' store; the weights
    after the step equal the JAX package's."""
    w = dense_weights(9, 2, 4)

    def run(m, make):
        net = make(w, 2, 4)
        tr = m.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1}, kvstore="device")
        parts = m.gluon.utils.split_and_load(m.np.ones((8, 4)), [m.cpu(0)])
        with m.autograd.record():
            losses = [m.gluon.loss.L2Loss()(net(p), m.np.zeros((8, 2)))
                      for p in parts]
        for L in losses:
            L.backward()
        tr.step(8)
        return {k: p.data().asnumpy() for k, p in
                net.collect_params().items()}
    j, t = run(mx, j_dense), run(mt, t_dense)
    for k in j:
        onp.testing.assert_allclose(t[k], j[k], rtol=1e-6, atol=1e-7)


def test_clip_global_norm_matches_the_reference():
    from mxnet_tpu.gluon.utils import clip_global_norm as j_clip
    from mxnet_tpu_torch.gluon.utils import clip_global_norm as t_clip
    rs = onp.random.RandomState(0)
    arrs = [rs.normal(0, 1, s).astype("float32") for s in ((3, 4), (5,))]
    ja = [mx.np.array(a) for a in arrs]
    ta = [mt.np.array(a) for a in arrs]
    assert abs(t_clip(ta, 1.0) - j_clip(ja, 1.0)) < 1e-5
    for a, b in zip(ta, ja):
        onp.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-5)
    with pytest.warns(UserWarning, match="nan or inf"):
        t_clip([mt.np.array([float("inf")])], 1.0)


# ----------------------------------------------------------------------
# the Trainer's update_on_kvstore (tests/test_trainer_behaviors.py)
# ----------------------------------------------------------------------
def test_update_on_kvstore_matches_local_update():
    xs = [onp.random.RandomState(3).normal(0, 1, (4, 6)).astype("float32")]
    xs, ys = xs * 4, [onp.zeros((4, 3), "float32")] * 4
    w = dense_weights(13, 3, 6)
    t_on, t_off = (t_trainer_run("local", 4, xs, ys, w, on)
                   for on in (True, False))
    j_on = j_trainer_run("local", 4, xs, ys, w, True)
    for k in t_on:
        onp.testing.assert_allclose(t_on[k], t_off[k], rtol=1e-6)
        onp.testing.assert_allclose(t_on[k], j_on[k], rtol=1e-5, atol=1e-6)


def _net_trainer(on_kv=True):
    net = t_dense(dense_weights(4, 2, 3), 2, 3)
    tr = tgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1}, kvstore="local",
                        update_on_kvstore=on_kv)
    return net, tr


def test_update_on_kvstore_stale_protocol_holds():
    net, tr = _net_trainer()
    with tautograd.record():
        loss = net(mt.np.ones((1, 3))).sum()
    loss.backward()
    tr.step(1)
    with pytest.raises(UserWarning):
        tr.step(1)


def test_update_on_kvstore_rejects_local_update_calls():
    net, tr = _net_trainer()
    with tautograd.record():
        net(mt.np.ones((1, 3))).sum().backward()
    with pytest.raises(ValueError, match="update_on_kvstore"):
        tr.update(1)
    with pytest.raises(ValueError, match="update_on_kvstore"):
        tr.allreduce_grads()


def test_update_on_kvstore_stale_raise_leaves_weights_untouched():
    class Net(tgluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.a = tnn.Dense(3, in_units=4)
            self.b = tnn.Dense(3, in_units=4)

        def forward(self, x, which):
            return self.a(x) if which == "a" else self.b(x)
    net = Net()
    net.initialize(device="cpu")
    tr = tgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.5}, kvstore="local",
                        update_on_kvstore=True)
    wa = net.a.weight.data().asnumpy().copy()
    with tautograd.record():
        net(mt.np.ones((2, 4)), "a").sum().backward()
    with pytest.raises(UserWarning):
        tr.step(1)
    onp.testing.assert_array_equal(net.a.weight.data().asnumpy(), wa)


def test_update_on_kvstore_save_load_states(tmp_path):
    def make():
        net = t_dense(dense_weights(21, 4, 6), 4, 6)
        return net, tgluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1, "momentum": 0.9},
                                   kvstore="local", update_on_kvstore=True)

    def one_step(net, tr, seed):
        x = mt.np.array(onp.random.RandomState(seed).normal(0, 1, (3, 6))
                        .astype("float32"))
        with tautograd.record():
            (net(x) ** 2).sum().backward()
        tr.step(3)

    net1, tr1 = make()
    for s in range(3):
        one_step(net1, tr1, s)
    f = str(tmp_path / "kv.states")
    tr1.save_states(f)
    net2, tr2 = make()
    net2.weight.set_data(net1.weight.data())
    net2.bias.set_data(net1.bias.data())
    tr2._init_kvstore()
    for i, p in enumerate(tr2._params):
        tr2._kvstore.init(i, p.data())
    tr2.load_states(f)
    one_step(net1, tr1, 99)
    one_step(net2, tr2, 99)
    onp.testing.assert_allclose(net2.weight.data().asnumpy(),
                                net1.weight.data().asnumpy(), rtol=1e-6)


# ----------------------------------------------------------------------
# dist_sync over two ranks
# ----------------------------------------------------------------------
def test_rank_children_import_no_jax(ranks):
    assert [bool(r["imported_jax"]) for r in ranks] == [False] * WORLD
    assert [(int(r["rank"]), int(r["num_workers"])) for r in ranks] == \
        [(0, 2), (1, 2)]


def test_dist_sync_pull_is_the_exact_sum(ranks):
    base = onp.arange(12, dtype="float32").reshape(3, 4)
    for r in ranks:
        onp.testing.assert_array_equal(r["push_pull"], base * 3)
        onp.testing.assert_array_equal(r["pushpull_a"],
                                       onp.full((2, 2), 4.0))
        onp.testing.assert_array_equal(r["pushpull_b"],
                                       onp.full((2, 2), 30.0))


def test_dist_sync_broadcast_takes_worker_0(ranks):
    for r in ranks:
        onp.testing.assert_array_equal(r["broadcast"], onp.full((2, 3), 7.0))


def test_dist_sync_compression_sums_each_workers_roundtrip(ranks):
    """Each worker's push passes its own error-feedback round trip, then
    the dequantized values sum over the workers: the reference's
    compressions of each rank's gradients, summed."""
    comps = [jcomp.GradientCompression({"type": "2bit", "threshold": 0.5})
             for _ in range(WORLD)]
    for s in range(3):
        want = sum(onp.asarray(comps[r].roundtrip(
            "g", jnp.asarray(onp.random.RandomState((r, s)).normal(
                0, 1, (5, 7)).astype("float32")))) for r in range(WORLD))
        for r in ranks:
            onp.testing.assert_array_equal(r["compressed_%d" % s], want)


@pytest.mark.parametrize("name", ["plain", "on_kv"])
def test_dist_sync_trainer_equals_one_process_on_the_whole_batch(ranks,
                                                                  name):
    """Worker 0's weights broadcast at the first step, the gradients of
    the two halves summed: the update of one process stepping on the
    whole batch (the JAX package's, too)."""
    xs, ys = zip(*[batch(s) for s in range(3)])
    want = j_trainer_run("local", 3, xs, ys, dense_weights(100),
                         update_on_kvstore=name == "on_kv")
    for r in ranks:
        for k, w in want.items():
            onp.testing.assert_allclose(r["trainer_%s/%s" % (name, k)], w,
                                        rtol=1e-5, atol=1e-6)


def test_dist_sync_compressed_trainer_keeps_the_replicas_equal(ranks):
    keys = [k for k in ranks[0] if k.startswith("trainer_compressed/")]
    assert keys
    for k in keys:
        onp.testing.assert_array_equal(ranks[1][k], ranks[0][k])
