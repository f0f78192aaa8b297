"""``gluon.data`` of the port against the JAX package: every ``Dataset``
method, the samplers, the batchify functions, the ``DataLoader`` at 0
and 2 workers under each ``last_batch`` and with an ``elastic_plan``, a
killed worker rebuilt once, the vision transforms (deterministic ones
exactly, ``Normalize`` within 1e-6, seeded random ones at 0 workers) and
the vision datasets, which read local files and refuse when they are
absent.  Port batches are NDArrays on the CPU (``with mt.cpu():``); the
workers' side runs no torch operation.
"""
import random

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as JT
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data import batchify as tbatchify
from mxnet_tpu_torch.gluon.data.vision import transforms as TT
from mxnet_tpu_torch.parallel.seq_data import EpochPlan

cv2 = pytest.importorskip("cv2")


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return onp.asarray(x)


def _same(got, want, tol=0.0):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, tol)
        return
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    if tol:
        onp.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    else:
        onp.testing.assert_array_equal(got, want)


def _arrays(n=10):
    rng = onp.random.RandomState(0)
    return (rng.normal(0, 1, (n, 3)).astype("float32"),
            rng.randint(0, 5, n).astype("int32"))


def _both(fn):
    """fn(data package) for the JAX package and the port (on the CPU)."""
    with mx.cpu():
        want = fn(jdata)
    with mt.cpu():
        got = fn(tdata)
    return got, want


# ----------------------------------------------------------------------
# datasets, samplers, batchify
# ----------------------------------------------------------------------
@pytest.mark.parametrize("method", ["index", "filter", "shard", "take",
                                    "sample", "transform", "transform_eager",
                                    "transform_first", "simple"])
def test_dataset_methods_match(method):
    x, y = _arrays()

    def run(pkg):
        ds = pkg.ArrayDataset(x, y)
        if method == "index":
            return [ds[i] for i in range(len(ds))]
        if method == "filter":
            out = ds.filter(lambda s: s[1] > 1)
        elif method == "shard":
            out = [ds.shard(3, i) for i in range(3)]
            return [[s[j] for j in range(len(s))] for s in out]
        elif method == "take":
            out = ds.take(4)
        elif method == "sample":
            out = ds.sample(pkg.SequentialSampler(4, start=3))
        elif method == "transform":
            out = ds.transform(lambda a, b: (a * 2, b + 1))
        elif method == "transform_eager":
            out = ds.transform(lambda a, b: (a - 1, b), lazy=False)
        elif method == "transform_first":
            out = ds.transform_first(lambda a: a[::-1].copy())
        else:
            out = pkg.SimpleDataset(list(range(7))).transform(lambda v: v * 3)
        return [out[i] for i in range(len(out))]
    got, want = _both(run)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                for a, b in zip(gi, wi):
                    _same(a, b)
        elif isinstance(w, tuple):
            for a, b in zip(g, w):
                _same(a, b)
        else:
            assert g == w


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_match(last):
    def run(pkg):
        onp.random.seed(11)
        out = [list(pkg.SequentialSampler(5, 2)), list(pkg.RandomSampler(9)),
               list(pkg.FilterSampler(lambda v: v % 3 == 0,
                                      list(range(10))))]
        bs = pkg.BatchSampler(pkg.SequentialSampler(10), 4, last)
        out += [len(bs), list(bs), list(bs), len(bs)]
        return out
    got, want = _both(run)
    assert got == want


@pytest.mark.parametrize("fn", ["stack", "pad", "pad_axis1", "group"])
def test_batchify_matches(fn):
    rng = onp.random.RandomState(2)
    seqs = [rng.randint(0, 9, (int(rng.randint(1, 6)), 3)).astype("int32")
            for _ in range(4)]
    imgs = [rng.normal(0, 1, (2, 3)).astype("float32") for _ in range(4)]

    def run(pkg):
        b = pkg.batchify
        if fn == "stack":
            return b.Stack()(imgs)
        if fn == "pad":
            return b.Pad(val=-1)(seqs)
        if fn == "pad_axis1":
            return b.Pad(axis=1, val=7, dtype="float32")(
                [s.T.copy() for s in seqs])
        return list(b.Group(b.Stack(), b.Pad())(list(zip(imgs, seqs))))
    got, want = _both(run)
    _same(got, want)
    leaf = got[0] if isinstance(got, list) else got
    assert isinstance(leaf, mt.nd.NDArray)
    with tbatchify.host_batches():           # what a loader's workers get
        assert isinstance(tbatchify.Stack()(imgs), onp.ndarray)


# ----------------------------------------------------------------------
# DataLoader
# ----------------------------------------------------------------------
@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_dataloader_batches_match(workers, last):
    x, y = _arrays(11)
    with mx.cpu():
        jl = jdata.DataLoader(jdata.ArrayDataset(x, y), batch_size=4,
                              last_batch=last)
        want = [list(jl), list(jl)]           # rollover spans the epochs
    with mt.cpu():
        with tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                              last_batch=last, num_workers=workers) as tl:
            got = [list(tl), list(tl)]
            assert len(tl) == len(jl)
    for g, w in zip(got, want):
        _same(g, w)
    assert all(isinstance(b[0], mt.nd.NDArray) and b[0]._data.device.type
               == "cpu" for b in got[0])


def test_dataloader_shuffle_and_batchify_fn_match():
    x, y = _arrays(9)

    def run(pkg):
        onp.random.seed(5)
        b = pkg.batchify
        return list(pkg.DataLoader(pkg.ArrayDataset(x, y), batch_size=3,
                                   shuffle=True,
                                   batchify_fn=b.Group(b.Stack(),
                                                       b.Stack())))
    got, want = _both(run)
    _same([list(g) for g in got], [list(w) for w in want])


def test_dataloader_elastic_plan_matches():
    x, y = _arrays(10)
    from mxnet_tpu.parallel import EpochPlan as JPlan

    def run(pkg, plan_cls):
        plan = plan_cls(10, world=2, batch_per_rank=2)
        loaders = [pkg.DataLoader(pkg.ArrayDataset(x, y), elastic_plan=plan,
                                  elastic_rank=r) for r in range(2)]
        its = [iter(ld) for ld in loaders]
        out = []
        while not plan.done():
            for it in its:
                b = next(it, None)
                if b is not None:
                    out.append(b)
        return out
    with mx.cpu():
        want = run(jdata, JPlan)
    with mt.cpu():
        got = run(tdata, EpochPlan)
    _same(got, want)
    with pytest.raises(ValueError, match="elastic_plan"):
        tdata.DataLoader(tdata.ArrayDataset(x), batch_size=2,
                         elastic_plan=EpochPlan(10, 1, 2))


def _segments(loader):
    import glob
    return glob.glob("/dev/shm/mxt_%s_*" % loader._token)


@pytest.mark.parametrize("min_bytes", [1, 1 << 20])
def test_worker_batches_through_shared_memory_are_unlinked(monkeypatch,
                                                           min_bytes):
    """Arrays from SHARED_MIN_BYTES on leave the workers through shared
    segments, which the main process unlinks as it takes them."""
    from mxnet_tpu_torch.gluon.data import dataloader
    monkeypatch.setattr(dataloader, "SHARED_MIN_BYTES", min_bytes)
    rng = onp.random.RandomState(3)
    x = rng.normal(0, 1, (12, 64, 1100)).astype("float32")  # 3.4 MB a batch
    y = rng.randint(0, 9, 12).astype("int64")
    with mx.cpu():
        want = list(jdata.DataLoader(jdata.ArrayDataset(x, y),
                                     batch_size=4))
    with mt.cpu(), tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                                    num_workers=2) as ld:
        got = list(ld)
        assert _segments(ld) == []
        it = iter(ld)
        next(it)                              # batches left in flight
    assert _segments(ld) == []                # close() removed them
    _same(got, want)


@pytest.mark.parametrize("last", ["keep", "rollover"])
def test_thread_pool_loader_matches(last):
    x, y = _arrays(11)
    with mx.cpu():
        jl = jdata.DataLoader(jdata.ArrayDataset(x, y), batch_size=4,
                              last_batch=last)
        want = [list(jl), list(jl)]
    with mt.cpu(), tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                                    last_batch=last, num_workers=3,
                                    thread_pool=True) as tl:
        got = [list(tl), list(tl)]
    for g, w in zip(got, want):
        _same(g, w)


class _Slow:
    """Slow enough that a worker killed mid-epoch holds a task."""

    def __init__(self, n=16):
        self.data = onp.arange(n * 4, dtype="float32").reshape(n, 4)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, i):
        import time
        time.sleep(0.05)
        return self.data[i]


def test_a_killed_worker_is_rebuilt_once_and_the_epoch_is_whole():
    tfault.clear()
    base = tprof.get_counter("fault::worker_restarts")
    tfault.inject("worker_kill", at=2)
    try:
        with mt.cpu(), tdata.DataLoader(_Slow(), batch_size=4,
                                        num_workers=2, timeout=30) as ld:
            got = list(ld)
    finally:
        tfault.clear()
    assert tprof.get_counter("fault::worker_restarts") == base + 1
    _same(got, [_Slow().data[i:i + 4] for i in range(0, 16, 4)])


def test_a_second_death_in_the_epoch_raises():
    tfault.clear()
    tfault.inject("worker_kill", at=1, count=4)
    try:
        with pytest.raises(RuntimeError, match="crashing persistently"):
            with mt.cpu(), tdata.DataLoader(_Slow(), batch_size=4,
                                            num_workers=2, timeout=30,
                                            prefetch=1) as ld:
                list(ld)
    finally:
        tfault.clear()


def test_profiler_counts_the_loaders_batches(tmp_path):
    tprof.set_config(filename=str(tmp_path / "p.json"), profile_all=False,
                     profile_imperative=False, profile_data=True)
    b0 = tprof.get_counter("dataloader::batches")
    s0 = tprof.get_counter("dataloader::samples")
    tprof.set_state("run")
    try:
        with mt.cpu():
            n = len(list(tdata.DataLoader(tdata.ArrayDataset(
                _arrays(10)[0]), batch_size=4)))
    finally:
        tprof.set_state("stop")
    assert n == 3
    assert tprof.get_counter("dataloader::batches") == b0 + 3
    assert tprof.get_counter("dataloader::samples") == s0 + 10


def test_worker_side_runs_no_torch_op(tmp_path):
    """A worker's batch of an image record dataset through the vision
    transforms: numpy all the way (the batchify functions on the host
    side), traced by torch's dispatcher in this process."""
    from mxnet_tpu_torch import recordio
    path = str(tmp_path / "w")
    rec = recordio.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    rng = onp.random.RandomState(1)
    for i in range(4):
        img = rng.randint(0, 256, (20, 24, 3)).astype("uint8")
        rec.write_idx(i, recordio.pack_img((0, float(i), i, 0), img))
    rec.close()
    ds = tdata.vision.ImageRecordDataset(path + ".rec").transform_first(
        TT.Compose([TT.CenterCrop(16), TT.RandomFlipLeftRight(),
                    TT.ToTensor(), TT.Normalize([0.5] * 3, [0.25] * 3)]))
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))
    with Count(), tbatchify.host_batches():
        batch = tdata.default_mp_batchify_fn([ds[i] for i in range(4)])
        batch2 = tbatchify.Group(tbatchify.Stack(), tbatchify.Stack())(
            [ds[i] for i in range(4)])
    assert Count.n == 0
    assert isinstance(batch[0], onp.ndarray) and batch[0].shape == \
        (4, 3, 16, 16)
    assert isinstance(batch2[0], onp.ndarray)


# ----------------------------------------------------------------------
# vision transforms
# ----------------------------------------------------------------------
def _img(seed=0, h=20, w=26):
    return onp.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        "uint8")


@pytest.mark.parametrize("name", ["ToTensor", "Cast", "Resize", "Resize_keep",
                                  "CenterCrop", "CenterCrop_up", "Compose"])
def test_deterministic_transforms_match_exactly(name):
    img = _img()

    def make(T):
        return {"ToTensor": lambda: T.ToTensor(),
                "Cast": lambda: T.Cast("float16"),
                "Resize": lambda: T.Resize((13, 9)),
                "Resize_keep": lambda: T.Resize(12, keep_ratio=True),
                "CenterCrop": lambda: T.CenterCrop((10, 7)),
                "CenterCrop_up": lambda: T.CenterCrop(32),
                "Compose": lambda: T.Compose([T.Resize(16), T.CenterCrop(12),
                                              T.ToTensor()])}[name]()
    with mx.cpu():
        want = make(JT)(img)
    got = make(TT)(img)
    assert isinstance(got, onp.ndarray)
    _same(got, want)
    dev = make(TT)(mt.nd.array(img, ctx=mt.cpu()))    # on a device array
    assert isinstance(dev, mt.nd.NDArray)
    _same(dev, want)


@pytest.mark.parametrize("mean,std", [(0.5, 0.25),
                                      ([0.1, 0.2, 0.3], [0.5, 0.6, 0.7])])
def test_normalize_matches(mean, std):
    x = onp.random.RandomState(3).uniform(0, 1, (3, 5, 4)).astype("float32")
    with mx.cpu():
        want = JT.Normalize(mean, std)(x)
    _same(TT.Normalize(mean, std)(x), want, 1e-6)
    _same(TT.Normalize(mean, std)(mt.nd.array(x, ctx=mt.cpu())), want, 1e-6)


@pytest.mark.parametrize("name", ["RandomResizedCrop", "RandomCrop",
                                  "RandomCrop_pad", "RandomFlipLeftRight",
                                  "RandomFlipTopBottom", "RandomBrightness",
                                  "RandomContrast", "RandomSaturation",
                                  "RandomColorJitter", "RandomLighting"])
def test_seeded_random_transforms_match(name):
    img = _img(4)

    def make(T):
        return {"RandomResizedCrop": lambda: T.RandomResizedCrop(
                    (8, 6), scale=(0.2, 0.9)),
                "RandomCrop": lambda: T.RandomCrop((9, 7)),
                "RandomCrop_pad": lambda: T.RandomCrop(18, pad=2),
                "RandomFlipLeftRight": lambda: T.RandomFlipLeftRight(),
                "RandomFlipTopBottom": lambda: T.RandomFlipTopBottom(),
                "RandomBrightness": lambda: T.RandomBrightness(0.4),
                "RandomContrast": lambda: T.RandomContrast(0.4),
                "RandomSaturation": lambda: T.RandomSaturation(0.4),
                "RandomColorJitter": lambda: T.RandomColorJitter(0.3, 0.3,
                                                                 0.3),
                "RandomLighting": lambda: T.RandomLighting(0.5)}[name]()

    def draws(T):
        random.seed(7)
        onp.random.seed(7)
        t = make(T)
        return [_np(t(img)) for _ in range(6)]
    with mx.cpu():
        want = draws(JT)
    got = draws(TT)
    _same(got, want)


# ----------------------------------------------------------------------
# vision datasets
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
def test_downloading_datasets_refuse_without_files(tmp_path, name):
    for pkg in (jdata.vision, tdata.vision):
        with pytest.raises(FileNotFoundError):
            getattr(pkg, name)(root=str(tmp_path / name))


def test_mnist_and_cifar_read_local_files(tmp_path):
    import pickle
    import struct
    rng = onp.random.RandomState(8)
    imgs = rng.randint(0, 256, (5, 28, 28)).astype("uint8")
    labels = rng.randint(0, 10, 5).astype("uint8")
    root = tmp_path / "mnist"
    root.mkdir()
    (root / "train-labels-idx1-ubyte").write_bytes(
        struct.pack(">II", 2049, 5) + labels.tobytes())
    (root / "train-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 2051, 5, 28, 28) + imgs.tobytes())
    croot = tmp_path / "cifar" / "cifar-10-batches-py"
    croot.mkdir(parents=True)
    for i in range(1, 6):
        with open(croot / ("data_batch_%d" % i), "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (2, 3072)).astype(
                "uint8"), b"labels": list(rng.randint(0, 10, 2))}, f)
    for name, path in (("MNIST", root), ("CIFAR10", tmp_path / "cifar")):
        with mx.cpu():
            jd = getattr(jdata.vision, name)(root=str(path))
            want = [jd[i] for i in range(len(jd))]
        td = getattr(tdata.vision, name)(root=str(path))
        got = [td[i] for i in range(len(td))]
        assert len(got) == len(want)
        for (gi, gl), (wi, wl) in zip(got, want):
            _same(gi, wi)
            assert int(gl) == int(wl)


def test_image_folder_and_list_datasets_match(tmp_path):
    rng = onp.random.RandomState(9)
    lines = []
    for c in ("cat", "dog"):
        (tmp_path / c).mkdir()
        for i in range(2):
            p = tmp_path / c / ("%d.png" % i)
            cv2.imwrite(str(p), rng.randint(0, 256, (10, 12, 3)).astype(
                "uint8"))
            lines.append("%d\t%d\t%s/%d.png" % (len(lines), c == "dog", c, i))
    lst = tmp_path / "x.lst"
    lst.write_text("\n".join(lines) + "\n")
    for make in (lambda pkg: pkg.vision.ImageFolderDataset(str(tmp_path)),
                 lambda pkg: pkg.vision.ImageListDataset(str(tmp_path),
                                                         str(lst))):
        with mx.cpu():
            jd = make(jdata)
            want = [jd[i] for i in range(len(jd))]
        td = make(tdata)
        got = [td[i] for i in range(len(td))]
        for (gi, gl), (wi, wl) in zip(got, want):
            _same(gi, wi)
            assert gl == wl
