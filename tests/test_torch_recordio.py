"""RecordIO and the native reader of the port against the JAX package.

``.rec`` / ``.idx`` files written by either package are byte for byte
equal and each package reads the other's: numeric and array labels, raw
payloads, and JPEG / PNG images through cv2.  The port's native reader
(``mxnet_tpu_torch._native``, built with g++ into ``_build/``) and its
Python reader agree record by record, as does the native prefetcher's
order; ``MXNET_NATIVE_DISABLE=1`` serves the Python reader, and a native
build that fails raises with the compiler's message.
"""
import os

import numpy as onp
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import _native
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.gluon.data import RecordFileDataset

cv2 = pytest.importorskip("cv2")


def _records(kind, n=12, seed=0):
    """(header, payload) pairs: numeric labels, array labels or images."""
    rng = onp.random.RandomState(seed)
    out = []
    for i in range(n):
        if kind == "numeric":
            label = float(rng.randint(0, 10)) if i % 2 else int(i % 7)
            out.append(((0, label, i, 0), rng.bytes(int(rng.randint(0, 40)))))
        elif kind == "array":
            label = rng.normal(0, 1, int(rng.randint(1, 5))).astype(
                "float32")
            out.append(((0, label, i, i + 1), rng.bytes(13)))
        else:
            img = rng.randint(0, 256, (int(rng.randint(8, 33)),
                                       int(rng.randint(8, 33)), 3)
                              ).astype("uint8")
            out.append(((0, float(i % 5), i, 0), img))
    return out


def _write(pkg, path, kind, fmt=".jpg"):
    rec = pkg.MXIndexedRecordIO(path + ".idx", path + ".rec", "w")
    for header, payload in _records(kind):
        if kind == "image":
            buf = pkg.pack_img(header, payload, quality=90, img_fmt=fmt)
        else:
            buf = pkg.pack(header, payload)
        rec.write_idx(header[2], buf)
    rec.close()


def _read(pkg, path):
    rec = pkg.MXIndexedRecordIO(path + ".idx", path + ".rec", "r")
    out = [rec.read_idx(k) for k in rec.keys]
    rec.close()
    return out


@pytest.mark.parametrize("kind,fmt", [("numeric", None), ("array", None),
                                      ("image", ".jpg"), ("image", ".png")])
def test_rec_and_idx_are_byte_equal_and_cross_read(tmp_path, kind, fmt):
    jp, tp = str(tmp_path / "j"), str(tmp_path / "t")
    _write(jrec, jp, kind, fmt)
    _write(trec, tp, kind, fmt)
    for ext in (".rec", ".idx"):
        with open(jp + ext, "rb") as a, open(tp + ext, "rb") as b:
            assert a.read() == b.read(), ext
    for reader, path in ((trec, jp), (jrec, tp)):
        for (header, payload), raw in zip(_records(kind), _read(reader,
                                                                path)):
            if kind == "image":
                h, img = reader.unpack_img(raw)
                _, want = jrec.unpack_img(_read(jrec, jp)[header[2]])
                onp.testing.assert_array_equal(img, want)
                assert img.shape == payload.shape
            else:
                h, body = reader.unpack(raw)
                assert body == payload
            if isinstance(header[1], onp.ndarray):
                onp.testing.assert_array_equal(h.label, header[1])
            else:
                assert h.label == header[1] and h.flag == 0
            assert (h.id, h.id2) == (header[2], header[3])


def test_sequential_reader_and_unpack_match(tmp_path):
    path = str(tmp_path / "s.rec")
    w = trec.MXRecordIO(path, "w")
    recs = _records("array", n=5, seed=3)
    for header, payload in recs:
        w.write(trec.pack(header, payload))
    w.close()
    got, want = trec.MXRecordIO(path, "r"), jrec.MXRecordIO(path, "r")
    for _ in recs:
        a, b = got.read(), want.read()
        assert a == b
        ha, pa = trec.unpack(a)
        hb, pb = jrec.unpack(b)
        onp.testing.assert_array_equal(ha.label, hb.label)
        assert pa == pb and ha.flag == hb.flag
    assert got.read() is None and want.read() is None
    got.reset()
    assert got.read() == trec.pack(*recs[0])


def test_native_and_python_readers_agree(tmp_path, monkeypatch):
    path = str(tmp_path / "n")
    _write(trec, path, "numeric")
    native = RecordFileDataset(path + ".rec")
    assert native.native
    lib = _native.library_path()
    assert os.path.exists(lib) and os.sep + "_build" + os.sep in lib
    monkeypatch.setenv("MXNET_NATIVE_DISABLE", "1")
    assert _native.get_lib() is None
    plain = RecordFileDataset(path + ".rec")
    assert not plain.native
    assert len(native) == len(plain) == 12
    assert [native[i] for i in range(12)] == [plain[i] for i in range(12)]


@pytest.mark.parametrize("threads,depth", [(1, 1), (4, 3), (3, 64)])
def test_native_prefetcher_keeps_order_and_contents(tmp_path, threads,
                                                    depth):
    path = str(tmp_path / "p")
    _write(trec, path, "array")
    f = _native.NativeRecordFile(path + ".rec")
    order = list(onp.random.RandomState(threads).permutation(12)) + [0, 5]
    got = list(f.prefetch(order, num_threads=threads, depth=depth))
    assert got == [f.read(i) for i in order]
    f.close()


def test_a_failed_native_build_raises_with_the_compilers_message(
        tmp_path, monkeypatch):
    bad = tmp_path / "io_core.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(_native, "SOURCE", str(bad))
    monkeypatch.setattr(_native, "BUILD", str(tmp_path / "_build"))
    monkeypatch.setattr(_native, "_LIB", None)
    with pytest.raises(RuntimeError, match="native IO library failed"
                                           "(.|\n)*error"):
        _native.get_lib()
    with pytest.raises(RuntimeError):
        RecordFileDataset(str(tmp_path / "missing.rec"))
