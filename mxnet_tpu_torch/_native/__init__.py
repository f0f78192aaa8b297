"""The native (C++) host side of the data pipeline, built at first use.

Counterpart of ``mxnet_tpu/_native/``: ``io_core.cpp`` (the port keeps
its own copy) holds an mmap'd recordio scanner and a GIL-free threaded
prefetch ring.  :func:`get_lib` compiles it with ``g++`` (``-O2``, about
a second) into the git-ignored ``mxnet_tpu_torch/_build/<hash>/``, keyed
by a hash of the source and the flags, beside the CUDA kernels' builds,
and loads it through ``ctypes``.  A build or load that fails raises
``RuntimeError`` with the compiler's or loader's message: nothing falls
back quietly.  ``MXNET_NATIVE_DISABLE=1`` asks for the pure-Python
reader instead (:func:`get_lib` then returns None, and
``gluon.data.RecordFileDataset`` reads through ``recordio``).

Nothing here touches torch, so a ``DataLoader`` worker may read records.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["get_lib", "enabled", "NativeRecordFile", "NativePrefetcher",
           "library_path"]

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "io_core.cpp")
BUILD = os.path.join(os.path.dirname(_DIR), "_build")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LIB = None
_LOCK = threading.Lock()


def enabled():
    """False when ``MXNET_NATIVE_DISABLE=1`` asks for the Python reader."""
    return os.environ.get("MXNET_NATIVE_DISABLE") != "1"


def library_path():
    """``_build/<key>/libmxtpu_io.so``, the key a hash of the source and
    the flags."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD, h.hexdigest()[:16], "libmxtpu_io.so")


def _build(out):
    """Compile ``io_core.cpp`` into ``out`` (through a temporary file, so
    a concurrent or torn build never leaves a partial library)."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    errors = []
    # a toolchain without g++ still compiles C++ through gcc / cc, which
    # do not link the C++ runtime on their own
    for cmd in (["g++", *FLAGS, SOURCE, "-o", tmp],
                ["gcc", *FLAGS, SOURCE, "-o", tmp, "-lstdc++"],
                ["cc", *FLAGS, SOURCE, "-o", tmp, "-lstdc++"]):
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            errors.append("%s: %s" % (cmd[0], e))
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            return
        errors.append("%s (exit %d):\n%s" % (" ".join(cmd), r.returncode,
                                             r.stdout + r.stderr))
        break               # the compiler ran and refused: say why
    raise RuntimeError("mxnet_tpu_torch: building the native IO library "
                       "failed:\n" + "\n".join(errors))


def _declare(lib):
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.mxtpu_rec_open.restype = vp
    lib.mxtpu_rec_open.argtypes = [ctypes.c_char_p]
    lib.mxtpu_rec_count.restype = i64
    lib.mxtpu_rec_count.argtypes = [vp]
    lib.mxtpu_rec_length.restype = i64
    lib.mxtpu_rec_length.argtypes = [vp, i64]
    lib.mxtpu_rec_read.restype = i64
    lib.mxtpu_rec_read.argtypes = [vp, i64, ctypes.c_char_p, i64]
    lib.mxtpu_rec_close.argtypes = [vp]
    lib.mxtpu_prefetch_start.restype = vp
    lib.mxtpu_prefetch_start.argtypes = [vp, ctypes.POINTER(i64), i64,
                                         ctypes.c_int32, ctypes.c_int32]
    lib.mxtpu_prefetch_next.restype = i64
    lib.mxtpu_prefetch_next.argtypes = [vp, ctypes.c_char_p, i64]
    lib.mxtpu_prefetch_stop.argtypes = [vp]
    return lib


def get_lib():
    """The loaded io_core library, built first if need be; None when
    ``MXNET_NATIVE_DISABLE=1``.  Raises ``RuntimeError`` when it cannot
    be built or loaded."""
    global _LIB
    if not enabled():
        return None
    with _LOCK:
        if _LIB is None:
            out = library_path()
            if not os.path.exists(out):
                _build(out)
            try:
                _LIB = _declare(ctypes.CDLL(out))
            except OSError as e:
                raise RuntimeError("mxnet_tpu_torch: loading the native IO "
                                   "library %s failed: %s" % (out, e)) \
                    from None
        return _LIB


class NativeRecordFile:
    """An mmap'd recordio file read by index.  It needs no ``.idx``: the
    index is rebuilt by a scan of the bytes at open."""

    def __init__(self, path):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("the native IO library is disabled "
                               "(MXNET_NATIVE_DISABLE=1)")
        self._lib = lib
        self._h = lib.mxtpu_rec_open(os.fsencode(path))
        if not self._h:
            raise IOError("cannot open %s" % path)

    def __len__(self):
        return self._lib.mxtpu_rec_count(self._h)

    def read(self, idx):
        n = self._lib.mxtpu_rec_length(self._h, idx)
        if n < 0:
            raise IndexError(idx)
        buf = ctypes.create_string_buffer(n)
        r = self._lib.mxtpu_rec_read(self._h, idx, buf, n)
        if r < 0:
            raise IOError("read failed")
        return buf.raw[:r]

    def prefetch(self, order, num_threads=4, depth=64):
        """A :class:`NativePrefetcher` over the records of ``order``."""
        return NativePrefetcher(self, order, num_threads, depth)

    def close(self):
        if self._h:
            self._lib.mxtpu_rec_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativePrefetcher:
    """The records of ``order``, in that order, read ahead by
    ``num_threads`` C++ threads keeping up to ``depth`` ready."""

    def __init__(self, recfile, order, num_threads=4, depth=64):
        self._lib = recfile._lib
        self._rec = recfile             # keeps the mapping alive
        order = [int(i) for i in order]
        arr = (ctypes.c_int64 * len(order))(*order)
        self._max_len = max((self._lib.mxtpu_rec_length(recfile._h, i)
                             for i in order), default=0)
        self._h = self._lib.mxtpu_prefetch_start(
            recfile._h, arr, len(order), num_threads, depth)
        self._buf = ctypes.create_string_buffer(max(self._max_len, 1))

    def __iter__(self):
        return self

    def __next__(self):
        n = self._lib.mxtpu_prefetch_next(self._h, self._buf,
                                          len(self._buf))
        if n == -2:
            raise StopIteration
        if n < 0:
            raise IOError("prefetch read failed")
        return self._buf.raw[:n]

    def close(self):
        if self._h:
            self._lib.mxtpu_prefetch_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
