"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``.cu`` source is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded through ``ctypes``; no PyTorch
header is included, so a build takes seconds.  The build happens at the
first kernel use and is keyed by a hash of the source and the flags:
``_build/<hash>/<name>.so``.  :func:`build_all` starts one ``nvcc`` per
source at once, so a cold start pays for the slowest file, not the sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "mxnet_tpu_torch are built on the machine with "
                           "the card, from the CUDA toolkit")
    return path


def _target(name):
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD, key[:16], name + ".so")


def _start(name):
    """Start nvcc for one source (None when its library is built)."""
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(job):
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (%d) building %s:\n%s"
                           % (proc.returncode, out, log))
    os.replace(tmp, out)   # atomic: a concurrent builder sees all or none


def build_all():
    """Build every kernel library that is missing, all nvcc in parallel."""
    with _lock:
        jobs = [_start(n) for n in SOURCES if n not in _libs]
        try:
            for job in jobs:
                _finish(job)
        finally:
            for job in jobs:
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()


def library(name):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu``."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(_start(name))
            lib = ctypes.CDLL(_target(name))
            _declare(name, lib)
            _libs[name] = lib
    return lib


def _signatures():
    """Entry point name -> ``argtypes`` of each source's C functions."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return {
        # q k v q_off k_off o lse BH BHkv T Tk D scale causal stream
        "flash_fwd": {"mx_flash_fwd": [p, p, p, p, p, p, p, i, i, i, i, i,
                                       f, i, p]},
        # q k v dout lse delta q_off k_off dq | dk dv, BH BHkv T Tk D scale
        # causal stream
        "flash_bwd": {"mx_flash_bwd_dq": [p] * 9 + [i] * 5 + [f, i, p],
                      "mx_flash_bwd_dkv": [p] * 10 + [i] * 5 + [f, i, p]},
        # q k_pages v_pages page_table lengths out S H Hkv psz D MP scale
        # stream
        "paged_decode": {"mx_paged_decode": [p, p, p, p, p, p, i, i, i, i,
                                             i, i, f, p]},
    }


def _declare(name, lib):
    sigs = _signatures()
    if name not in sigs:
        raise ValueError("no C interface declared for kernel source %r"
                         % name)
    for fn_name, argtypes in sigs[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
