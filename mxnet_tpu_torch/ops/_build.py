"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``.cu`` source is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded through ``ctypes``; no PyTorch
header is included, so a build takes seconds.  The build happens at the
first kernel use and is keyed by a hash of the source, every shared
header (``csrc/*.cuh``) and the flags: ``_build/<hash>/<name>.so``,
with nvcc's output beside it (:func:`build_log`).  :func:`build_all`
starts one ``nvcc`` per source at once, so a cold start pays for the
slowest file, not the sum.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "flash_general",
           "paged_general", "flash_bwd_mma", "flash_fwd_mma", "multi_tensor",
           "int8_linear", "int8_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """``_build/<key>/<name>.so``, the key a hash of ``<name>.cu``, of
    each header under ``csrc/`` (name and bytes, so an edited header
    never loads a stale library) and of the flags."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD, h.hexdigest()[:16], name + ".so")


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
    with open(out + ".log", "w") as f:   # ptxas: registers, spills
        f.write(log)
    os.replace(tmp, out)   # atomic: a concurrent builder sees all or none


def build_log(name):
    """nvcc's output for ``csrc/<name>.cu``, ``-Xptxas -v`` included
    (each kernel's registers and spills), kept beside its library."""
    with open(_target(name) + ".log") as f:
        return f.read()


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
    d = ctypes.c_double
    return {
        # q k v q_off k_off o lse BH BHkv T Tk D scale causal stream
        "flash_fwd": {"mx_flash_fwd": [p, p, p, p, p, p, p, i, i, i, i, i,
                                       f, i, p]},
        # q k v dout o lse dlse delta q_off k_off dq | q k v dout lse delta
        # q_off k_off dk dv, BH BHkv T Tk D scale causal stream
        "flash_bwd": {"mx_flash_bwd_dq": [p] * 11 + [i] * 5 + [f, i, p],
                      "mx_flash_bwd_dkv": [p] * 10 + [i] * 5 + [f, i, p]},
        # q k_pages v_pages page_table lengths out part_acc part_ml, S H
        # Hkv psz D MP nsplit kps chunk, scale stream
        "paged_decode": {"mx_paged_decode": [p] * 8 + [i] * 9 + [f, p]},
        # the general kernels: B H Hkv T Tk D (S H Hkv psz D MP for paged),
        # scale as a double, causal, dtype code (general.cuh), stream
        "flash_general": {
            # q k v q_off k_off o lse
            "mx_flash_fwd_general": [p] * 7 + [i] * 6 + [d, i, i, p],
            # q k v dout o lse dlse delta q_off k_off dq
            "mx_flash_bwd_dq_general": [p] * 11 + [i] * 6 + [d, i, i, p],
            # q k v dout lse delta q_off k_off dk dv
            "mx_flash_bwd_dkv_general": [p] * 10 + [i] * 6 + [d, i, i, p]},
        # the tensor-core forward and backward: the general kernels'
        # interfaces
        "flash_fwd_mma": {
            "mx_flash_fwd_mma": [p] * 7 + [i] * 6 + [d, i, i, p]},
        "flash_bwd_mma": {
            "mx_flash_bwd_dq_mma": [p] * 11 + [i] * 6 + [d, i, i, p],
            "mx_flash_bwd_dkv_mma": [p] * 10 + [i] * 6 + [d, i, i, p]},
        # q k_pages v_pages page_table lengths out part_acc part_ml, S H
        # Hkv psz D MP nsplit kps
        "paged_general": {"mx_paged_decode_general": [p] * 8 + [i] * 8
                          + [d, i, p]},
        # kind, table, its bytes, scalars, their bytes, weight and grad
        # dtype codes, stream | the two sizes' out-pointers
        "multi_tensor": {"mx_multi_tensor": [i, p, i, p, i, i, i, p],
                         "mx_multi_tensor_sizes": [p, p]},
        # x q y, M N K, the scale rounded to the dtype, dtype code, stream
        # | q out, n, the scale rounded to the dtype, dtype code, stream
        "int8_linear": {"mx_int8_linear": [p, p, p, i, i, i, d, i, p],
                        "mx_int8_dequant": [p, p, ctypes.c_longlong, d, i,
                                            p]},
        # x q, x's dtype code, N C P G Cgp, scale, stream | the ConvArgs
        # struct, its bytes, stream | no arguments
        "int8_conv": {"mx_int8_quantize": [p, p, i, i, i, i, i, i, f, p],
                      "mx_int8_conv": [p, i, p],
                      "mx_int8_conv_args_size": []},
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
