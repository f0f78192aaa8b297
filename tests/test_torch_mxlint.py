"""The port's lint (``mxnet_tpu_torch.analysis.lint``): every rule fires.

Per rule R1-R8 and MX901: a known-violation snippet and a clean twin,
linted under a virtual path of the port so scoping is exercised too.
R1, R5 and R7 are re-aimed at PyTorch (``torch.distributed`` and the
port's ``_compat`` wrappers; CUDA-graph capture); on the rules whose
sources do not depend on the framework (R2, R3, R4, R6, R8) the port's
lint gives the JAX package's diagnostics for the same sources.  Plus
the self-scan: the port's tree is clean against ``lint_baseline.txt``
and no entry is stale.
"""
import os
import subprocess
import sys

import pytest

from mxnet_tpu.analysis import lint as ref_lint
from mxnet_tpu_torch.analysis import lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "mxnet_tpu_torch", "analysis",
                        "lint_baseline.txt")


def _ids(src, relpath, rule=None):
    return [d.rule_id for d in lint.lint_source(
        src, relpath, rules={rule} if rule else None)]


# ----------------------------------------------------------------------
# R1: collectives launch through coordinated_call / retry_call
# ----------------------------------------------------------------------
R1_BAD = """
import torch.distributed as dist

def body(x):
    dist.all_reduce(x)
    return x

def apply_batch(x):
    return body(x)
"""

R1_CLEAN = """
import torch.distributed as dist

def body(x):
    dist.all_reduce(x)
    return x

def apply_batch(x):
    def attempt():
        return body(x)
    return coordinated_call(attempt, op="apply_batch")
"""

R1_BAD_COMPAT = """
from . import _compat
from ._compat import psum_grad

def layer(x, mesh):
    y = psum_grad(x, "tp", mesh)
    return _compat.psum(y, "tp", mesh)
"""

R1_CLEAN_FUNCTION = """
import torch
from ._compat import ppermute_start

class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return ppermute_start(x, "cp", mesh).wait()

def ring(x, mesh):
    def attempt():
        return _Ring.apply(x, mesh)
    return retry_call(attempt, op="ring")
"""

R1_CLEAN_DECORATED = """
from torch import distributed as dist

def _retrying(op):
    def deco(fn):
        def run(*a):
            return retry_call(lambda: fn(*a), op=op)
        return run
    return deco

class Store:
    @_retrying("pull")
    def pull(self, x):
        dist.broadcast(x, 0)
"""


def test_r1_fires_on_unseamed_launch():
    assert _ids(R1_BAD, "mxnet_tpu_torch/parallel/fx.py") == ["R1"]
    assert _ids(R1_BAD_COMPAT, "mxnet_tpu_torch/kvstore/fx.py") == \
        ["R1", "R1"]


def test_r1_clean_when_launch_rides_the_seam():
    assert _ids(R1_CLEAN, "mxnet_tpu_torch/parallel/fx.py") == []
    assert _ids(R1_CLEAN_FUNCTION, "mxnet_tpu_torch/parallel/fx.py") == []
    assert _ids(R1_CLEAN_DECORATED, "mxnet_tpu_torch/kvstore/fx.py") == []


def test_r1_scoped_to_distributed_modules():
    assert _ids(R1_BAD, "mxnet_tpu_torch/gluon/fx.py") == []
    # _compat.py defines the wrappers: it is the collective layer
    assert _ids(R1_BAD, "mxnet_tpu_torch/parallel/_compat.py") == []


# ----------------------------------------------------------------------
# R2: atomic artifact writes
# ----------------------------------------------------------------------
R2_BAD = """
import json

def dump_report(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
"""

R2_CLEAN = """
import json, os

def dump_report(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)
"""

R2_SUPPRESSED = """
def journal(path, line):
    # mxlint: disable=R2 -- append-only journal; lines self-contained
    with open(path, "a") as f:
        f.write(line)
"""

R2_BARE_SUPPRESS = """
def journal(path, line):
    # mxlint: disable=R2
    with open(path, "a") as f:
        f.write(line)
"""

R2_BAD_FAKE_LINK = """
def dump(path, obj, photos):
    photos.link(obj)
    link(path, obj)
    with open(path, "w") as f:
        f.write(obj)
"""

R2_CLEAN_OS_LINK = """
import json, os

def claim(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.link(tmp, path)
"""


def test_r2_fires_on_raw_write():
    assert _ids(R2_BAD, "mxnet_tpu_torch/fx.py") == ["R2"]
    assert _ids(R2_BAD, "chip_smoke.py") == ["R2"]
    assert _ids(R2_BAD_FAKE_LINK, "mxnet_tpu_torch/fx.py") == ["R2"]


def test_r2_clean_with_replace_commit_point():
    assert _ids(R2_CLEAN, "mxnet_tpu_torch/fx.py") == []
    assert _ids(R2_CLEAN_OS_LINK, "mxnet_tpu_torch/fx.py") == []
    assert _ids(R2_BAD, "mxnet_tpu_torch/utils/serialization.py") == []


def test_mx901_suppression_needs_justification():
    assert _ids(R2_SUPPRESSED, "mxnet_tpu_torch/fx.py") == []
    assert _ids(R2_BARE_SUPPRESS, "mxnet_tpu_torch/fx.py") == ["MX901"]


# ----------------------------------------------------------------------
# R3: entry-seam-only retry for mutating ops
# ----------------------------------------------------------------------
R3_BAD = """
def guarded_push(fn, mutating=False):
    return retry_call(fn, op="push", policy=mutating_policy())
"""

R3_BAD_TIMEOUT = """
def guarded(fn):
    return retry_call(fn, op="allreduce",
                      policy=RetryPolicy(timeout=5.0))
"""

R3_CLEAN = """
def guarded_push(fn, mutating=False):
    return retry_call(fn, op="push", policy=entry_only_policy())
"""


def test_r3_fires_on_mutating_retry_without_entry_policy():
    assert _ids(R3_BAD, "mxnet_tpu_torch/kvstore/fx.py") == ["R3"]
    assert _ids(R3_BAD_TIMEOUT, "mxnet_tpu_torch/kvstore/fx.py") == ["R3"]


def test_r3_clean_with_entry_only_policy():
    assert _ids(R3_CLEAN, "mxnet_tpu_torch/kvstore/fx.py") == []
    assert _ids(R3_BAD, "mxnet_tpu_torch/fault.py") == []


# ----------------------------------------------------------------------
# R4: no swallowed coordination aborts
# ----------------------------------------------------------------------
R4_BAD = """
def poll(fn, log):
    try:
        fn()
    except Exception:
        log("oops")
"""

R4_CLEAN = """
def poll(fn, log):
    try:
        fn()
    except Exception:
        log("oops")
        raise
"""


def test_r4_fires_on_swallowing_broad_except():
    assert _ids(R4_BAD, "mxnet_tpu_torch/kvstore/fx.py") == ["R4"]
    assert _ids(R4_BAD, "mxnet_tpu_torch/fault_dist.py") == ["R4"]


def test_r4_clean_when_reraising():
    assert _ids(R4_CLEAN, "mxnet_tpu_torch/kvstore/fx.py") == []
    assert _ids(R4_BAD, "mxnet_tpu_torch/gluon/fx.py") == []


# ----------------------------------------------------------------------
# R5: no host sync in CUDA-graph-captured code
# ----------------------------------------------------------------------
R5_BAD = """
from .ops.cuda_ops import capture_graph

def step(buf):
    n = buf[0].item()
    print("stepping")
    return buf * n

def build(buf):
    return capture_graph(lambda: step(buf))
"""

R5_BAD_PROGRAM = """
import time
from .ops import cuda_ops

class _Program:
    def __init__(self, fn):
        self.graph = cuda_ops.capture_graph(fn)

class Pool:
    def __init__(self, buf):
        self.buf = buf
        self.decode = _Program(self._step)

    def _helper(self, x):
        return x.cpu(), time.monotonic()

    def _step(self):
        return self._helper(self.buf)
"""

R5_BAD_GRAPH_BLOCK = """
import numpy as onp
import torch

def capture(g, x):
    with torch.cuda.graph(g):
        y = x * onp.random.rand()
        torch.cuda.synchronize()
    return y
"""

R5_CLEAN = """
import functools
import numpy as onp
from .ops.cuda_ops import capture_graph

def step(buf, scale):
    return buf * scale

def build(buf):
    scale = float(onp.float32(2.0))
    return capture_graph(functools.partial(step, buf, scale))

def log_loss(loss):
    return loss.item()
"""


def test_r5_fires_on_host_sync_in_captured_code():
    assert _ids(R5_BAD, "mxnet_tpu_torch/serve.py") == ["R5", "R5"]
    # reached through a class that hands its parameter to the capture,
    # then a self-method
    assert _ids(R5_BAD_PROGRAM, "mxnet_tpu_torch/serve.py") == \
        ["R5", "R5"]
    assert _ids(R5_BAD_GRAPH_BLOCK, "mxnet_tpu_torch/ops/fx.py") == \
        ["R5", "R5"]


def test_r5_clean_on_pure_captured_step():
    assert _ids(R5_CLEAN, "mxnet_tpu_torch/serve.py") == []
    # the same host sync outside any captured function is host code
    assert _ids("def log_loss(loss):\n    return loss.item()\n",
                "mxnet_tpu_torch/serve.py") == []


# ----------------------------------------------------------------------
# R6: deterministic tests
# ----------------------------------------------------------------------
R6_BAD_TIME = """
import time

def test_fresh():
    assert time.time() > 0
"""

R6_BAD_MODULE_DRAW = """
import numpy as onp

X = onp.random.rand(3)
"""

R6_BAD_UNSEEDED_RS = """
import numpy as onp

def test_x():
    rs = onp.random.RandomState()
"""

R6_BAD_FROM_TIME = """
from time import time

def test_x():
    assert time() > 0
"""

R6_CLEAN = """
import numpy as onp

_rs = onp.random.RandomState(7)

def test_x():
    assert _rs.rand(3).shape == (3,)
"""

R6_CONFTEST_BAD = """
import numpy as onp

def seed_fixture():
    seed = onp.random.randint(0, 2 ** 31)
    onp.random.seed(seed)
"""

R6_CONFTEST_CLEAN = """
import numpy as onp

def seed_fixture(seed):
    onp.random.seed(seed)
    return onp.random.randint(0, 2 ** 31)
"""


def test_r6_fires_on_nondeterminism():
    for src in (R6_BAD_TIME, R6_BAD_MODULE_DRAW, R6_BAD_UNSEEDED_RS,
                R6_BAD_FROM_TIME):
        assert _ids(src, "tests/test_torch_fx.py") == ["R6"]
    assert _ids(R6_CONFTEST_BAD, "tests/conftest.py") == ["R6"]


def test_r6_clean_and_scoped_to_the_port_tests():
    assert _ids(R6_CLEAN, "tests/test_torch_fx.py") == []
    assert _ids(R6_CONFTEST_CLEAN, "tests/conftest.py") == []
    # the JAX package's tests are not the port's lint's business
    assert _ids(R6_BAD_TIME, "tests/test_fx.py") == []


# ----------------------------------------------------------------------
# R7: rank-divergent control flow guarding a collective launch
# ----------------------------------------------------------------------
R7_BAD = """
import torch.distributed as dist

def step(x, rank):
    if rank == 0:
        dist.all_reduce(x)
    return x
"""

R7_BAD_GET_RANK = """
import torch.distributed as dist

def maybe_sync(comm, x):
    if dist.get_rank() == 0:
        comm.allgather(x)
"""

R7_CLEAN_HOIST = """
import torch.distributed as dist

def step(x, rank):
    dist.all_reduce(x)
    if rank == 0:
        log(x)
    return x
"""

R7_CLEAN_BOTH_ARMS = """
from ._compat import psum

def step(x, rank, mesh):
    if rank == 0:
        return psum(x, "dp", mesh)
    else:
        return psum(-x, "dp", mesh)
"""


def test_r7_fires_on_rank_guarded_collective():
    assert _ids(R7_BAD, "mxnet_tpu_torch/parallel/fx.py", "R7") == ["R7"]
    assert _ids(R7_BAD_GET_RANK, "mxnet_tpu_torch/fault_dist.py") == ["R7"]


def test_r7_clean_when_collective_hoisted_or_symmetric():
    assert _ids(R7_CLEAN_HOIST, "mxnet_tpu_torch/parallel/fx.py",
                "R7") == []
    assert _ids(R7_CLEAN_BOTH_ARMS, "mxnet_tpu_torch/parallel/fx.py",
                "R7") == []
    assert _ids(R7_BAD, "mxnet_tpu_torch/gluon/fx.py") == []


# ----------------------------------------------------------------------
# R8: comm/board namespace discipline
# ----------------------------------------------------------------------
R8_BAD_NAKED = """
def build(root, rank, world):
    votes = FileComm(root, rank, world)
    beats = FileComm(root, rank, world)
    return votes, beats
"""

R8_BAD_DUP = """
def build(root, rank, world):
    votes = FileComm(root, rank, world, namespace="x")
    beats = FileComm(root, rank, world, namespace="x")
    return votes, beats
"""

R8_BAD_SERVICE = """
def build():
    return CoordServiceComm(), CoordServiceComm()
"""

R8_BAD_BOARDS = """
def build(root):
    return FileBoard(root), FileBoard(root)
"""

R8_CLEAN = """
def build(root, rank, world, epoch):
    votes = FileComm(root, rank, world, namespace="votes")
    beats = FileComm(root, rank, world, namespace="hb%d" % epoch)
    other = FileComm(root + "/other", rank, world)
    return votes, beats, other
"""


def test_r8_fires_on_shared_namespaces():
    for src in (R8_BAD_NAKED, R8_BAD_DUP, R8_BAD_SERVICE, R8_BAD_BOARDS):
        assert _ids(src, "mxnet_tpu_torch/fault_elastic.py") == ["R8"]


def test_r8_clean_with_distinct_namespaces_or_roots():
    assert _ids(R8_CLEAN, "mxnet_tpu_torch/fault_elastic.py") == []
    assert _ids(R8_BAD_NAKED, "mxnet_tpu_torch/analysis/fx.py") == []


# ----------------------------------------------------------------------
# parity with the JAX package on the framework-free rules
# ----------------------------------------------------------------------
#: (fixture, the JAX package's path, the port's path)
PARITY = {
    "R2_BAD": (R2_BAD, "examples/fx.py", "mxnet_tpu_torch/fx.py"),
    "R2_CLEAN": (R2_CLEAN, "examples/fx.py", "mxnet_tpu_torch/fx.py"),
    "R2_SUPPRESSED": (R2_SUPPRESSED, "examples/fx.py",
                      "mxnet_tpu_torch/fx.py"),
    "R2_BARE_SUPPRESS": (R2_BARE_SUPPRESS, "examples/fx.py",
                         "mxnet_tpu_torch/fx.py"),
    "R2_BAD_FAKE_LINK": (R2_BAD_FAKE_LINK, "examples/fx.py",
                         "mxnet_tpu_torch/fx.py"),
    "R2_CLEAN_OS_LINK": (R2_CLEAN_OS_LINK, "examples/fx.py",
                         "mxnet_tpu_torch/fx.py"),
    "R3_BAD": (R3_BAD, "mxnet_tpu/kvstore/fx.py",
               "mxnet_tpu_torch/kvstore/fx.py"),
    "R3_BAD_TIMEOUT": (R3_BAD_TIMEOUT, "mxnet_tpu/kvstore/fx.py",
                       "mxnet_tpu_torch/kvstore/fx.py"),
    "R3_CLEAN": (R3_CLEAN, "mxnet_tpu/kvstore/fx.py",
                 "mxnet_tpu_torch/kvstore/fx.py"),
    "R4_BAD": (R4_BAD, "mxnet_tpu/kvstore/fx.py",
               "mxnet_tpu_torch/kvstore/fx.py"),
    "R4_CLEAN": (R4_CLEAN, "mxnet_tpu/kvstore/fx.py",
                 "mxnet_tpu_torch/kvstore/fx.py"),
    "R6_BAD_TIME": (R6_BAD_TIME, "tests/fx_test.py",
                    "tests/test_torch_fx.py"),
    "R6_BAD_MODULE_DRAW": (R6_BAD_MODULE_DRAW, "tests/fx_test.py",
                           "tests/test_torch_fx.py"),
    "R6_BAD_UNSEEDED_RS": (R6_BAD_UNSEEDED_RS, "tests/fx_test.py",
                           "tests/test_torch_fx.py"),
    "R6_BAD_FROM_TIME": (R6_BAD_FROM_TIME, "tests/fx_test.py",
                         "tests/test_torch_fx.py"),
    "R6_CLEAN": (R6_CLEAN, "tests/fx_test.py", "tests/test_torch_fx.py"),
    "R6_CONFTEST_BAD": (R6_CONFTEST_BAD, "tests/conftest.py",
                        "tests/conftest.py"),
    "R6_CONFTEST_CLEAN": (R6_CONFTEST_CLEAN, "tests/conftest.py",
                          "tests/conftest.py"),
    "R8_BAD_NAKED": (R8_BAD_NAKED, "mxnet_tpu/parallel/fx.py",
                     "mxnet_tpu_torch/parallel/fx.py"),
    "R8_BAD_DUP": (R8_BAD_DUP, "mxnet_tpu/parallel/fx.py",
                   "mxnet_tpu_torch/parallel/fx.py"),
    "R8_BAD_SERVICE": (R8_BAD_SERVICE, "mxnet_tpu/parallel/fx.py",
                       "mxnet_tpu_torch/parallel/fx.py"),
    "R8_BAD_BOARDS": (R8_BAD_BOARDS, "examples/fx.py",
                      "mxnet_tpu_torch/fx.py"),
    "R8_CLEAN": (R8_CLEAN, "mxnet_tpu/parallel/fx.py",
                 "mxnet_tpu_torch/parallel/fx.py"),
}
_SHARED = {"R2", "R3", "R4", "R6", "R8", "MX901"}


@pytest.mark.parametrize("name", sorted(PARITY))
def test_framework_free_rules_match_jax(name):
    src, ref_path, path = PARITY[name]
    rules = _SHARED - {"MX901"}
    want = [(d.rule_id, d.line) for d in
            ref_lint.lint_source(src, ref_path, rules=rules)]
    got = [(d.rule_id, d.line) for d in
           lint.lint_source(src, path, rules=rules)]
    assert got == want
    assert {r for r, _ in got} <= _SHARED


# ----------------------------------------------------------------------
# engine: baseline, self-scan, standalone load, CLI
# ----------------------------------------------------------------------
def test_baseline_loader_and_ratchet(tmp_path):
    p = tmp_path / "b.txt"
    p.write_text("R2 mxnet_tpu_torch/x.py 1\n")  # no justification
    with pytest.raises(ValueError):
        lint.load_baseline(str(p))
    p.write_text("# comment\n\nR2 mxnet_tpu_torch/x.py 2 -- journal\n")
    base = lint.load_baseline(str(p))
    assert base == {("R2", "mxnet_tpu_torch/x.py"): (2, "journal")}
    diags = [lint.Diagnostic("R2", "mxnet_tpu_torch/x.py", i, "m")
             for i in (1, 2, 3)]
    un, kept, stale = lint.apply_baseline(
        diags, {**base, ("R4", "gone.py"): (1, "stale")})
    assert [d.line for d in un] == [3] and len(kept) == 2
    assert stale == [(("R4", "gone.py"), 1, 0)]


def test_self_scan_port_clean_modulo_baseline():
    """The gate: the port's tree carries no diagnostic beyond
    ``lint_baseline.txt``, no entry is stale, and every entry has its
    reason."""
    diags = lint.lint_paths(ROOT)
    baseline = lint.load_baseline(BASELINE)
    un, kept, stale = lint.apply_baseline(diags, baseline)
    assert not un, "\n".join(d.format() for d in un)
    assert not stale, stale
    assert kept and all(why for _, why in baseline.values())
    assert {d.path for d in diags} <= {p for _, p in baseline}
    scanned = {d.path for d in lint.lint_paths(ROOT, ("tests",))}
    assert all(os.path.basename(p).startswith("test_torch_")
               for p in scanned)


def test_every_rule_is_live():
    assert set(lint.RULES) == {"R1", "R2", "R3", "R4", "R5", "R6",
                               "R7", "R8"}
    for r in lint.RULES.values():
        assert r.invariant and r.scope
        assert all(s.startswith(("mxnet_tpu_torch/", "chip_smoke.py",
                                 "tests/")) for s in r.scope)


def test_lint_and_race_load_by_path_without_torch():
    code = (
        "import importlib.util, os, sys\n"
        "d = os.path.join(%r, 'mxnet_tpu_torch', 'analysis')\n"
        "for n in ('lint', 'race'):\n"
        "    s = importlib.util.spec_from_file_location(\n"
        "        'x_' + n, os.path.join(d, n + '.py'))\n"
        "    m = importlib.util.module_from_spec(s)\n"
        "    s.loader.exec_module(m)\n"
        "assert m.scan_paths(%r, ('mxnet_tpu_torch/flightrec.py',)) "
        "== []\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('torch', 'jax', 'numpy', 'mxnet_tpu', 'mxnet_tpu_torch')]\n"
        "assert not bad, bad\n" % (ROOT, ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_hlo_is_not_ported():
    import mxnet_tpu_torch.analysis as an
    with pytest.raises(NotImplementedError, match="XLA HLO"):
        an.hlo  # noqa: B018


@pytest.mark.integration
def test_lint_cli(tmp_path):
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.analysis", "lint"]
    r = subprocess.run(cmd + ["--smoke"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    r = subprocess.run(cmd + ["--rules", "R99"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "unknown rule" in r.stderr
    stale = tmp_path / "stale.txt"
    stale.write_text("R2 mxnet_tpu_torch/gone.py 3 -- long since fixed\n")
    r = subprocess.run(cmd + ["--baseline", str(stale),
                              "mxnet_tpu_torch/analysis"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "long since fixed" in r.stdout
    r = subprocess.run(cmd + ["--no-baseline", "--format", "github",
                              "--rules", "R4", "mxnet_tpu_torch/fault.py"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1 and "title=lint R4" in r.stdout
