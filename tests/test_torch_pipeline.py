"""The port's pipeline schedules against the JAX package's.

Four gloo ranks on the CPU run ``parallel.pipeline`` over ``pp=4`` once
for the whole module: this file is also their program (``python
tests/test_torch_pipeline.py --rank R --world 4 --dir D``; the rank part
runs before the JAX imports, so the ranks never import JAX).  The
parametrised tests hold each rank's results against the JAX package's
``pipeline_apply`` / ``pipeline_vjp`` on its 8 virtual CPU devices and
against the stages applied in sequence, with the same seeded numpy
weights and inputs, mirroring ``tests/test_parallel.py`` :223, :244,
:267, :299, :316 (there the stash buffer in the lowered program, here
the stage inputs a rank holds at once) and :385; ``schedule_info`` and
the slot tables equal the reference's for every schedule.
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
#: name -> (schedule, virtual stages, microbatches, batch, D, seed, vjp)
CASES = {
    "forward": ("gpipe", 1, 4, 8, 8, 3, False),
    "apply_gpipe": ("gpipe", 1, 4, 16, 8, 21, False),
    "apply_1f1b": ("1f1b", 1, 4, 16, 8, 21, False),
    "apply_interleaved": ("interleaved", 2, 4, 16, 8, 21, False),
    "vjp_gpipe": ("gpipe", 1, 8, 16, 8, 22, True),
    "vjp_1f1b": ("1f1b", 1, 8, 16, 8, 22, True),
    "vjp_interleaved": ("interleaved", 2, 8, 16, 8, 22, True),
}


def inputs(name):
    """(ws, x, gy) of a case: float32, the stage weights (n*v, D, D)."""
    sched, v, M, B, D, seed, _ = CASES[name]
    rs = onp.random.RandomState(seed)
    x = rs.normal(0, 1, (B, D)).astype("float32")
    gy = rs.normal(0, 1, (B, D)).astype("float32")
    ws = rs.normal(0, 0.5, (WORLD * v, D, D)).astype("float32")
    return ws, x, gy


def _stage(w, a):
    return torch.relu(a @ w)


def _rank_main(rank, world, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import pipeline
    res = {}
    with mt.cpu():
        mesh = parallel.create_mesh(pp=world)
        for name, (sched, v, M, _, _, _, vjp) in CASES.items():
            ws, x, gy = (torch.from_numpy(a) for a in inputs(name))
            if vjp:
                y, dx, dws = parallel.pipeline_vjp(
                    _stage, ws, x, gy, mesh, M, schedule=sched,
                    virtual_stages=v)
                res[name + "/dx"] = dx.numpy()
                res[name + "/dws"] = dws.numpy()
                # a dict of stage parameters takes the same path
                _, _, tree = parallel.pipeline_vjp(
                    lambda p, a: _stage(p["w"], a), {"w": ws}, x, gy, mesh,
                    M, schedule=sched, virtual_stages=v)
                res[name + "/dws_tree"] = tree["w"].numpy()
            else:
                y = parallel.pipeline_apply(_stage, ws, x, mesh, M,
                                            schedule=sched,
                                            virtual_stages=v)
            res[name + "/y"] = y.numpy()
            res[name + "/max_live_stash"] = onp.int64(
                pipeline.LAST["max_live_stash"])
        # gpipe_forward on this rank's own block: the output replicated
        ws, x, _ = inputs("forward")
        xm = torch.from_numpy(x).reshape(4, 2, 8)
        with parallel.mesh_scope(mesh):
            out = pipeline.gpipe_forward(
                _stage, torch.from_numpy(ws[rank:rank + 1]), xm)
        res["gpipe_forward"] = out.numpy()
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
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.parallel import pipeline as jpipe  # noqa: E402
from mxnet_tpu_torch.parallel import pipeline as tpipe  # noqa: E402


def _spawn(out_dir, timeout=240):
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


def sequential(name):
    """y, dx, dws of the stages applied in sequence (float64)."""
    ws, x, gy = (torch.from_numpy(a).double() for a in inputs(name))
    ws.requires_grad_()
    x.requires_grad_()
    h = x
    for i in range(ws.shape[0]):
        h = torch.relu(h @ ws[i])
    dws, dx = torch.autograd.grad(h, (ws, x), gy)
    return h.detach().numpy(), dx.numpy(), dws.numpy()


_JAX = {}


def jax_pipeline(name):
    if name not in _JAX:
        sched, v, M, _, _, _, vjp = CASES[name]
        ws, x, gy = (jnp.asarray(a) for a in inputs(name))
        mesh = jpar.create_mesh(pp=WORLD)

        def stage(w, a):
            return jax.nn.relu(a @ w)
        if vjp:
            out = jpar.pipeline_vjp(stage, ws, x, gy, mesh,
                                    num_microbatches=M, schedule=sched,
                                    virtual_stages=v)
        else:
            out = (jpar.pipeline_apply(stage, ws, x, mesh,
                                       num_microbatches=M, schedule=sched,
                                       virtual_stages=v),)
        _JAX[name] = [onp.asarray(o) for o in out]
    return _JAX[name]


def test_rank_children_import_no_jax(ranks):
    assert [bool(r["imported_jax"]) for r in ranks] == [False] * WORLD


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_output_is_replicated(ranks, name):
    """:385: every rank holds the last stage's outputs."""
    for r in ranks[1:]:
        onp.testing.assert_array_equal(r[name + "/y"], ranks[0][name + "/y"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_matches_sequential_stages(ranks, name):
    """:223, :244, :267: outputs (and for the vjp the input and
    parameter gradients) equal the stages in sequence."""
    y, dx, dws = sequential(name)
    for r in ranks:
        onp.testing.assert_allclose(r[name + "/y"], y, rtol=1e-5, atol=1e-5)
        if CASES[name][6]:
            for key, want in (("dx", dx), ("dws", dws), ("dws_tree", dws)):
                onp.testing.assert_allclose(r["%s/%s" % (name, key)], want,
                                            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_matches_jax(ranks, name):
    got = ranks[0]
    keys = ("y", "dx", "dws") if CASES[name][6] else ("y",)
    for key, want in zip(keys, jax_pipeline(name)):
        onp.testing.assert_allclose(got["%s/%s" % (name, key)], want,
                                    rtol=1e-4, atol=1e-5)


def test_gpipe_forward_replicates_on_every_rank(ranks):
    """:385: ``gpipe_forward`` on each rank's own block (as under the
    reference's shard_map with out_specs P('pp')): every rank's copy is
    the sequential result."""
    y, _, _ = sequential("forward")
    for r in ranks:
        onp.testing.assert_allclose(r["gpipe_forward"].reshape(8, 8), y,
                                    rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,most", [("vjp_gpipe", 8), ("vjp_1f1b", 4),
                                       ("apply_gpipe", 1)])
def test_1f1b_stashes_fewer_stage_inputs(ranks, name, most):
    """:316: the backward recomputes from stashed stage inputs; under
    1F1B a rank holds at most n (stage 0: n - 0) of them at once, under
    GPipe all M, and the forward-only loop one."""
    assert max(int(r[name + "/max_live_stash"]) for r in ranks) == most
    if name == "vjp_1f1b":
        assert [int(r[name + "/max_live_stash"]) for r in ranks] == \
            [WORLD - s for s in range(WORLD)]


SIM = [(s, n, M, v, b) for s in ("gpipe", "1f1b") for n in (2, 4, 8)
       for M in (4, 8, 16) for v in (1,) for b in (True, False)] + \
    [("interleaved", n, M, v, b) for n in (2, 4) for M in (4, 8, 16)
     for v in (1, 2, 3) for b in (True, False)]


@pytest.mark.parametrize("sched,n,M,v,bwd", SIM)
def test_schedule_tables_equal_the_reference(sched, n, M, v, bwd):
    """``schedule_info`` and every slot table of ``_simulate`` equal the
    JAX package's."""
    assert tpipe.schedule_info(sched, n, M, v, bwd) == \
        jpipe.schedule_info(sched, n, M, v, bwd)
    assert tpipe._simulate(sched, n, M, v, bwd) == \
        jpipe._simulate(sched, n, M, v, bwd)


def test_schedule_info_pins_the_claims():
    """:299."""
    n, M = 4, 8
    gp = tpipe.schedule_info("gpipe", n, M)
    fb = tpipe.schedule_info("1f1b", n, M)
    il = tpipe.schedule_info("interleaved", n, M, virtual_stages=2)
    assert gp["act_buf"] == M and gp["max_inflight"] == M
    assert fb["act_buf"] == n and fb["max_inflight"] == n
    assert fb["slots"] == gp["slots"] == 2 * (M + n - 1)
    assert abs(fb["bubble_fraction"] - gp["bubble_fraction"]) < 1e-9
    assert il["bubble_fraction"] < fb["bubble_fraction"]


def test_pipeline_validates_like_jax():
    from mxnet_tpu_torch import parallel
    mesh = parallel.create_mesh(pp=1, device="cpu")
    ws = torch.zeros(1, 2, 2)
    x = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="unknown schedule"):
        parallel.pipeline_apply(_stage, ws, x, mesh, 2, schedule="zigzag")
    with pytest.raises(ValueError, match="requires"):
        parallel.pipeline_apply(_stage, torch.zeros(2, 2, 2), x, mesh, 2,
                                virtual_stages=2)
    with pytest.raises(ValueError, match="stage stack has 2 stages"):
        parallel.pipeline_apply(_stage, torch.zeros(2, 2, 2), x, mesh, 2)
    # the fault seams are ported: a vote over a one-rank comm, and a
    # mid-op failure of a mutating call aborts instead of re-running
    from mxnet_tpu_torch import fault, fault_dist
    comm = fault_dist.InProcessComm.create(1)[0]
    y0 = parallel.pipeline_vjp(_stage, ws, x, x, mesh, 2, _comm=comm,
                               _gen=fault_dist.Generation())[0]
    assert torch.equal(y0, torch.zeros(4, 2))
    calls = []

    def flaky(w, h):
        calls.append(1)
        if len(calls) == 1:
            raise fault.TransientError("mid-op")
        return _stage(w, h)
    with pytest.raises(fault_dist.CoordinatedAbortError):
        parallel.pipeline_apply(flaky, ws, x, mesh, 2, mutating=True,
                                _comm=comm, _gen=fault_dist.Generation())
    calls.clear()
    gen = fault_dist.Generation()
    assert torch.equal(parallel.pipeline_apply(
        flaky, ws, x, mesh, 2, _comm=comm, _gen=gen), _stage(ws[0], x))
    # voted, re-issued once: the failed call, then 2 microbatches
    assert gen.value == 1 and len(calls) == 3
    # one rank: the stages run in order, no exchange
    w = torch.eye(2).reshape(1, 2, 2) * 2
    y, dx, dw = parallel.pipeline_vjp(_stage, w, torch.ones(4, 2),
                                      torch.ones(4, 2), mesh, 2)
    assert torch.equal(y, torch.full((4, 2), 2.0))
    assert torch.equal(dx, torch.full((4, 2), 2.0))
