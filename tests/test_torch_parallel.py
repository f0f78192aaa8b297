"""The port's context and expert parallelism against the JAX package's.

Four gloo ranks on the CPU run the port's ``parallel`` layer once for the
whole module: this file is also their program (``python
tests/test_torch_parallel.py --rank R --world 4 --dir D``; the rank part
runs before the JAX imports below, so the ranks never import JAX).  They
meet through a ``FileStore`` in a temporary directory (no port, so
parallel test workers cannot collide), build the meshes ``cp=4``,
``(dcn=2, cp=2)``, ``(dp=2, cp=2)`` and ``ep=4``, and write every result
to one npz each.  The parametrised tests below then hold each result
against the JAX package on its 8 virtual CPU devices, with the same
seeded numpy inputs:

* ``ring_attention_sharded`` (flat, two-level, striped and round-robin,
  causal and not, GQA, the legacy ring, a batch axis, pre-striped
  inputs), output and the gradients of its sum, against JAX's
  ``ring_attention_sharded`` and dense attention (float64) at 2e-4 /
  5e-4 (the reference tests' own limits, ``tests/test_parallel.py``);
* ``seq_data``: each rank reads only its shard, and the ring on those
  shards equals dense attention;
* ``switch_moe`` with experts over ``ep=4`` against JAX's ep mesh and,
  for the gradients, the unsharded call;
* the ring and MoE-ep halves of ``dryrun_multichip``
  (``__graft_entry__.py:162-204``) at its shapes.
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
FWD_TOL, GRAD_TOL = 2e-4, 5e-4

#: meshes the ranks build: name -> axis sizes
MESHES = {"cp": {"cp": 4}, "dcn_cp": {"dcn": 2, "cp": 2},
          "dp_cp": {"dp": 2, "cp": 2}, "ep": {"ep": 4}}

#: ring cases: mesh, axis, (B, H, Hkv, T, D), causal, layout,
#: double_buffer, seed, batch_axis, permute_inputs -- the shapes and
#: seeds of tests/test_parallel.py's ring tests
RING = {
    "dense_causal": ("cp", "cp", (2, 4, 4, 64, 16), True, None, True, 1,
                     None, None),
    "dense_noncausal": ("cp", "cp", (2, 4, 4, 64, 16), False, None, True, 1,
                        None, None),
    "grads": ("cp", "cp", (1, 2, 2, 32, 8), True, None, True, 2, None, None),
    "db_causal": ("cp", "cp", (2, 2, 2, 64, 16), True, None, True, 11, None,
                  None),
    "db_noncausal": ("cp", "cp", (2, 2, 2, 64, 16), False, None, True, 11,
                     None, None),
    "legacy_causal": ("cp", "cp", (2, 2, 2, 64, 16), True, None, False, 11,
                      None, None),
    "legacy_noncausal": ("cp", "cp", (2, 2, 2, 64, 16), False, None, False,
                         11, None, None),
    "gqa_grads": ("cp", "cp", (1, 4, 2, 32, 8), True, None, True, 12, None,
                  None),
    "gqa_dense": ("cp", "cp", (1, 4, 2, 64, 16), True, None, True, 0, None,
                  None),
    "striped_causal": ("cp", "cp", (1, 2, 2, 64, 8), True, "striped", True,
                       41, None, None),
    "roundrobin_causal": ("cp", "cp", (1, 2, 2, 64, 8), True, "roundrobin",
                          True, 41, None, None),
    "striped_noncausal": ("cp", "cp", (1, 2, 2, 64, 8), False, "striped",
                          True, 41, None, None),
    "striped_gqa_grads": ("cp", "cp", (1, 4, 2, 32, 8), True, "striped",
                          True, 42, None, None),
    "ring2_causal_striped": ("dcn_cp", ("dcn", "cp"), (1, 2, 2, 64, 8), True,
                             "striped", True, 43, None, None),
    "ring2_causal_roundrobin": ("dcn_cp", ("dcn", "cp"), (1, 2, 2, 64, 8),
                                True, "roundrobin", True, 43, None, None),
    "ring2_noncausal": ("dcn_cp", ("dcn", "cp"), (1, 2, 2, 64, 8), False,
                        "roundrobin", True, 43, None, None),
    "flat_causal_striped": ("cp", "cp", (1, 2, 2, 64, 8), True, "striped",
                            True, 43, None, None),
    "flat_causal_roundrobin": ("cp", "cp", (1, 2, 2, 64, 8), True,
                               "roundrobin", True, 43, None, None),
    "flat_noncausal": ("cp", "cp", (1, 2, 2, 64, 8), False, "roundrobin",
                       True, 43, None, None),
    "prestriped": ("dcn_cp", ("dcn", "cp"), (1, 2, 2, 64, 8), True, "striped",
                   True, 44, None, False),
    "batch_axis": ("dp_cp", "cp", (2, 2, 2, 32, 8), True, "striped", True, 45,
                   "dp", None),
}
#: the cases the JAX ring runs too.  The rest are held against dense
#: attention and against a twin here: the flat twins of the two-level
#: ring, the legacy ring against the double-buffered one (JAX's
#: two-level and legacy rings take 9-13 s each to compile on the CPU)
JAX_RING = [c for c in RING if not c.startswith(("flat_", "legacy_")) and
            c not in ("prestriped", "ring2_causal_roundrobin")]

#: switch_moe cases over ep=4: (T, D, H, E, seed); E experts, E/4 a rank
MOE_EP = {"ep_e8": (32, 8, 16, 8, 2), "ep_e4": (16, 8, 12, 4, 7)}
SEQ_AXES = {"cp": ("cp", "cp"), "dcn_cp": ("dcn_cp", ("dcn", "cp"))}


def _stripe(x, n):
    T = x.shape[2]
    return x[:, :, onp.arange(T).reshape(T // n, n).T.reshape(-1)]


def _unstripe(x, n):
    T = x.shape[2]
    return x[:, :, onp.arange(T).reshape(n, T // n).T.reshape(-1)]


def ring_inputs(name):
    """The case's q, k, v (float32), striped when the case says the data
    arrive striped."""
    _, _, (B, H, Hkv, T, D), _, _, _, seed, _, permute = RING[name]
    rs = onp.random.RandomState(seed)
    q = rs.normal(0, 1, (B, H, T, D)).astype(onp.float32)
    k = rs.normal(0, 1, (B, Hkv, T, D)).astype(onp.float32)
    v = rs.normal(0, 1, (B, Hkv, T, D)).astype(onp.float32)
    if permute is False:
        q, k, v = (_stripe(a, WORLD) for a in (q, k, v))
    return q, k, v


def moe_inputs(T, D, H, E, seed):
    rs = onp.random.RandomState(seed)
    return (rs.normal(0, 1, (T, D)).astype(onp.float32),
            rs.normal(0, 0.5, (D, E)).astype(onp.float32),
            rs.normal(0, 0.5, (E, D, H)).astype(onp.float32),
            rs.normal(0, 0.5, (E, H, D)).astype(onp.float32))


def dryrun_inputs(n=WORLD):
    """``dryrun_multichip``'s draws (``__graft_entry__.py:163-190``) at
    ``n`` devices, the pipeline's included so the MoE's follow them."""
    onp.random.seed(0)
    q, k, v = (onp.random.normal(0, 1, (2, 4, 16 * n, 8)).astype(onp.float32)
               for _ in range(3))
    onp.random.normal(0, 0.5, (n, 8, 8))
    onp.random.normal(0, 1, (2 * n, 8))
    E, Tm, Dm, Hm = n, 4 * n, 8, 16
    gate_w = onp.random.normal(0, 0.2, (Dm, E)).astype(onp.float32)
    w1 = onp.random.normal(0, 0.2, (E, Dm, Hm)).astype(onp.float32)
    w2 = onp.random.normal(0, 0.2, (E, Hm, Dm)).astype(onp.float32)
    x = onp.random.normal(0, 1, (Tm, Dm)).astype(onp.float32)
    return (q, k, v), (x, gate_w, w1, w2)


def ep_shard(arrays, rank, world):
    """(x, gate, w1, w2) with rank ``rank``'s slice of the experts."""
    x, gate, w1, w2 = arrays
    n = w1.shape[0] // world
    return x, gate, w1[rank * n:(rank + 1) * n], w2[rank * n:(rank + 1) * n]


def seq_full(seed=45):
    rs = onp.random.RandomState(seed)
    return {w: rs.normal(0, 1, (1, 2, 64, 8)).astype(onp.float32)
            for w in "qkv"}


# ----------------------------------------------------------------------
# the ranks' program (no JAX)
# ----------------------------------------------------------------------
def _rank_main(rank, world, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world),
        rank=rank, world_size=world)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import _compat
    res = {}
    with mt.cpu():
        meshes = {k: parallel.create_mesh(v) for k, v in MESHES.items()}
        for name, (mesh, axis, _, causal, layout, db, _, batch_axis,
                   permute) in RING.items():
            q, k, v = (torch.from_numpy(a).requires_grad_()
                       for a in ring_inputs(name))
            o = parallel.ring_attention_sharded(
                q, k, v, meshes[mesh], axis_name=axis, causal=causal,
                layout=layout, double_buffer=db, batch_axis=batch_axis,
                permute_inputs=permute)
            grads = torch.autograd.grad(o.sum(), (q, k, v))
            for key, t in zip(("o", "dq", "dk", "dv"), (o,) + grads):
                res["%s/%s" % (name, key)] = t.detach().numpy()
        full = seq_full()
        for name, (mesh_name, axis) in SEQ_AXES.items():
            mesh = meshes[mesh_name]
            reads = []

            def reader(w):
                def f(idx):
                    reads.append(idx.copy())
                    return full[w][:, :, idx, :]
                return f
            q, k, v = (parallel.make_sequence_array(
                reader(w), (1, 2, 64, 8), mesh, axis_name=axis,
                layout="striped") for w in "qkv")
            o = parallel.ring_attention_local(q, k, v, axis, causal=True,
                                              layout="striped", mesh=mesh)
            res["seq_%s/local_q" % name] = q.numpy()
            res["seq_%s/o" % name] = _compat.all_gather(
                o, 2, axis, mesh).numpy()
            res["seq_%s/reads" % name] = onp.stack(reads)
            loader = parallel.SeqShardLoader(
                lambda step, idx: onp.random.RandomState(
                    (step, int(idx[0]))).normal(
                        0, 1, (1, 1, len(idx), 4)).astype("float32"),
                (1, 1, 32, 4), mesh, axis_name=axis, steps=3)
            shards = list(loader)
            res["seq_%s/loader" % name] = onp.stack([s.numpy()
                                                     for s in shards])
            res["seq_%s/reload" % name] = loader.load(1).numpy()
        for name, shape in MOE_EP.items():
            ts = [torch.from_numpy(a).requires_grad_()
                  for a in ep_shard(moe_inputs(*shape), rank, world)]
            out, aux = parallel.switch_moe(*ts, mesh=meshes["ep"])
            grads = torch.autograd.grad(out.sum() + aux, ts)
            res["%s/out" % name] = out.detach().numpy()
            res["%s/aux" % name] = aux.detach().numpy()
            for key, g in zip(("dx", "dgate", "dw1", "dw2"), grads):
                res["%s/%s" % (name, key)] = g.numpy()
        (q, k, v), moe = dryrun_inputs(world)
        ring = parallel.ring_attention_sharded(
            *(torch.from_numpy(a) for a in (q, k, v)), meshes["cp"],
            axis_name="cp", causal=True)
        res["dryrun/ring"] = ring.numpy()
        out, aux = parallel.switch_moe(
            *(torch.from_numpy(a) for a in ep_shard(moe, rank, world)),
            mesh=meshes["ep"])
        res["dryrun/moe_loss"] = (out.sum() + aux).numpy()
    res["transport_device_calls"] = onp.int64(_compat.TRANSPORT[
        "device_calls"])
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
from mxnet_tpu_torch import parallel as tpar  # noqa: E402


def _spawn(out_dir, timeout=300):
    """Run the four ranks; fail (and stop the others) if one fails."""
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
    """Every rank's results, from one run of the four ranks."""
    out_dir = tmp_path_factory.mktemp("ranks")
    _spawn(out_dir)
    return [dict(onp.load(out_dir / ("rank%d.npz" % r)))
            for r in range(WORLD)]


def _jax_mesh(name):
    return jpar.create_mesh(**MESHES[name])


_JAX_RING = {}


def jax_ring(name):
    """(o, (dq, dk, dv)) of JAX's ring_attention_sharded on the case."""
    if name not in _JAX_RING:
        mesh, axis, _, causal, layout, db, _, batch_axis, permute = \
            RING[name]
        jmesh = _jax_mesh(mesh)

        def loss(q, k, v):
            o = jpar.ring_attention_sharded(
                q, k, v, jmesh, axis_name=axis, causal=causal, layout=layout,
                double_buffer=db, batch_axis=batch_axis,
                permute_inputs=permute)
            return o.sum(), o
        (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                       has_aux=True)(
            *(jnp.asarray(a) for a in ring_inputs(name)))
        _JAX_RING[name] = (onp.asarray(o), [onp.asarray(x) for x in g])
    return _JAX_RING[name]


def dense(q, k, v, causal):
    """Dense attention over repeated KV heads in float64, and the
    gradients of its sum: the straightforward math, independent of both
    packages."""
    q, k, v = (torch.from_numpy(a).double().requires_grad_()
               for a in (q, k, v))
    rep = q.shape[1] // k.shape[1]
    kk, vv = (t.repeat_interleave(rep, 1) for t in (k, v))
    s = q @ kk.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        T = q.shape[2]
        s = s.masked_fill(torch.ones(T, T).triu(1).bool(), float("-inf"))
    o = torch.softmax(s, -1) @ vv
    grads = torch.autograd.grad(o.sum(), (q, k, v))
    return o.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want, tol):
    onp.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_rank_children_import_no_jax(ranks):
    assert [bool(r["imported_jax"]) for r in ranks] == [False] * WORLD
    # and they did talk: every rank ran collectives on its own tensors
    assert all(int(r["transport_device_calls"]) > 0 for r in ranks)


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_is_replicated_on_every_rank(ranks, name):
    for r in ranks[1:]:
        for key in ("o", "dq", "dk", "dv"):
            _close(r["%s/%s" % (name, key)], ranks[0]["%s/%s" % (name, key)],
                   1e-6)


@pytest.mark.parametrize("name", sorted(JAX_RING))
def test_ring_matches_jax_ring(ranks, name):
    o, grads = jax_ring(name)
    _close(ranks[0][name + "/o"], o, FWD_TOL)
    for key, g in zip(("dq", "dk", "dv"), grads):
        _close(ranks[0]["%s/%s" % (name, key)], g, GRAD_TOL)


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_matches_dense(ranks, name):
    causal, permute = RING[name][3], RING[name][8]
    q, k, v = ring_inputs(name)
    got = {key: ranks[0]["%s/%s" % (name, key)]
           for key in ("o", "dq", "dk", "dv")}
    if permute is False:          # striped in, striped out
        q, k, v = (_unstripe(a, WORLD) for a in (q, k, v))
        got = {key: _unstripe(a, WORLD) for key, a in got.items()}
    o, grads = dense(q, k, v, causal)
    _close(got["o"], o, FWD_TOL)
    for key, g in zip(("dq", "dk", "dv"), grads):
        _close(got[key], g, GRAD_TOL)


@pytest.mark.parametrize("variant", ["causal_striped", "causal_roundrobin",
                                     "noncausal"])
def test_ring2_matches_the_flat_ring(ranks, variant):
    """The two-level (2 x 2) ring visits every block once: only the order
    of the lse merges differs from the flat 4-ring."""
    for key in ("o", "dq", "dk", "dv"):
        _close(ranks[0]["ring2_%s/%s" % (variant, key)],
               ranks[0]["flat_%s/%s" % (variant, key)], 2e-5)


@pytest.mark.parametrize("causal", ["causal", "noncausal"])
def test_double_buffer_ring_matches_the_legacy_ring(ranks, causal):
    for key in ("o", "dq", "dk", "dv"):
        _close(ranks[0]["db_%s/%s" % (causal, key)],
               ranks[0]["legacy_%s/%s" % (causal, key)], 2e-5)


@pytest.mark.parametrize("name", sorted(SEQ_AXES))
def test_seq_data_ranks_read_only_their_shards(ranks, name):
    """``make_sequence_array``: each rank reads its stripe alone (never
    the whole sequence), holds the striped shard, and the ring on the
    shards equals dense attention on the natural order."""
    full = seq_full()
    perm = onp.asarray(jpar.ring.stripe_permutation(64, WORLD))
    for r, res in enumerate(ranks):
        # rank r is shard r of both meshes (outer-major); the JAX
        # package's own read plan names its tokens
        off, stride, count = jpar.seq_data.shard_token_indices(
            r, WORLD, 64, "striped")
        want = off + stride * onp.arange(count)
        reads = res["seq_%s/reads" % name]
        assert reads.shape == (3, 64 // WORLD)      # q, k, v: one read each
        for idx in reads:
            onp.testing.assert_array_equal(idx, want)
            onp.testing.assert_array_equal(idx, perm[r * count:
                                                     (r + 1) * count])
        onp.testing.assert_array_equal(res["seq_%s/local_q" % name],
                                       full["q"][:, :, want])
    o, _ = dense(full["q"], full["k"], full["v"], True)
    _close(_unstripe(ranks[0]["seq_%s/o" % name], WORLD), o, FWD_TOL)


@pytest.mark.parametrize("name", sorted(SEQ_AXES))
def test_seq_shard_loader_iterates_per_step_reads(ranks, name):
    for r, res in enumerate(ranks):
        shards = res["seq_%s/loader" % name]
        assert shards.shape == (3, 1, 1, 32 // WORLD, 4)
        start = r          # striped: this rank's first token
        for step in range(3):
            want = onp.random.RandomState((step, start)).normal(
                0, 1, (1, 1, 32 // WORLD, 4)).astype("float32")
            onp.testing.assert_array_equal(shards[step], want)
        onp.testing.assert_array_equal(res["seq_%s/reload" % name],
                                       shards[1])


def _top1_margins(x, gate_w):
    logits = x.astype(onp.float64) @ gate_w.astype(onp.float64)
    top = onp.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("name", sorted(MOE_EP))
def test_switch_moe_ep_matches_jax_ep_mesh(ranks, name):
    from jax.sharding import NamedSharding
    x, gate_w, w1, w2 = moe_inputs(*MOE_EP[name])
    # argmax routing is discontinuous: these inputs route unambiguously
    assert _top1_margins(x, gate_w).min() > 1e-4
    mesh = _jax_mesh("ep")
    spec = jpar.moe_param_specs()
    w1s = jax.device_put(jnp.asarray(w1), NamedSharding(mesh, spec["w1"]))
    w2s = jax.device_put(jnp.asarray(w2), NamedSharding(mesh, spec["w2"]))
    want, aux = jax.jit(lambda *a: jpar.switch_moe(*a, mesh=mesh))(
        jnp.asarray(x), jnp.asarray(gate_w), w1s, w2s)
    for res in ranks:
        _close(res[name + "/out"], onp.asarray(want), 1e-5)
        onp.testing.assert_allclose(res[name + "/aux"], float(aux),
                                    rtol=1e-5)


@pytest.mark.parametrize("name", sorted(MOE_EP))
def test_switch_moe_ep_grads_match_jax_unsharded(ranks, name):
    """The gradients of out.sum() + aux: x and the gate in full on every
    rank, each rank's experts' weights for its own experts."""
    T, D, H, E, _ = MOE_EP[name]
    arrays = [jnp.asarray(a) for a in moe_inputs(*MOE_EP[name])]

    def f(*a):
        out, aux = jpar.switch_moe(*a)
        return out.sum() + aux
    gx, ggate, gw1, gw2 = (onp.asarray(g) for g in
                           jax.grad(f, argnums=(0, 1, 2, 3))(*arrays))
    local = E // WORLD
    for r, res in enumerate(ranks):
        _close(res[name + "/dx"], gx, 1e-4)
        _close(res[name + "/dgate"], ggate, 1e-4)
        mine = slice(r * local, (r + 1) * local)
        _close(res[name + "/dw1"], gw1[mine], 1e-4)
        _close(res[name + "/dw2"], gw2[mine], 1e-4)


def test_dryrun_multichip_ring_and_moe_halves(ranks):
    """The torch counterpart of ``dryrun_multichip``'s context- and
    expert-parallel halves, at its shapes over 4 gloo ranks: finite, and
    equal to the JAX package's on its 4-device meshes."""
    (q, k, v), (x, gate_w, w1, w2) = dryrun_inputs()
    ring = jpar.ring_attention_sharded(
        *(jnp.asarray(a) for a in (q, k, v)), jpar.create_mesh(cp=WORLD),
        axis_name="cp", causal=True)
    out, aux = jpar.switch_moe(*(jnp.asarray(a) for a in (x, gate_w, w1,
                                                          w2)),
                               mesh=jpar.create_mesh(ep=WORLD))
    assert _top1_margins(x, gate_w).min() > 1e-4
    for res in ranks:
        assert onp.isfinite(res["dryrun/ring"]).all()
        _close(res["dryrun/ring"], onp.asarray(ring), FWD_TOL)
        onp.testing.assert_allclose(res["dryrun/moe_loss"],
                                    float(out.sum() + aux), rtol=1e-5)


# ----------------------------------------------------------------------
# single-process: layout helpers, plans, the one-rank mesh
# ----------------------------------------------------------------------
@pytest.mark.parametrize("T,n", [(64, 8), (32, 4), (12, 3)])
def test_stripe_permutations_match_jax(T, n):
    onp.testing.assert_array_equal(
        tpar.ring.stripe_permutation(T, n).numpy(),
        onp.asarray(jpar.ring.stripe_permutation(T, n)))
    onp.testing.assert_array_equal(
        tpar.ring.unstripe_permutation(T, n).numpy(),
        onp.asarray(jpar.ring.unstripe_permutation(T, n)))
    x = onp.random.RandomState(T).normal(0, 1, (1, 2, T, 3)).astype("f4")
    s = tpar.stripe_sequence(torch.from_numpy(x), n)
    onp.testing.assert_array_equal(
        s.numpy(), onp.asarray(jpar.stripe_sequence(jnp.asarray(x), n)))
    onp.testing.assert_array_equal(tpar.unstripe_sequence(s, n).numpy(), x)


@pytest.mark.parametrize("layout", ["striped", "roundrobin", "zigzag"])
@pytest.mark.parametrize("inner,outer", [(8, 1), (4, 2), (2, 2)])
def test_causal_balance_matches_jax(layout, inner, outer):
    assert tpar.causal_balance(layout, inner, outer) == \
        jpar.causal_balance(layout, inner, outer)


@pytest.mark.parametrize("layout", ["striped", "roundrobin"])
def test_shard_token_indices_and_plan_match_jax(layout):
    for n, T in ((8, 64), (4, 32), (2, 6)):
        assert tpar.seq_data.token_shards(n, T, layout) == \
            jpar.seq_data.token_shards(n, T, layout)
    for bad in ((0, 8, 60, layout), (0, 8, 64, "zigzag")):
        with pytest.raises(ValueError):
            tpar.seq_data.shard_token_indices(*bad)


@pytest.mark.parametrize("layout", ["striped", "roundrobin"])
def test_epoch_plan_matches_jax_under_random_resizes(layout):
    """The same random resizes drive both plans: the same indices every
    step, and every index exactly once."""
    rng = onp.random.RandomState(7)
    for trial in range(20):
        total = int(rng.randint(1, 200))
        world = int(rng.randint(1, 6))
        per = int(rng.randint(1, 5))
        mine = tpar.EpochPlan(total, world, per, layout=layout)
        ref = jpar.EpochPlan(total, world, per, layout=layout)
        seen = []
        while not ref.done():
            assert not mine.done()
            if rng.rand() < 0.3:
                w = max(1, ref.world + int(rng.randint(-2, 3)))
                mine.resize(w)
                ref.resize(w)
            got, want = mine.step_indices(), ref.step_indices()
            assert [g.tolist() for g in got] == [w.tolist() for w in want]
            seen.extend(onp.concatenate(got).tolist())
        assert mine.done() and sorted(seen) == list(range(total))
        assert repr(mine) == repr(ref)


def test_epoch_plan_validates_like_jax():
    for args, kw in (((10, 2, 2), {"layout": "zigzag"}), ((10, 0, 2), {}),
                     ((10, 2, 2), {"start": 11})):
        with pytest.raises(ValueError):
            tpar.EpochPlan(*args, **kw)
    plan = tpar.EpochPlan(10, 2, 2)
    with pytest.raises(ValueError):
        plan.next_for(2)
    assert plan.next_for(1).tolist() == \
        jpar.EpochPlan(10, 2, 2).next_for(1).tolist()


def test_one_rank_mesh_runs_the_same_code():
    """Without a process group a mesh has one rank: the ring is one
    block, the ep combine the identity, and both equal the plain call."""
    from mxnet_tpu_torch.ops.cuda_ops import flash_attention
    mesh = tpar.create_mesh(cp=-1, device="cpu")
    assert mesh.shape == {"cp": 1} and mesh.size == 1
    assert tpar.local_mesh("ep", "cp", device="cpu").shape == {"ep": 1,
                                                                "cp": 1}
    q, k, v = (torch.from_numpy(a) for a in ring_inputs("gqa_grads"))
    _close(tpar.ring_attention_sharded(q, k, v, mesh, causal=True).numpy(),
           flash_attention(q, k, v, causal=True).numpy(), 1e-6)
    ep = tpar.create_mesh(ep=1, device="cpu")
    args = [torch.from_numpy(a) for a in moe_inputs(*MOE_EP["ep_e8"])]
    got, want = tpar.switch_moe(*args, mesh=ep), tpar.switch_moe(*args)
    _close(got[0].numpy(), want[0].numpy(), 0)
    with pytest.raises(ValueError, match="each rank holds"):
        tpar.switch_moe(args[0], args[1], args[2][:4], args[3][:4], mesh=ep)
    with tpar.mesh_scope(mesh):
        assert tpar.current_mesh() is mesh
    assert tpar.current_mesh() is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tpar.create_mesh(cp=2, device="cpu")


def test_ring_fault_plane_seams_are_not_ported():
    """The name predates the port of the seams: ``_comm`` / ``_gen`` now
    run the ring through ``coordinated_call``, and an injected
    ``collective_fail`` is voted and re-issued together."""
    from mxnet_tpu_torch import fault as tfault
    from mxnet_tpu_torch import fault_dist as tfd
    from mxnet_tpu_torch import profiler as tprof
    mesh = tpar.create_mesh(cp=1, device="cpu")
    q = torch.arange(8.0).reshape(1, 1, 4, 2)
    want = tpar.ring_attention_sharded(q, q, q, mesh)
    gen = tfd.Generation()
    before = tprof.get_counter("fault::dist::coordinated_retries")
    tfault.inject("collective_fail", at=1)
    try:
        got = tpar.ring_attention_sharded(q, q, q, mesh,
                                          _comm=tfd.InProcessComm.create(1)[0],
                                          _gen=gen)
    finally:
        tfault.clear()
    assert torch.equal(got, want)
    assert gen.value == 1
    assert tprof.get_counter("fault::dist::coordinated_retries") == \
        before + 1
