"""Pipeline parallelism: a stage-sharded microbatch loop over ranks.

Counterpart of ``mxnet_tpu/parallel/pipeline.py``.  Each rank of the
``pp`` mesh axis owns one stage (or ``v`` interleaved virtual stages:
rank ``d`` owns global stages ``d, n+d, 2n+d, ...``); a microbatch's
activations hop stage to stage, cotangents hop back.

The three schedules (``"gpipe"``, ``"1f1b"``, ``"interleaved"``) are
data for one loop: :func:`_simulate`'s slot tables, copied from the
reference (pure Python).  Each rank executes its row of the tables:
at every slot it files the payloads that arrived, runs the table's op
(a stage forward, a stage backward, or nothing in a bubble), and sends
what it produced.  The reference runs the same exchanges on every
device every slot, idle ones sending zeros; here the tables say who
sends to whom, so only payloads travel (``_compat.exchange``, one
``batch_isend_irecv`` a slot: activations to rank ``d+1``, cotangents
to ``d-1``, round the ring).

The backward recomputes a stage from its stashed **input**
(``torch.autograd.grad`` through ``stage_fn``): no activation inside a
stage is kept.  ``1f1b`` keeps at most ``n - stage`` inputs stashed,
``gpipe`` all ``M``; :data:`LAST` records the most this rank held at
once (``max_live_stash``) in its last call.  Outputs come back
replicated on every rank (a broadcast from the last stage's rank, the
reference's psum of one-hot contributions), as do the input cotangents
(from the first stage's) and the parameter gradients (gathered over
``pp``, in stage order).

The stage functions must keep the activation's shape between stages
and be independent across the rows of a batch, as in the reference.
``stage_fn(params_i, x)`` takes stage ``i``'s slice of
``params_stacked``: a tensor or a dict / list / tuple of tensors whose
leading dimension is the stage (``torch.func.functional_call`` turns a
Block into one).  Both entry points launch through the reference's
fault seam (:func:`_launch`, reference :401-426): the
``collective_fail`` injection point, then ``fault_dist.coordinated_call``
in a job of more than one rank (or with a ``_comm`` given: every rank
votes after a failed attempt and all re-issue together, and with
``mutating=True`` a mid-op failure aborts everywhere), else
``fault.retry_call``, never under a per-attempt timeout.  ``_comm`` /
``_gen`` are the test seams of ``coordinated_call``'s parameters.
"""
from __future__ import annotations

import functools

import torch
from torch.utils import _pytree as pytree

from .. import fault as _fault
from . import _compat
from .mesh import _world, current_mesh

__all__ = ["SCHEDULES", "LAST", "gpipe_forward", "schedule_info",
           "pipeline_apply", "pipeline_vjp"]

SCHEDULES = ("gpipe", "1f1b", "interleaved")

#: this rank's most recent run: ``slots`` and ``max_live_stash`` (the
#: most stage inputs it held stashed at once)
LAST = {}


# ----------------------------------------------------------------------
# schedule simulation (host-side, pure python ints; the reference's)
# ----------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def _simulate(schedule, n, M, v=1, with_backward=True):
    """Event-driven slot simulation of ``schedule`` over ``n`` devices ×
    ``v`` virtual stages × ``M`` microbatches.  One op (F or B) per
    device per slot; an activation/cotangent produced at slot t is
    consumable by the neighbor from slot t+1 (one-hop latency).  Returns
    the per-slot op tables the loop body indexes, the receive tables
    (what arrives at each device each slot), the stash buffer depths,
    and the bubble statistics."""
    if schedule not in SCHEDULES:
        raise ValueError("unknown schedule %r (one of %s)"
                         % (schedule, ", ".join(SCHEDULES)))
    L = n * v
    f_done = [[None] * M for _ in range(L)]
    b_done = [[None] * M for _ in range(L)]
    next_f = [0] * L
    next_b = [0] * L
    f_tab, fv_tab, b_tab, bv_tab = [], [], [], []
    done_ops, total_ops = 0, L * M * (2 if with_backward else 1)
    limit = 16 * (L + M + 4)
    t = 0
    while done_ops < total_ops:
        if t >= limit:
            raise AssertionError(
                "schedule %r (n=%d M=%d v=%d) did not converge"
                % (schedule, n, M, v))
        frow, fvrow = [-1] * n, [-1] * n
        brow, bvrow = [-1] * n, [-1] * n
        for d in range(n):
            cand_b = None
            if with_backward:
                for j in range(v):
                    s = j * n + d
                    m = next_b[s]
                    if m >= M or m >= next_f[s]:
                        continue
                    if f_done[s][m] is None or f_done[s][m] >= t:
                        continue
                    if schedule == "gpipe" and next_f[s] < M:
                        continue  # classic flush: backward after all F
                    if s < L - 1 and (b_done[s + 1][m] is None
                                      or b_done[s + 1][m] + 1 > t):
                        continue
                    if cand_b is None or m < cand_b[1]:
                        cand_b = (s, m)
            cand_f = None
            for j in range(v):
                s = j * n + d
                m = next_f[s]
                if m >= M:
                    continue
                if with_backward and schedule != "gpipe" \
                        and next_f[s] - next_b[s] >= L - s:
                    continue  # 1F1B in-flight cap: B catches up first
                if s > 0 and (f_done[s - 1][m] is None
                              or f_done[s - 1][m] + 1 > t):
                    continue
                if cand_f is None or (m, j) < (cand_f[1],
                                               cand_f[0] // n):
                    cand_f = (s, m)
            if cand_b is not None:  # backward has priority (1F1B)
                s, m = cand_b
                brow[d], bvrow[d] = m, s // n
                b_done[s][m] = t
                next_b[s] += 1
                done_ops += 1
            elif cand_f is not None:
                s, m = cand_f
                frow[d], fvrow[d] = m, s // n
                f_done[s][m] = t
                next_f[s] += 1
                done_ops += 1
        f_tab.append(frow)
        fv_tab.append(fvrow)
        b_tab.append(brow)
        bv_tab.append(bvrow)
        t += 1
    T = t

    # receive tables: the activation/cotangent arriving at device d at
    # slot t (sent by its neighbor at t-1)
    rf_mb = [[-1] * n for _ in range(T)]
    rf_vs = [[-1] * n for _ in range(T)]
    rb_mb = [[-1] * n for _ in range(T)]
    rb_vs = [[-1] * n for _ in range(T)]
    for s in range(L - 1):
        for m in range(M):
            slot = f_done[s][m] + 1
            if slot < T:
                rf_mb[slot][(s + 1) % n] = m
                rf_vs[slot][(s + 1) % n] = (s + 1) // n
    if with_backward:
        for s in range(1, L):
            for m in range(M):
                slot = b_done[s][m] + 1
                if slot < T:
                    rb_mb[slot][(s - 1) % n] = m
                    rb_vs[slot][(s - 1) % n] = (s - 1) // n

    def _window(write, free):
        """Max span of simultaneously-live microbatch indices -> minimal
        safe ring-buffer depth for ``m % depth`` indexing."""
        best = 1
        for s in range(L):
            lives = [(write(s, m), free(s, m)) for m in range(M)
                     if write(s, m) is not None]
            for i, (w1, f1) in enumerate(lives):
                for j in range(i + 1, len(lives)):
                    w2, f2 = lives[j]
                    if w1 <= f2 and w2 <= f1:  # overlap
                        best = max(best, j - i + 1)
        return best

    if with_backward:
        act_buf = _window(
            lambda s, m: f_done[s][m] if s == 0
            else f_done[s - 1][m] + 1,
            lambda s, m: b_done[s][m])
        cot_buf = _window(
            lambda s, m: None if s >= L - 1 else b_done[s + 1][m] + 1,
            lambda s, m: b_done[s][m])
    else:
        act_buf = _window(
            lambda s, m: f_done[s][m] if s == 0
            else f_done[s - 1][m] + 1,
            lambda s, m: f_done[s][m])
        cot_buf = 1
    max_inflight = max(
        (next_f[s] if not with_backward else
         max((sum(1 for m in range(M)
                  if f_done[s][m] <= tt and (b_done[s][m] is None
                                             or b_done[s][m] > tt))
              for tt in range(T)), default=0))
        for s in range(L))
    return {
        "f_mb": f_tab, "f_vs": fv_tab, "b_mb": b_tab, "b_vs": bv_tab,
        "rf_mb": rf_mb, "rf_vs": rf_vs, "rb_mb": rb_mb, "rb_vs": rb_vs,
        "slots": T, "act_buf": act_buf, "cot_buf": cot_buf,
        "max_inflight": max_inflight,
        "bubble_fraction": 1.0 - total_ops / float(T * n),
    }


def schedule_info(schedule, n, num_microbatches, virtual_stages=1,
                  with_backward=True):
    """Analytic schedule statistics (slots, bubble fraction, stash
    depths, peak in-flight microbatches) for a pipeline of ``n`` ranks
    × ``virtual_stages`` running ``num_microbatches``."""
    sim = _simulate(schedule, n, num_microbatches, virtual_stages,
                    with_backward)
    return {k: sim[k] for k in ("slots", "act_buf", "cot_buf",
                                "max_inflight", "bubble_fraction")}


def _stage_order(n, v):
    """Device-major placement for interleaving: device d's chunk j holds
    global stage j*n + d (so every forward hop is the d->d+1 neighbor
    exchange).  Returns (placement order, inverse) index lists."""
    order = [j * n + d for d in range(n) for j in range(v)]
    inv = [(s % n) * v + (s // n) for s in range(n * v)]
    return order, inv


# ----------------------------------------------------------------------
# the loop each rank runs
# ----------------------------------------------------------------------
def _chunk(params, j):
    return pytree.tree_map(lambda a: a[j], params)


def _stage_grads(stage_fn, params, inp, g_out):
    """(parameter grads, input grad) of one stage at ``inp``, recomputed
    from the input."""
    leaves, spec = pytree.tree_flatten(params)
    leaves = [a.detach().requires_grad_() for a in leaves]
    inp = inp.detach().requires_grad_()
    with torch.enable_grad():
        y = stage_fn(pytree.tree_unflatten(leaves, spec), inp)
        grads = torch.autograd.grad(y, leaves + [inp], g_out.to(y.dtype),
                                    allow_unused=True)
    dp = [torch.zeros_like(a) if g is None else g
          for a, g in zip(leaves, grads[:-1])]
    return dp, grads[-1]


def _scheduled(stage_fn, params_dev, xm, gym, sim, n, v, mesh, axis,
               with_backward):
    """This rank's row of the slot tables.  ``params_dev``: this rank's
    ``v`` chunks (leading dimension ``v``).  Returns (outs, dxs, dparams
    as flat leaves with leading ``v``) on this rank: outs from the last
    stage, dxs from the first, zeros elsewhere."""
    d = mesh.axis_index(axis)
    M, L, T = xm.shape[0], n * v, sim["slots"]
    like = xm[0]
    stash, cots = {}, {}
    outs = torch.zeros_like(xm)
    dxs = torch.zeros_like(xm) if with_backward else None
    leaves, _ = pytree.tree_flatten(params_dev)
    dparams = [torch.zeros_like(a) for a in leaves] \
        if with_backward else None
    fmsg = bmsg = None
    live = 0
    for t in range(T):
        if fmsg is not None:
            stash[(sim["rf_vs"][t][d], sim["rf_mb"][t][d])] = fmsg
        if bmsg is not None:
            cots[(sim["rb_vs"][t][d], sim["rb_mb"][t][d])] = bmsg
        fm, fv = sim["f_mb"][t][d], sim["f_vs"][t][d]
        bm, bv = sim["b_mb"][t][d], sim["b_vs"][t][d]
        sends = []
        if fm >= 0:
            s = fv * n + d
            inp = xm[fm] if s == 0 else stash[(fv, fm)]
            stash[(fv, fm)] = inp       # stage 0 stashes its own input
            live = max(live, len(stash))
            with torch.no_grad():
                y = stage_fn(_chunk(params_dev, fv), inp)
            if s == L - 1:
                outs[fm] = y
            else:
                sends.append((y, (d + 1) % n, 0))
            if not with_backward:
                del stash[(fv, fm)]
        elif with_backward and bm >= 0:
            s = bv * n + d
            inp = stash.pop((bv, bm))
            g_in = gym[bm] if s == L - 1 else cots.pop((bv, bm))
            dp, dx = _stage_grads(stage_fn, _chunk(params_dev, bv), inp,
                                  g_in)
            for acc, g in zip(dparams, dp):
                acc[bv] += g
            if s == 0:
                dxs[bm] = dx
            else:
                sends.append((dx, (d - 1) % n, 1))
        recvs = []
        if t + 1 < T and sim["rf_mb"][t + 1][d] >= 0:
            recvs.append((like, (d - 1) % n, 0))
        if with_backward and t + 1 < T and sim["rb_mb"][t + 1][d] >= 0:
            recvs.append((like, (d + 1) % n, 1))
        got = _compat.exchange(sends, recvs, axis, mesh) if n > 1 else []
        fmsg = got.pop(0) if recvs and recvs[0][2] == 0 else None
        bmsg = got.pop(0) if got else None
    LAST.clear()
    LAST.update(slots=T, max_live_stash=live)
    return outs, dxs, dparams


def _launch(attempt, mutating, _comm, _gen):
    """The pipeline's fault seam (the kvstore's and the ring's protocol):
    with more than one rank, ``coordinated_call`` (a failed attempt is
    voted and re-issued by every rank together; a mid-op failure of a
    mutating call aborts everywhere); with one, ``retry_call``.  Never a
    per-attempt timeout: an abandoned attempt would issue a second
    identical exchange on the same group."""
    if _comm is not None or _world()[1] > 1:
        from .. import fault_dist as _fdist
        # the production path (ambient comm and generation) rides an
        # ACTIVE step lease; the test seams stay on per-op voting
        return _fdist.coordinated_call(attempt, op="pipeline",
                                       mutating=mutating, comm=_comm,
                                       gen=_gen,
                                       lease=(_comm is None and
                                              _gen is None) or None)
    policy = _fault.entry_only_policy() if mutating \
        else _fault.mutating_policy()
    return _fault.retry_call(attempt, op="pipeline", policy=policy)


def _check(schedule, virtual_stages, params_stacked, n):
    if schedule not in SCHEDULES:
        raise ValueError("unknown schedule %r (one of %s)"
                         % (schedule, ", ".join(SCHEDULES)))
    v = int(virtual_stages)
    if v > 1 and schedule != "interleaved":
        raise ValueError("virtual_stages=%d requires "
                         "schedule='interleaved'" % v)
    L = pytree.tree_leaves(params_stacked)[0].shape[0]
    if L != n * v:
        raise ValueError(
            "stage stack has %d stages but mesh axis is %d devices x "
            "%d virtual stages" % (L, n, v))
    return v


def _mine(params_stacked, order, d, v):
    """This rank's chunks, in placement order."""
    idx = order[d * v:(d + 1) * v]
    return pytree.tree_map(
        lambda a: a[torch.as_tensor(idx, device=a.device)], params_stacked)


def _microbatches(x, M):
    B = x.shape[0]
    if B % M:
        raise ValueError("batch %d does not split into %d microbatches"
                         % (B, M))
    return x.reshape((M, B // M) + tuple(x.shape[1:]))


def gpipe_forward(stage_fn, params_stacked, x_microbatches, axis_name="pp",
                  mesh=None):
    """On each rank of ``axis_name``: apply this rank's stage
    (``params_stacked`` is its block, leading dimension 1, as under the
    reference's ``shard_map``) under the GPipe schedule to the
    microbatches ``(M, ...)``; returns the last stage's outputs
    ``(M, ...)`` on every rank."""
    mesh = mesh if mesh is not None else current_mesh()
    n = mesh.axis_size(axis_name)
    sim = _simulate("gpipe", n, x_microbatches.shape[0], 1, False)
    outs, _, _ = _scheduled(stage_fn, params_stacked, x_microbatches, None,
                            sim, n, 1, mesh, axis_name, False)
    return _compat.broadcast(outs, n - 1, axis_name, mesh)


def pipeline_apply(stage_fn, params_stacked, x, mesh, num_microbatches,
                   axis_name="pp", mutating=False, _comm=None, _gen=None,
                   schedule="gpipe", virtual_stages=1):
    """Forward a batch ``x`` (B, ...) through the stage stack
    ``params_stacked`` (leading dimension: the ``n * v`` stages, whole
    on every rank) in ``num_microbatches``; returns (B, ...) on every
    rank.  ``mutating=True`` (a ``stage_fn`` that mutates host state)
    makes a mid-op failure abort every rank instead of re-running it
    (:func:`_launch`)."""
    n = mesh.axis_size(axis_name)
    v = _check(schedule, virtual_stages, params_stacked, n)
    xm = _microbatches(x, num_microbatches)
    d = mesh.axis_index(axis_name)
    order, _ = _stage_order(n, v)
    sim = _simulate(schedule, n, num_microbatches, v, with_backward=False)

    def attempt():
        _fault.collective_check("pipeline")
        outs, _, _ = _scheduled(stage_fn,
                                _mine(params_stacked, order, d, v), xm,
                                None, sim, n, v, mesh, axis_name, False)
        return _compat.broadcast(outs, n - 1, axis_name, mesh)

    outs = _launch(attempt, mutating, _comm, _gen)
    return outs.reshape(x.shape[:1] + outs.shape[2:])


def pipeline_vjp(stage_fn, params_stacked, x, gy, mesh, num_microbatches,
                 axis_name="pp", schedule="1f1b", virtual_stages=1,
                 mutating=False, _comm=None, _gen=None):
    """Forward and backward of the stage stack under ``schedule``: the
    training path.  ``gy`` is the cotangent of the output (same shape as
    ``x``).  Returns ``(y, dx, dparams)``: the outputs, the input's
    cotangent and each stage's parameter gradients summed over the
    microbatches (the tree of ``params_stacked``, stage order), all
    replicated on every rank."""
    n = mesh.axis_size(axis_name)
    v = _check(schedule, virtual_stages, params_stacked, n)
    xm = _microbatches(x, num_microbatches)
    gym = gy.reshape(xm.shape)
    d = mesh.axis_index(axis_name)
    order, inv = _stage_order(n, v)
    sim = _simulate(schedule, n, num_microbatches, v, with_backward=True)
    _, spec = pytree.tree_flatten(params_stacked)

    def attempt():
        _fault.collective_check("pipeline")
        mine = _mine(params_stacked, order, d, v)
        outs, dxs, dparams = _scheduled(stage_fn, mine, xm, gym, sim, n, v,
                                        mesh, axis_name, True)
        outs = _compat.broadcast(outs, n - 1, axis_name, mesh)
        dxs = _compat.broadcast(dxs, 0, axis_name, mesh)
        gathered = []
        for g in dparams:
            g = _compat._gather_raw(g, 0, axis_name, mesh) if n > 1 else g
            gathered.append(g[torch.as_tensor(inv, device=g.device)])
        return outs, dxs, pytree.tree_unflatten(gathered, spec)

    outs, dxs, dparams = _launch(attempt, mutating, _comm, _gen)
    return (outs.reshape(x.shape[:1] + outs.shape[2:]),
            dxs.reshape(x.shape[:1] + dxs.shape[2:]), dparams)
