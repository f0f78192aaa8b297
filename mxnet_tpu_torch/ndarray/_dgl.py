"""DGL's graph ops of ``mx.nd.contrib`` on ``CSRNDArray`` graphs.

Counterpart of ``mxnet_tpu/ndarray/contrib.py:1278-1520``
(``src/operator/contrib/dgl_graph.cc``): neighbor sampling (uniform and
by probability), induced subgraphs, adjacency, compaction and
``edge_id``.  Graph sampling feeds the device rather than running on
it: these ops compute in host numpy, as the reference and MXNet's CPU
kernels do, and return their arrays on the graph's device.  The
sampling draws from a numpy ``RandomState`` seeded from ``mx.np.random``,
so ``mx.np.random.seed(n)`` makes it reproducible (its draws cannot
match the reference's).  A CSR's entries are read through its stored
structure: an explicit zero is an edge.
"""
from __future__ import annotations

import numpy as onp
import torch

from .ndarray import NDArray, apply_op, as_tensor


def _dev(x):
    return x._data.device if isinstance(x, NDArray) else None


def _csr_parts(csr):
    return (onp.asarray(csr.indptr.asnumpy(), onp.int64),
            onp.asarray(csr.indices.asnumpy(), onp.int64),
            onp.asarray(csr.data.asnumpy()))


def _make_csr(data, indices, indptr, shape, device):
    from . import sparse as _sparse
    return _sparse.csr_matrix(
        (onp.asarray(data), onp.asarray(indices, onp.int64),
         onp.asarray(indptr, onp.int64)), shape=shape, ctx=device)


def _nd(arr, device):
    return NDArray(as_tensor(onp.asarray(arr), device=device))


def _dgl_rng():
    from .. import numpy as mnp
    seed = int(mnp.random.randint(0, 2 ** 31 - 1, (1,), ctx="cpu")
               .asnumpy()[0])
    return onp.random.RandomState(seed)


def _neighbor_sample_one(csr, seeds, probability, num_hops, num_neighbor,
                         max_num_vertices, rng):
    """One subgraph by the BFS of ``SampleSubgraph`` (dgl_graph.cc:560):
    the seeds are level 0, at most ``num_neighbor`` neighbors sampled a
    visited vertex, at most ``max_num_vertices`` vertices; edges to
    vertices the cap left out are dropped."""
    indptr, indices, data = _csr_parts(csr)
    seeds = onp.asarray(seeds.asnumpy(), onp.int64).reshape(-1)
    sub_ver, queue = {}, []
    for s in seeds:
        if int(s) not in sub_ver:
            sub_ver[int(s)] = 0
            queue.append(int(s))
    neigh = {}
    idx = 0
    while idx < len(queue) and len(sub_ver) < max_num_vertices:
        dst = queue[idx]
        level = sub_ver[dst]
        idx += 1
        if level >= num_hops:
            continue
        lo, hi = int(indptr[dst]), int(indptr[dst + 1])
        cols, vals = indices[lo:hi], data[lo:hi]
        n = hi - lo
        if n == 0:
            neigh[dst] = (onp.empty(0, onp.int64), onp.empty(0))
        elif probability is None:
            pick = onp.arange(n) if n <= num_neighbor else \
                rng.choice(n, size=num_neighbor, replace=False)
            neigh[dst] = (cols[pick], vals[pick])
        else:
            p = probability[cols]
            tot = p.sum()
            if tot <= 0:
                neigh[dst] = (onp.empty(0, onp.int64), onp.empty(0))
            else:
                k = min(num_neighbor, int((p > 0).sum()))
                pick = rng.choice(n, size=k, replace=False, p=p / tot)
                neigh[dst] = (cols[pick], vals[pick])
        for src in neigh[dst][0]:
            if len(sub_ver) >= max_num_vertices:
                break
            if int(src) not in sub_ver:
                sub_ver[int(src)] = level + 1
                queue.append(int(src))
    for dst, (srcs, evals) in list(neigh.items()):
        keep = onp.asarray([int(s) in sub_ver for s in srcs], bool)
        if not keep.all():
            neigh[dst] = (srcs[keep], evals[keep])
    ids = onp.sort(onp.asarray(list(sub_ver), onp.int64))
    nv = len(ids)
    sample_id = onp.full(max_num_vertices + 1, -1, onp.int64)
    sample_id[:nv] = ids
    sample_id[-1] = nv
    layer = onp.full(max_num_vertices, -1, onp.int64)
    layer[:nv] = [sub_ver[int(v)] for v in ids]
    out_indptr = onp.zeros(max_num_vertices + 1, onp.int64)
    out_cols, out_vals = [], []
    for i, v in enumerate(ids):
        srcs, evals = neigh.get(int(v), (onp.empty(0, onp.int64),
                                         onp.empty(0)))
        out_cols.append(srcs)
        out_vals.append(evals)
        out_indptr[i + 1] = out_indptr[i] + len(srcs)
    out_indptr[nv + 1:] = out_indptr[nv]
    cols = onp.concatenate(out_cols) if out_cols else onp.empty(0, onp.int64)
    vals = onp.concatenate(out_vals) if out_vals else onp.empty(0)
    n_side = max(max_num_vertices, int(cols.max()) + 1 if len(cols) else 0)
    sub_csr = _make_csr(vals, cols, out_indptr, (max_num_vertices, n_side),
                        _dev(csr))
    sub_prob = None
    if probability is not None:
        sub_prob = onp.full(max_num_vertices, -1.0, onp.float32)
        sub_prob[:nv] = probability[ids]
    return sample_id, sub_csr, sub_prob, layer


def dgl_csr_neighbor_uniform_sample(csr, *seeds, num_args=None, num_hops=1,
                                    num_neighbor=2, max_num_vertices=100):
    """Uniform neighbor sampling: for the seed arrays, [sample_id...,
    sub_csr..., layer...]."""
    rng = _dgl_rng()
    dev = _dev(csr)
    outs = [_neighbor_sample_one(csr, s, None, num_hops, num_neighbor,
                                 max_num_vertices, rng) for s in seeds]
    return ([_nd(o[0], dev) for o in outs] + [o[1] for o in outs]
            + [_nd(o[3], dev) for o in outs])


def dgl_csr_neighbor_non_uniform_sample(csr, probability, *seeds,
                                        num_args=None, num_hops=1,
                                        num_neighbor=2,
                                        max_num_vertices=100):
    """Neighbor sampling weighted by ``probability``: [sample_id...,
    sub_csr..., prob..., layer...]."""
    rng = _dgl_rng()
    dev = _dev(csr)
    p = onp.asarray(probability.asnumpy(), onp.float64).reshape(-1)
    outs = [_neighbor_sample_one(csr, s, p, num_hops, num_neighbor,
                                 max_num_vertices, rng) for s in seeds]
    return ([_nd(o[0], dev) for o in outs] + [o[1] for o in outs]
            + [_nd(o[2], dev) for o in outs] + [_nd(o[3], dev) for o in outs])


def dgl_subgraph(graph, *vids, return_mapping=False, num_args=None):
    """The subgraphs induced by the vertex lists, renumbered in their
    order; with ``return_mapping`` also the same structure holding the
    edges' positions in ``graph``."""
    indptr, indices, data = _csr_parts(graph)
    dev = _dev(graph)
    subgs, mappings = [], []
    for vid in vids:
        v = onp.asarray(vid.asnumpy(), onp.int64).reshape(-1)
        n = len(v)
        inv = {int(g): i for i, g in enumerate(v)}
        new_indptr = onp.zeros(n + 1, onp.int64)
        cols, vals, eids = [], [], []
        for i, g in enumerate(v):
            lo, hi = int(indptr[g]), int(indptr[g + 1])
            keep = sorted((inv[int(c)], j + lo)
                          for j, c in enumerate(indices[lo:hi])
                          if int(c) in inv)
            cols.extend(k for k, _ in keep)
            eids.extend(e for _, e in keep)
            vals.extend(data[e] for _, e in keep)
            new_indptr[i + 1] = new_indptr[i] + len(keep)
        subgs.append(_make_csr(onp.asarray(vals), cols, new_indptr, (n, n),
                               dev))
        mappings.append(_make_csr(onp.asarray(eids, onp.int64), cols,
                                  new_indptr, (n, n), dev))
    out = subgs + mappings if return_mapping else subgs
    return out if len(out) > 1 else out[0]


def dgl_adjacency(graph):
    """The graph's structure with float32 ones as its values."""
    indptr, indices, _ = _csr_parts(graph)
    return _make_csr(onp.ones(len(indices), onp.float32), indices, indptr,
                     tuple(graph.shape), _dev(graph))


def dgl_graph_compact(*args, graph_sizes=None, return_mapping=False,
                      num_args=None):
    """Sampled sub-CSRs (columns global vertex ids) with their columns
    renumbered by the vertex-id arrays and cut to ``graph_sizes``."""
    n = len(args) // 2
    csrs, id_arrs = args[:n], args[n:]
    sizes = [graph_sizes] if onp.isscalar(graph_sizes) else \
        [int(s) for s in onp.asarray(graph_sizes).reshape(-1)]
    outs = []
    for csr, id_arr, size in zip(csrs, id_arrs, sizes):
        size = int(size)
        indptr, indices, data = _csr_parts(csr)
        ids = onp.asarray(id_arr.asnumpy(), onp.int64)[:size]
        inv = {int(g): i for i, g in enumerate(ids)}
        new_indptr = indptr[:size + 1]
        nnz = int(new_indptr[-1])
        new_cols = onp.asarray([inv[int(c)] for c in indices[:nnz]],
                               onp.int64)
        outs.append(_make_csr(data[:nnz], new_cols, new_indptr,
                              (size, size), _dev(csr)))
    return outs if len(outs) > 1 else outs[0]


def edge_id(data, u, v):
    """The value of edge (u[i], v[i]), -1 where there is none; a dense
    adjacency gives the entry itself (a 0 cannot be told from no edge)."""
    if getattr(data, "stype", "default") != "csr":
        return apply_op(lambda d, uu, vv: d[uu.long(), vv.long()],
                        [data, u, v], "edge_id")
    indptr, indices, vals = _csr_parts(data)
    uu = onp.asarray(u.asnumpy(), onp.int64).reshape(-1)
    vv = onp.asarray(v.asnumpy(), onp.int64).reshape(-1)
    out = onp.full(len(uu), -1.0, onp.float32)
    for i, (a, b) in enumerate(zip(uu, vv)):
        lo, hi = int(indptr[a]), int(indptr[a + 1])
        hit = onp.nonzero(indices[lo:hi] == b)[0]
        if len(hit):
            out[i] = vals[lo + hit[0]]
    return NDArray(torch.from_numpy(out).to(_dev(data)))
