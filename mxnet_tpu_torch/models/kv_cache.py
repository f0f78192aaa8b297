"""Paged KV cache -- the decode substrate of ``serve``.

Counterpart of ``mxnet_tpu/models/kv_cache.py``.  A fixed pool of
fixed-size pages holds the un-repeated GQA K/V (H_kv heads, the layout
the decode kernel reads), indexed per batch slot through a page table::

    k_pages, v_pages : (L, P, H_kv, page_size, D)   the pool
    page_table       : (S, MP) int32                 slot -> page ids
    lengths          : (S,) int32                    valid tokens/slot

Page 0 is the **trash page**: writes of padding tokens (prefill past
``true_len``) and of inactive decode slots go there, so a fixed-shape
scatter needs no host-side masking and a freed slot's stale page-table
row can never corrupt a live slot's pages.  The allocator
(``serve.SlotScheduler``) never hands out page 0.

Unlike the JAX module, whose updates are functional, the pools here
live on the device and the ``write_*`` functions update them **in
place** with ``index_put_``: nothing is copied per step, and the
caller keeps using the same two tensors.

A tensor-parallel replica (``serve.Server(mesh=)``) splits the pools
over their ``H_kv`` axis, the reference's ``PartitionSpec(None, None,
"tp", None, None)`` through ``_valid_spec``: each rank's pools hold its
``H_kv / tp`` heads (:func:`local_kv_heads`; ``CacheSpec.n_kv_heads``
is that local count), and where ``tp`` does not divide ``H_kv`` they
stay whole, the same on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..context import resolve_device

__all__ = ["TRASH_PAGE", "CacheSpec", "init_pools", "local_kv_heads",
           "write_prompt",
           "write_chunk", "write_token", "prompt_index", "chunk_index",
           "token_index", "scatter", "CacheView"]

#: page id every masked (padding / inactive-slot) write is routed to
TRASH_PAGE = 0


@dataclass
class CacheSpec:
    """Static shape of a paged cache pool (one serving replica)."""

    n_layers: int
    n_kv_heads: int       # the heads THIS rank's pools hold
    head_dim: int
    slots: int            # batch slots (S)
    pages: int            # pool pages (P), page 0 reserved as trash
    page_size: int        # tokens per page
    max_pages_per_slot: int  # page-table width (MP)
    dtype: str = "float32"

    @property
    def max_context(self):
        return self.max_pages_per_slot * self.page_size

    def pages_for(self, tokens):
        """Pages needed to hold ``tokens`` cache entries."""
        return -(-int(tokens) // self.page_size)


def local_kv_heads(n_kv_heads, mesh=None):
    """The KV heads one rank's pools hold: ``n_kv_heads / tp`` when the
    mesh's ``tp`` axis divides ``n_kv_heads``, else all of them
    (replicated), as ``_valid_spec`` gives the reference's pool spec."""
    if mesh is None or "tp" not in mesh.shape:
        return n_kv_heads
    tp = mesh.axis_size("tp")
    return n_kv_heads // tp if n_kv_heads % tp == 0 else n_kv_heads


def init_pools(spec: CacheSpec, device=None):
    """Zeroed (k_pages, v_pages) pools of the spec's shape on ``device``
    (``None`` means CUDA, raising without a card)."""
    device = resolve_device(device)
    shape = (spec.n_layers, spec.pages, spec.n_kv_heads, spec.page_size,
             spec.head_dim)
    dt = getattr(torch, spec.dtype)
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


def _index(pages, dest, offset):
    """The ``index_put_`` index of a write: token t -> page ``dest[t]``,
    every kv head, offset ``offset[t]``."""
    heads = torch.arange(pages.shape[2], device=pages.device)
    return dest[:, None], heads[None, :], offset[:, None]


def scatter(pages, layer, index, kv):
    """pages[layer, dest[t], :, offset[t]] = kv[t] for every t, in place;
    ``index`` from :func:`prompt_index`, :func:`chunk_index` or
    :func:`token_index` (the K and V pools of a call share one)."""
    pages[layer].index_put_(index, kv.to(pages.dtype))


def prompt_index(pages, page_row, T, true_len, page_size):
    """Where a T-token prompt's K / V go: token t to page
    ``page_row[t // psz]`` at offset ``t % psz``, tokens at or past
    ``true_len`` (ladder padding) to the trash page."""
    t = torch.arange(T, device=pages.device)
    trash = torch.full_like(t, TRASH_PAGE)
    dest = torch.where(t < true_len, page_row.long()[t // page_size], trash)
    return _index(pages, dest, t % page_size)


def chunk_index(pages, page_row, T, true_len, page_size, start):
    """Where a prompt SUFFIX's K / V go: chunk token t is absolute
    position ``start + t``, in page ``page_row[(start + t) // psz]`` at
    offset ``(start + t) % psz``; tokens at or past ``true_len`` go to
    the trash page."""
    t = torch.arange(T, device=pages.device)
    pos = start + t
    idx = (pos // page_size).clamp(0, page_row.shape[0] - 1)
    trash = torch.full_like(t, TRASH_PAGE)
    dest = torch.where(t < true_len, page_row.long()[idx], trash)
    return _index(pages, dest, pos % page_size)


def token_index(pages, page_table, lengths, active, page_size):
    """Where one decode step's K / V go: slot s's token at cache position
    ``lengths[s]`` (page ``page_table[s, lengths[s] // psz]``); inactive
    slots to the trash page -- their page-table rows may be stale (freed
    and reassigned), so routing by ``active`` is a correctness rule, not
    an optimization."""
    pos = lengths.long()
    idx = (pos // page_size).clamp(0, page_table.shape[1] - 1)
    own = page_table.long().gather(1, idx[:, None])[:, 0]
    dest = torch.where(active, own, torch.full_like(own, TRASH_PAGE))
    return _index(pages, dest, pos % page_size)


def write_prompt(pages, layer, page_row, kv, true_len, page_size):
    """Scatter one prompt's per-layer K (or V) into its slot's pages.

    page_row: (MP,) page ids of the slot; kv: (T, Hkv, D), post-RoPE and
    un-repeated; placed by :func:`prompt_index`.  ``true_len`` is a
    0-dim int tensor or an int."""
    scatter(pages, layer, prompt_index(pages, page_row, kv.shape[0],
                                       true_len, page_size), kv)


def write_chunk(pages, layer, page_row, kv, true_len, page_size, start):
    """Scatter a prompt SUFFIX (chunk prefill, the prefix-cache path),
    placed by :func:`chunk_index`.  ``true_len`` and ``start`` are 0-dim
    int tensors or ints."""
    scatter(pages, layer, chunk_index(pages, page_row, kv.shape[0],
                                      true_len, page_size, start), kv)


def write_token(pages, layer, page_table, lengths, kv, active, page_size):
    """Scatter one decode step's per-layer K (or V), one token per slot
    (kv: (S, Hkv, D)), placed by :func:`token_index`."""
    scatter(pages, layer, token_index(pages, page_table, lengths, active,
                                      page_size), kv)


class CacheView:
    """The cache as the model's forward sees it: one object threaded
    through the layer stack, holding the pools (updated in place) plus
    the slot/position metadata of the current call.

    mode "prefill": one request, ``x`` is (1, T, dim); ``page_row``
    (MP,) and ``true_len`` place the prompt.  mode "chunk": a prompt
    SUFFIX starting at absolute position ``start`` (the prefix-cache
    path -- earlier positions are read from cached pages).  mode
    "decode": one token per slot, ``x`` is (S, 1, dim); ``page_table``
    (S, MP), ``lengths`` (S,) and ``active`` (S,) bool drive the per-slot
    RoPE offsets, the paged write and the paged attention read.
    ``true_len`` and ``start`` are 0-dim int32 tensors on the pools'
    device, so a captured serving program reads them there (Python ints
    work too).
    """

    def __init__(self, mode, k, v, page_size, page_row=None,
                 true_len=None, page_table=None, lengths=None,
                 active=None, start=None):
        if mode not in ("prefill", "chunk", "decode"):
            raise ValueError("CacheView mode must be "
                             "prefill|chunk|decode, got %r" % mode)
        self.mode = mode
        self.k = k
        self.v = v
        self.page_size = page_size
        self.page_row = page_row
        self.true_len = true_len
        self.page_table = page_table
        self.lengths = lengths
        self.active = active
        self.start = start
        self._memo = {}

    def memo(self, key, fn):
        """``fn()``, computed once per view: what every layer of one call
        shares (the RoPE angles, the write index, the attended lengths),
        so a decode step or a prefill launches it once, not per layer."""
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]
