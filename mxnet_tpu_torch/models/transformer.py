"""Llama-class transformer LM in PyTorch.

Counterpart of ``mxnet_tpu/models/transformer.py``: the same config,
module tree and parameter names (``layer0.attention.wq.weight``,
``norm.gamma``, ...), so weights cross over by name
(:func:`mxnet_tpu_torch.convert.load_params`).  Attention runs through
the port's kernels: the full-sequence forward and the serving prefill
through the flash forward, the serving decode through the paged decode
kernel; the chunk (prefix-cache) prefill is plain PyTorch, as it is
plain XLA in the JAX package.  ``attn_impl="dense"`` runs the
full-sequence attention as the plain causal product over repeated KV
heads (``ops.nn.dot_product_attention``), as the JAX dense path does;
the cached paths stay flash / paged whatever ``attn_impl`` says, as
there.  ``attn_impl="ring"`` runs that same dense path: the JAX
``Attention`` computes dense causal attention over repeated KV heads in
both of its ring branches and never calls the ring (ROADMAP section 3,
quirks); the ring is reached through ``parallel.ring_attention_sharded``
/ ``ring_attention_local``.  The full-sequence forward is
differentiable end to end on both devices: on CUDA its attention
backward runs the flash backward kernels (``cuda_ops._FlashAttention``).

Precision follows what the JAX package computes for a bf16 config:
weights are bf16, but the norm gains are float32, so every activation
between matmuls -- the residual stream, the norms -- is float32 there,
while each matmul takes bf16 operands (``Dense`` casts its input) with
fp32 accumulation, and the attention kernels take bf16 q/k/v.

Every ``moe_every``-th block (``layer_idx % moe_every == 0``) of a model
with ``moe_num_experts > 0`` has the switch-MoE FFN
(:class:`MoEFeedForward`, ``parallel.switch_moe``); the load-balance aux
losses of the last forward sum in :meth:`TransformerLM.moe_aux_loss`.

Tensor parallelism.  The layers carry the reference's Megatron
annotations (``mxnet_tpu/models/transformer.py:125-128,309-311,382,
391``): q / k / v and w1 / w3 column-parallel ``("tp", None)``, wo and w2
row-parallel ``(None, "tp")``, the embedding's width and the output's
vocabulary over ``tp``.  Once ``parallel.shard_params`` (or
``TrainStep(mesh=)``) has given each rank its blocks, a block whose
attention and FFN weights are in that layout over one axis that divides
``n_heads`` runs the fast path GSPMD's program amounts to: the input
enters through one ``psum_grad``, the column-parallel products give the
rank's local heads (and hidden units), attention runs through the flash
kernel on those local heads, and each row-parallel product ends in one
``psum``, with no gather between a pair.  When the axis does not divide
``n_kv_heads`` (``n_kv_heads=2`` at ``tp=4``: each rank holds half a KV
head's projection), K and V are ``all_gather``-ed over the axis and each
rank keeps the KV heads its local query heads read; the gather's
gradient is the rank's own slice, summed over the ranks that read it.
Any other placement runs the generic path of the sharded ``Dense`` /
``Embedding`` (``parallel.sharding``).  The reference's
``("dp", "sp", None)`` activation hint (``_sp_constraint``) only
changes GSPMD's layout; in the port it is a no-op and is not kept.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import initializer as init_mod
from ..context import resolve_device
from ..contrib.quantization import int8_forward
from ..gluon.block import Block
from ..gluon.nn import Dense, Embedding, RMSNorm
from ..gluon.parameter import Parameter
from ..ops import nn as F
from ..ops.cuda_ops import flash_attention, paged_attention
from ..parallel import _compat
from ..parallel.moe import switch_moe
from ..parallel.sharding import _batch_axes, global_shape, placement
from . import kv_cache as _kvc

__all__ = ["LlamaConfig", "llama3_8b_config", "tiny_config", "Attention",
           "FeedForward", "MoEFeedForward", "TransformerBlock",
           "TransformerLM"]


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    attn_impl: str = "flash"  # flash | dense | ring (ring runs dense)
    # every moe_every-th block has a switch-MoE FFN of this many experts
    moe_num_experts: int = 0
    moe_every: int = 2
    moe_capacity_factor: float = 1.25


def llama3_8b_config(**over):
    cfg = LlamaConfig(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                      n_kv_heads=8, hidden_dim=14336, rope_theta=500000.0)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def tiny_config(**over):
    cfg = LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                      n_kv_heads=2, hidden_dim=128, max_seq_len=128,
                      dtype="float32")
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _rope_angles(positions, d, theta, device):
    """(cos, sin) of the rotary angles, each (B, T, 1, d/2), at
    ``positions``: (T,) shared across the batch or (B, T) per row -- the
    decode path passes each slot's own cache length."""
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=device) / d))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs      # (B, T, d/2)
    return angles.cos()[:, :, None, :], angles.sin()[:, :, None, :]


def _rope_apply(x, cos, sin):
    """Rotary embedding on (B, T, H, D), split-half form (the first and
    second halves of D are the pair, not even/odd lanes)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding on (B, T, H, D) at ``positions``
    (:func:`_rope_angles`, :func:`_rope_apply`)."""
    return _rope_apply(x, *_rope_angles(positions, x.shape[-1], theta,
                                        x.device))


def _heads_first(x):
    """(B, T, H, D) -> contiguous (B, H, T, D), the kernels' layout."""
    return x.transpose(1, 2).contiguous()


def _megatron_axis(col, row, n_split=1):
    """(mesh, axis, size) when every weight of ``col`` is sharded
    ``(axis, None)`` and every one of ``row`` ``(None, axis)`` over one
    mesh axis of more than one rank that divides ``n_split``, and no
    batch axis of a running step is involved; else None."""
    sh = placement(col[0])
    if sh is None:
        return None
    mesh, ax = sh.mesh, sh.spec[0] if len(sh.spec) else None
    if ax is None or isinstance(ax, tuple) or mesh.axis_size(ax) < 2 \
            or n_split % mesh.axis_size(ax) or ax in _batch_axes(mesh):
        return None
    for w, want in [(c, (ax, None)) for c in col] + \
            [(r, (None, ax)) for r in row]:
        p = placement(w)
        if p is None or p.mesh is not mesh or tuple(p.spec) != want:
            return None
    return mesh, ax, mesh.axis_size(ax)


def _dense(layer, x):
    """``x W^T`` with ``layer``'s (local block of its) weight, or with its
    int8 weight inside a ``contrib.quantization.int8_weights`` scope (the
    serving programs)."""
    y = int8_forward(layer, x, None, False)
    return F.dense(x, layer.weight) if y is None else y


def _pick_heads(t, sel, dim):
    """The heads ``sel`` of ``t`` along ``dim`` (all of them for None),
    stacked by device copies only, so a captured program can hold it."""
    if sel is None:
        return t
    return torch.stack([t.select(dim, h) for h in sel], dim)


def _kv_heads_read(rank, hq, rep):
    """The KV heads that query heads ``rank*hq ..`` read, in the order
    the flash kernel's GQA grouping maps them: the distinct heads when
    the local mapping is a grouping of its own, else one a query head."""
    idx = [(rank * hq + i) // rep for i in range(hq)]
    uniq = sorted(set(idx))
    g = hq // len(uniq)
    if hq % len(uniq) == 0 and idx == [uniq[i // g] for i in range(hq)]:
        return uniq
    return idx


class Attention(Block):
    def __init__(self, cfg: LlamaConfig, layer_idx=0):
        super().__init__()
        if cfg.attn_impl not in ("flash", "dense", "ring"):
            raise ValueError("attn_impl must be 'flash', 'dense' or 'ring', "
                             "got %r" % (cfg.attn_impl,))
        self.cfg = cfg
        self.layer_idx = layer_idx
        hd = cfg.dim // cfg.n_heads
        self.head_dim = hd
        kw = {"use_bias": False, "flatten": False, "dtype": cfg.dtype}
        self.wq = Dense(cfg.n_heads * hd, in_units=cfg.dim, **kw)
        self.wk = Dense(cfg.n_kv_heads * hd, in_units=cfg.dim, **kw)
        self.wv = Dense(cfg.n_kv_heads * hd, in_units=cfg.dim, **kw)
        self.wo = Dense(cfg.dim, in_units=cfg.n_heads * hd, **kw)
        # Megatron TP: qkv column-parallel, out row-parallel
        for w in (self.wq, self.wk, self.wv):
            w.weight.shard(("tp", None))
        self.wo.weight.shard((None, "tp"))

    def forward(self, x, cache=None):
        cfg = self.cfg
        B, T, _ = x.shape
        hd, nh, nkv = self.head_dim, cfg.n_heads, cfg.n_kv_heads
        tp = _megatron_axis([self.wq.weight, self.wk.weight,
                             self.wv.weight], [self.wo.weight], nh)
        if tp is not None:
            return self._forward_tp(x, *tp) if cache is None else \
                self._forward_tp_cached(x, cache, *tp)
        if cache is not None:
            # serving (no gradient): one cast for the three products, whose
            # own casts are then no-ops
            x = x.to(self.wq.weight.dtype)
        q = self.wq(x).view(B, T, nh, hd)
        k = self.wk(x).view(B, T, nkv, hd)
        v = self.wv(x).view(B, T, nkv, hd)
        if cache is not None:
            return self.wo(self._forward_cached(q, k, v, cache))
        pos = torch.arange(T, device=x.device)
        q = _rope(q, pos, cfg.rope_theta)
        k = _rope(k, pos, cfg.rope_theta)
        if cfg.attn_impl in ("dense", "ring"):
            rep = nh // nkv
            o = F.dot_product_attention(
                _heads_first(q), _heads_first(k.repeat_interleave(rep, 2)),
                _heads_first(v.repeat_interleave(rep, 2)), causal=True)
        else:
            # the kernel reads kv groups natively: no repeated heads
            o = flash_attention(_heads_first(q), _heads_first(k),
                                _heads_first(v), causal=True)
        return self.wo(o.transpose(1, 2).reshape(B, T, nh * hd))

    def _forward_tp(self, x, mesh, ax, n):
        """The Megatron fast path on this rank's ``n_heads / n`` local
        query heads (module docstring)."""
        cfg = self.cfg
        B, T, _ = x.shape
        hd, nh, nkv = self.head_dim, cfg.n_heads, cfg.n_kv_heads
        hq, rank = nh // n, mesh.axis_index(ax)
        wq, wk, wv = self.wq.weight, self.wk.weight, self.wv.weight
        x = _compat.psum_grad(x.to(wq.dtype), ax, mesh)
        q = F.dense(x, wq).view(B, T, hq, hd)
        k, v = F.dense(x, wk), F.dense(x, wv)
        if nkv % n == 0:
            k, v = (t.view(B, T, nkv // n, hd) for t in (k, v))
        else:
            heads = _kv_heads_read(rank, hq, nh // nkv)
            k, v = (_compat.all_gather(t, -1, ax, mesh).view(
                B, T, nkv, hd)[:, :, heads] for t in (k, v))
        pos = torch.arange(T, device=x.device)
        q = _rope(q, pos, cfg.rope_theta)
        k = _rope(k, pos, cfg.rope_theta)
        if cfg.attn_impl in ("dense", "ring"):
            rep = hq // k.shape[2]
            o = F.dot_product_attention(
                _heads_first(q), _heads_first(k.repeat_interleave(rep, 2)),
                _heads_first(v.repeat_interleave(rep, 2)), causal=True)
        else:
            o = flash_attention(_heads_first(q), _heads_first(k),
                                _heads_first(v), causal=True)
        o = o.transpose(1, 2).reshape(B, T, hq * hd)
        return _compat.psum(F.dense(o.to(self.wo.weight.dtype),
                                    self.wo.weight), ax, mesh)

    def _forward_tp_cached(self, x, cache, mesh, ax, n):
        """The Megatron path through a paged KV cache (serving), on this
        rank's ``n_heads / n`` local query heads: q / k / v
        column-parallel into the flash or paged kernel, whose pools hold
        the rank's KV heads (``n_kv_heads / n``; all of them where ``n``
        does not divide ``n_kv_heads``: K and V are then gathered, every
        rank writes the whole pools, and attention reads the KV heads
        its query heads read), then wo row-parallel, ending in one
        ``psum``.  No gradient."""
        cfg = self.cfg
        B, T, _ = x.shape
        hd, nh, nkv = self.head_dim, cfg.n_heads, cfg.n_kv_heads
        hq, rank = nh // n, mesh.axis_index(ax)
        x = x.to(self.wq.weight.dtype)
        q = _dense(self.wq, x).view(B, T, hq, hd)
        k, v = _dense(self.wk, x), _dense(self.wv, x)
        sel = None
        if nkv % n == 0:
            k, v = (t.view(B, T, nkv // n, hd) for t in (k, v))
        else:
            k, v = (_compat.all_gather(t, -1, ax, mesh).view(B, T, nkv, hd)
                    for t in (k, v))
            sel = _kv_heads_read(rank, hq, nh // nkv)
            if sel == list(range(nkv)):
                sel = None
        o = self._forward_cached(q, k, v, cache, sel)
        return _compat.psum(_dense(self.wo, o), ax, mesh)

    def _forward_cached(self, q, k, v, cache, sel=None):
        """Prefill / chunk / decode through a paged KV cache (``serve``).

        Prefill: the prompt attends causally over its own K/V (no cache
        read) through the flash kernel, and the post-RoPE, un-repeated
        K/V are scattered into the slot's pages.  Chunk: a prompt suffix
        from position ``start`` attends over the cached prefix pages and
        itself (plain PyTorch).  Decode: one new token per slot, RoPE at
        each slot's own cache length, its K/V scattered at that
        position, then the paged decode kernel reads the slot's whole
        cache.  The pools on ``cache`` are updated in place.  ``true_len``
        and ``start`` may be 0-dim int32 tensors on the pools' device (a
        serving program reads them there) or Python ints; the last
        logit row is then read with a device index by the caller.

        ``q`` holds the query heads this call computes and ``k`` / ``v``
        the heads the pools hold (all of the model's, or a
        tensor-parallel rank's); ``sel`` names the pool heads the query
        heads read, in the kernels' GQA grouping (None: all of them).
        """
        cfg = self.cfg
        B, T = q.shape[0], q.shape[1]
        hd, nh, nkv = self.head_dim, q.shape[2], k.shape[2]
        theta, layer, psz = cfg.rope_theta, self.layer_idx, cache.page_size
        dev = q.device
        if cache.mode == "decode":
            lengths = cache.lengths
            # shared by every layer of the call: computed once (memo)
            angles = cache.memo("rope", lambda: _rope_angles(
                lengths.long()[:, None], hd, theta, dev))
            index = cache.memo("index", lambda: _kvc.token_index(
                cache.k, cache.page_table, lengths, cache.active, psz))
        else:
            start = cache.start if cache.mode == "chunk" else 0
            angles = cache.memo("rope", lambda: _rope_angles(
                start + torch.arange(T, device=dev), hd, theta, dev))
            index = cache.memo("index", lambda: (
                _kvc.chunk_index(cache.k, cache.page_row, T, cache.true_len,
                                 psz, start) if cache.mode == "chunk" else
                _kvc.prompt_index(cache.k, cache.page_row, T,
                                  cache.true_len, psz)))
        # q and k rotate together: one set of launches for both
        qk = _rope_apply(torch.cat([q, k], dim=2), *angles)
        q, k = qk[:, :, :nh], qk[:, :, nh:]
        if cache.mode == "prefill":
            _kvc.scatter(cache.k, layer, index, k[0])
            _kvc.scatter(cache.v, layer, index, v[0])
            o = flash_attention(_heads_first(q),
                                _heads_first(_pick_heads(k, sel, 2)),
                                _heads_first(_pick_heads(v, sel, 2)),
                                causal=True)
            return o.transpose(1, 2).reshape(B, T, nh * hd)
        if cache.mode == "chunk":
            _kvc.scatter(cache.k, layer, index, k[0])
            _kvc.scatter(cache.v, layer, index, v[0])
            row = cache.page_row.long()
            MP = row.shape[0]
            # row i of the gathered pages covers absolute positions
            # [i*psz, (i+1)*psz), so kpos < start keeps exactly the
            # cached prefix (this chunk's own writes land at >= start)
            kpre = cache.k[layer, row].transpose(1, 2).reshape(
                MP * psz, nkv, hd)
            vpre = cache.v[layer, row].transpose(1, 2).reshape(
                MP * psz, nkv, hd)
            kk = _pick_heads(torch.cat([kpre, k[0]], 0), sel, 1)
            vv = _pick_heads(torch.cat([vpre, v[0]], 0), sel, 1)
            rep = nh // kk.shape[1]
            kk = kk.repeat_interleave(rep, 1)
            vv = vv.repeat_interleave(rep, 1)
            scores = torch.einsum("tnd,snd->nts", q[0].float(),
                                  kk.float()) / math.sqrt(hd)

            def chunk_mask():
                pos = start + torch.arange(T, device=dev)
                kpos = torch.arange(MP * psz, device=dev)
                pmask = (kpos[None, :] < start).expand(T, MP * psz)
                cmask = pos[None, :] <= pos[:, None]  # causal over chunk
                return torch.cat([pmask, cmask], 1)
            mask = cache.memo("mask", chunk_mask)
            scores = scores.masked_fill(~mask[None], -1e30)
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum("nts,snd->tnd", probs, vv.float())
            return o.to(v.dtype).reshape(B, T, nh * hd)
        _kvc.scatter(cache.k, layer, index, k[:, 0])
        _kvc.scatter(cache.v, layer, index, v[:, 0])
        ctx = cache.memo("ctx", lambda: torch.where(
            cache.active, lengths + 1, lengths))
        o = paged_attention(q[:, 0].contiguous(),
                            _pick_heads(cache.k[layer], sel, 1),
                            _pick_heads(cache.v[layer], sel, 1),
                            cache.page_table, ctx)
        return o.reshape(B, T, nh * hd)


class FeedForward(Block):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        kw = {"use_bias": False, "flatten": False, "dtype": cfg.dtype}
        self.w1 = Dense(cfg.hidden_dim, in_units=cfg.dim, **kw)   # gate
        self.w3 = Dense(cfg.hidden_dim, in_units=cfg.dim, **kw)   # up
        self.w2 = Dense(cfg.dim, in_units=cfg.hidden_dim, **kw)   # down
        self.w1.weight.shard(("tp", None))
        self.w3.weight.shard(("tp", None))
        self.w2.weight.shard((None, "tp"))

    def forward(self, x):
        tp = _megatron_axis([self.w1.weight, self.w3.weight],
                            [self.w2.weight],
                            global_shape(self.w1.weight)[0])
        if tp is not None:
            mesh, ax, _ = tp
            w1, w3, w2 = self.w1.weight, self.w3.weight, self.w2.weight
            x = _compat.psum_grad(x.to(w1.dtype), ax, mesh)
            h = F.activation(_dense(self.w1, x).float(), "silu") \
                * _dense(self.w3, x)
            return _compat.psum(_dense(self.w2, h.to(w2.dtype)), ax, mesh)
        # the gate product in float32, as the JAX bf16 model computes it
        # (the product promotes w3's output to float32)
        return self.w2(F.activation(self.w1(x).float(), "silu")
                       * self.w3(x))


class MoEFeedForward(Block):
    """Switch-MoE FFN (reference ``models/transformer.py:317-350``):
    top-1 routing with a static capacity and ReLU experts
    (``parallel.switch_moe``), parameters ``gate`` (D, E),
    ``experts_w1`` (E, D, H) and ``experts_w2`` (E, H, D).  The aux loss
    of the last forward is kept in ``last_aux_loss`` (float32), for the
    training loss to add.  The tokens enter the experts in the weights'
    dtype, as ``Dense`` casts its input."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        E, D, H = cfg.moe_num_experts, cfg.dim, cfg.hidden_dim
        self.gate = Parameter((D, E), cfg.dtype)
        self.experts_w1 = Parameter((E, D, H), cfg.dtype)
        self.experts_w2 = Parameter((E, H, D), cfg.dtype)
        self._capacity = cfg.moe_capacity_factor
        self.last_aux_loss = None

    def forward(self, x):
        B, T, D = x.shape
        w = self.experts_w1
        out, aux = switch_moe(x.reshape(B * T, D).to(w.dtype), self.gate, w,
                              self.experts_w2,
                              capacity_factor=self._capacity)
        self.last_aux_loss = aux
        return out.reshape(B, T, D)


class TransformerBlock(Block):
    def __init__(self, cfg: LlamaConfig, layer_idx=0):
        super().__init__()
        self.attention_norm = RMSNorm(cfg.dim, epsilon=cfg.norm_eps)
        self.attention = Attention(cfg, layer_idx=layer_idx)
        self.ffn_norm = RMSNorm(cfg.dim, epsilon=cfg.norm_eps)
        use_moe = (cfg.moe_num_experts > 0
                   and layer_idx % max(1, cfg.moe_every) == 0)
        self.feed_forward = MoEFeedForward(cfg) if use_moe \
            else FeedForward(cfg)

    def forward(self, x, cache=None):
        """``x`` is the float32 residual stream (each sum promotes the
        branch's output to float32)."""
        x = x + self.attention(self.attention_norm(x), cache=cache)
        return x + self.feed_forward(self.ffn_norm(x))


class TransformerLM(Block):
    """Decoder-only LM.  Input: (B, T) int tokens; output: (B, T, vocab).

    ``device=None`` means CUDA (and raises without a card); pass
    ``device="cpu"`` for the plain path.  The constructor initializes
    every parameter on ``device`` through ``Block.initialize`` with
    zero weights and unit norm gains; fill them with :meth:`initialize`
    or :func:`mxnet_tpu_torch.convert.load_params`."""

    def __init__(self, cfg: LlamaConfig = None, device=None, **kwargs):
        super().__init__()
        cfg = cfg or LlamaConfig(**kwargs)
        self.cfg = cfg
        self.tok_embeddings = Embedding(cfg.vocab_size, cfg.dim,
                                        dtype=cfg.dtype)
        self.tok_embeddings.weight.shard((None, "tp"))
        blocks = []
        for i in range(cfg.n_layers):
            blk = TransformerBlock(cfg, layer_idx=i)
            setattr(self, "layer%d" % i, blk)   # keys layer0.*, as in JAX
            blocks.append(blk)
        self.layers = tuple(blocks)
        self.norm = RMSNorm(cfg.dim, epsilon=cfg.norm_eps)
        self.output = Dense(cfg.vocab_size, in_units=cfg.dim, use_bias=False,
                            flatten=False, dtype=cfg.dtype)
        self.output.weight.shard(("tp", None))
        self._device = resolve_device(device)
        super().initialize(init_mod.Zero(), device=self._device)

    def initialize(self, generator, std=0.02):
        """Weights from N(0, std) drawn from ``generator``, norm gains 1
        (``Block.initialize`` with ``Normal(std)``, refilling)."""
        return super().initialize(init_mod.Normal(std), device=self._device,
                                  generator=generator, force_reinit=True)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def forward(self, tokens, cache=None):
        """Full-sequence logits (``cache=None``), or the incremental
        serving path: with a :class:`~.kv_cache.CacheView` the call is a
        prefill / chunk prefill (write the prompt's K/V into the view's
        pages) or a decode step (one token per slot)."""
        for blk in self.layers:           # no aux loss of an older call
            if isinstance(blk.feed_forward, MoEFeedForward):
                blk.feed_forward.last_aux_loss = None
        h = self.tok_embeddings(tokens).float()   # the residual stream
        for blk in self.layers:
            h = blk(h, cache=cache)
        return self.output(self.norm(h))

    def moe_aux_loss(self):
        """Sum of the MoE blocks' load-balance aux losses of the last
        forward (float32, differentiable); 0.0 without MoE blocks."""
        aux = [blk.feed_forward.last_aux_loss for blk in self.layers
               if isinstance(blk.feed_forward, MoEFeedForward)
               and blk.feed_forward.last_aux_loss is not None]
        if not aux:
            return torch.zeros((), device=self._device)
        return torch.stack(aux).sum()
