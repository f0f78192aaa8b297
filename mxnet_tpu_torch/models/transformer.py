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
there.  The full-sequence forward is
differentiable end to end on both devices: on CUDA its attention
backward runs the flash backward kernels (``cuda_ops._FlashAttention``).

Precision follows what the JAX package computes for a bf16 config:
weights are bf16, but the norm gains are float32, so every activation
between matmuls -- the residual stream, the norms -- is float32 there,
while each matmul takes bf16 operands (``Dense`` casts its input) with
fp32 accumulation, and the attention kernels take bf16 q/k/v.

Not ported yet: the switch-MoE FFN (``moe_num_experts > 0``), the ring
attention (``attn_impl="ring"``, with ROADMAP queue 3) and the sharding
hints.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import initializer as init_mod
from ..context import resolve_device
from ..gluon.block import Block
from ..gluon.nn import Dense, Embedding, RMSNorm
from ..ops import nn as F
from ..ops.cuda_ops import flash_attention, paged_attention
from . import kv_cache as _kvc

__all__ = ["LlamaConfig", "llama3_8b_config", "tiny_config", "Attention",
           "FeedForward", "TransformerBlock", "TransformerLM"]


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
    attn_impl: str = "flash"  # flash | dense (ring: ROADMAP queue 3)
    moe_num_experts: int = 0


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


class Attention(Block):
    def __init__(self, cfg: LlamaConfig, layer_idx=0):
        super().__init__()
        if cfg.attn_impl == "ring":
            raise NotImplementedError("mxnet_tpu_torch: attn_impl='ring' "
                                      "is not ported yet (ring attention "
                                      "comes with ROADMAP queue 3)")
        if cfg.attn_impl not in ("flash", "dense"):
            raise ValueError("attn_impl must be 'flash' or 'dense', got %r"
                             % (cfg.attn_impl,))
        self.cfg = cfg
        self.layer_idx = layer_idx
        hd = cfg.dim // cfg.n_heads
        self.head_dim = hd
        kw = {"use_bias": False, "flatten": False, "dtype": cfg.dtype}
        self.wq = Dense(cfg.n_heads * hd, in_units=cfg.dim, **kw)
        self.wk = Dense(cfg.n_kv_heads * hd, in_units=cfg.dim, **kw)
        self.wv = Dense(cfg.n_kv_heads * hd, in_units=cfg.dim, **kw)
        self.wo = Dense(cfg.dim, in_units=cfg.n_heads * hd, **kw)

    def forward(self, x, cache=None):
        cfg = self.cfg
        B, T, _ = x.shape
        hd, nh, nkv = self.head_dim, cfg.n_heads, cfg.n_kv_heads
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
        if cfg.attn_impl == "dense":
            rep = nh // nkv
            o = F.dot_product_attention(
                _heads_first(q), _heads_first(k.repeat_interleave(rep, 2)),
                _heads_first(v.repeat_interleave(rep, 2)), causal=True)
        else:
            # the kernel reads kv groups natively: no repeated heads
            o = flash_attention(_heads_first(q), _heads_first(k),
                                _heads_first(v), causal=True)
        return self.wo(o.transpose(1, 2).reshape(B, T, nh * hd))

    def _forward_cached(self, q, k, v, cache):
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
        logit row is then read with a device index by the caller."""
        cfg = self.cfg
        B, T = q.shape[0], q.shape[1]
        hd, nh, nkv = self.head_dim, cfg.n_heads, cfg.n_kv_heads
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
            o = flash_attention(_heads_first(q), _heads_first(k),
                                _heads_first(v), causal=True)
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
            rep = nh // nkv
            kk = torch.cat([kpre, k[0]], 0).repeat_interleave(rep, 1)
            vv = torch.cat([vpre, v[0]], 0).repeat_interleave(rep, 1)
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
        o = paged_attention(q[:, 0].contiguous(), cache.k[layer],
                            cache.v[layer], cache.page_table, ctx)
        return o.reshape(B, T, nh * hd)


class FeedForward(Block):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        kw = {"use_bias": False, "flatten": False, "dtype": cfg.dtype}
        self.w1 = Dense(cfg.hidden_dim, in_units=cfg.dim, **kw)   # gate
        self.w3 = Dense(cfg.hidden_dim, in_units=cfg.dim, **kw)   # up
        self.w2 = Dense(cfg.dim, in_units=cfg.hidden_dim, **kw)   # down

    def forward(self, x):
        # the gate product in float32, as the JAX bf16 model computes it
        # (the product promotes w3's output to float32)
        return self.w2(F.activation(self.w1(x).float(), "silu")
                       * self.w3(x))


class TransformerBlock(Block):
    def __init__(self, cfg: LlamaConfig, layer_idx=0):
        super().__init__()
        if cfg.moe_num_experts > 0:
            raise NotImplementedError("mxnet_tpu_torch: the MoE FFN is "
                                      "not ported yet")
        self.attention_norm = RMSNorm(cfg.dim, epsilon=cfg.norm_eps)
        self.attention = Attention(cfg, layer_idx=layer_idx)
        self.ffn_norm = RMSNorm(cfg.dim, epsilon=cfg.norm_eps)
        self.feed_forward = FeedForward(cfg)

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
        blocks = []
        for i in range(cfg.n_layers):
            blk = TransformerBlock(cfg, layer_idx=i)
            setattr(self, "layer%d" % i, blk)   # keys layer0.*, as in JAX
            blocks.append(blk)
        self.layers = tuple(blocks)
        self.norm = RMSNorm(cfg.dim, epsilon=cfg.norm_eps)
        self.output = Dense(cfg.vocab_size, in_units=cfg.dim, use_bias=False,
                            flatten=False, dtype=cfg.dtype)
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
        h = self.tok_embeddings(tokens).float()   # the residual stream
        for blk in self.layers:
            h = blk(h, cache=cache)
        return self.output(self.norm(h))
