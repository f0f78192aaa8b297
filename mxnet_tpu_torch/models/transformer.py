"""Llama-class transformer LM in PyTorch.

Counterpart of ``mxnet_tpu/models/transformer.py``: the same config,
module tree and parameter names (``layer0.attention.wq.weight``,
``norm.gamma``, ...), so weights cross over by name
(:func:`mxnet_tpu_torch.convert.load_params`).  Attention runs through
the port's kernels: the full-sequence forward and the serving prefill
through the flash forward, the serving decode through the paged decode
kernel; the chunk (prefix-cache) prefill is plain PyTorch, as it is
plain XLA in the JAX package.  The full-sequence forward is
differentiable end to end on both devices: on CUDA its attention
backward runs the flash backward kernels (``cuda_ops._FlashAttention``).

Precision follows what the JAX package computes for a bf16 config:
weights are bf16, but the norm gains are float32, so every activation
between matmuls -- the residual stream, the norms -- is float32 there,
while each matmul takes bf16 operands (``Dense`` casts its input) with
fp32 accumulation, and the attention kernels take bf16 q/k/v.

Not ported yet: the switch-MoE FFN (``moe_num_experts > 0``), the dense
and ring attention (``attn_impl`` other than ``"flash"``; on the CPU the
flash wrapper already runs the plain dense version) and the sharding
hints.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

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
    attn_impl: str = "flash"  # the only one ported
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


def _rope(x, positions, theta):
    """Rotary embedding on (B, T, H, D), split-half form (the first and
    second halves of D are the pair, not even/odd lanes).
    ``positions`` is (T,) shared across the batch or (B, T) per row --
    the decode path passes each slot's own cache length."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs      # (B, T, d/2)
    cos = angles.cos()[:, :, None, :]
    sin = angles.sin()[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _heads_first(x):
    """(B, T, H, D) -> contiguous (B, H, T, D), the kernels' layout."""
    return x.transpose(1, 2).contiguous()


class Attention(Block):
    def __init__(self, cfg: LlamaConfig, layer_idx=0, device=None):
        super().__init__()
        if cfg.attn_impl != "flash":
            raise NotImplementedError("mxnet_tpu_torch: attn_impl=%r is "
                                      "not ported (flash only)"
                                      % cfg.attn_impl)
        device = resolve_device(device)
        self.cfg = cfg
        self.layer_idx = layer_idx
        hd = cfg.dim // cfg.n_heads
        self.head_dim = hd
        kw = {"use_bias": False, "dtype": cfg.dtype, "device": device}
        self.wq = Dense(cfg.n_heads * hd, cfg.dim, **kw)
        self.wk = Dense(cfg.n_kv_heads * hd, cfg.dim, **kw)
        self.wv = Dense(cfg.n_kv_heads * hd, cfg.dim, **kw)
        self.wo = Dense(cfg.dim, cfg.n_heads * hd, **kw)

    def forward(self, x, cache=None):
        cfg = self.cfg
        B, T, _ = x.shape
        hd, nh, nkv = self.head_dim, cfg.n_heads, cfg.n_kv_heads
        q = self.wq(x).view(B, T, nh, hd)
        k = self.wk(x).view(B, T, nkv, hd)
        v = self.wv(x).view(B, T, nkv, hd)
        if cache is not None:
            return self.wo(self._forward_cached(q, k, v, cache))
        pos = torch.arange(T, device=x.device)
        q = _rope(q, pos, cfg.rope_theta)
        k = _rope(k, pos, cfg.rope_theta)
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
        cache.  The pools on ``cache`` are updated in place."""
        cfg = self.cfg
        B, T = q.shape[0], q.shape[1]
        hd, nh, nkv = self.head_dim, cfg.n_heads, cfg.n_kv_heads
        theta, layer, psz = cfg.rope_theta, self.layer_idx, cache.page_size
        dev = q.device
        if cache.mode == "prefill":
            pos = torch.arange(T, device=dev)
            q, k = _rope(q, pos, theta), _rope(k, pos, theta)
            _kvc.write_prompt(cache.k, layer, cache.page_row, k[0],
                              cache.true_len, psz)
            _kvc.write_prompt(cache.v, layer, cache.page_row, v[0],
                              cache.true_len, psz)
            o = flash_attention(_heads_first(q), _heads_first(k),
                                _heads_first(v), causal=True)
            return o.transpose(1, 2).reshape(B, T, nh * hd)
        if cache.mode == "chunk":
            start = cache.start
            pos = start + torch.arange(T, device=dev)
            q, k = _rope(q, pos, theta), _rope(k, pos, theta)
            _kvc.write_chunk(cache.k, layer, cache.page_row, k[0],
                             cache.true_len, psz, start)
            _kvc.write_chunk(cache.v, layer, cache.page_row, v[0],
                             cache.true_len, psz, start)
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
            kpos = torch.arange(MP * psz, device=dev)
            pmask = (kpos[None, :] < start).expand(T, MP * psz)
            cmask = pos[None, :] <= pos[:, None]      # causal over chunk
            mask = torch.cat([pmask, cmask], 1)
            scores = scores.masked_fill(~mask[None], -1e30)
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum("nts,snd->tnd", probs, vv.float())
            return o.to(v.dtype).reshape(B, T, nh * hd)
        lengths = cache.lengths
        pos = lengths.long()[:, None]                 # (S, 1)
        q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        _kvc.write_token(cache.k, layer, cache.page_table, lengths, k[:, 0],
                         cache.active, psz)
        _kvc.write_token(cache.v, layer, cache.page_table, lengths, v[:, 0],
                         cache.active, psz)
        ctx = torch.where(cache.active, lengths + 1, lengths)
        o = paged_attention(q[:, 0].contiguous(), cache.k[layer],
                            cache.v[layer], cache.page_table, ctx)
        return o.reshape(B, T, nh * hd)


class FeedForward(Block):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        kw = {"use_bias": False, "dtype": cfg.dtype,
              "device": resolve_device(device)}
        self.w1 = Dense(cfg.hidden_dim, cfg.dim, **kw)   # gate
        self.w3 = Dense(cfg.hidden_dim, cfg.dim, **kw)   # up
        self.w2 = Dense(cfg.dim, cfg.hidden_dim, **kw)   # down

    def forward(self, x):
        # the gate product in float32, as the JAX bf16 model computes it
        return self.w2(F.activation(self.w1(x).float(), "silu")
                       * self.w3(x).float())


class TransformerBlock(Block):
    def __init__(self, cfg: LlamaConfig, layer_idx=0, device=None):
        super().__init__()
        if cfg.moe_num_experts > 0:
            raise NotImplementedError("mxnet_tpu_torch: the MoE FFN is "
                                      "not ported yet")
        device = resolve_device(device)
        kw = {"epsilon": cfg.norm_eps, "device": device}
        self.attention_norm = RMSNorm(cfg.dim, **kw)
        self.attention = Attention(cfg, layer_idx=layer_idx, device=device)
        self.ffn_norm = RMSNorm(cfg.dim, **kw)
        self.feed_forward = FeedForward(cfg, device=device)

    def forward(self, x, cache=None):
        """``x`` is the float32 residual stream."""
        x = x + self.attention(self.attention_norm(x), cache=cache).float()
        return x + self.feed_forward(self.ffn_norm(x)).float()


class TransformerLM(Block):
    """Decoder-only LM.  Input: (B, T) int tokens; output: (B, T, vocab).

    ``device=None`` means CUDA (and raises without a card); pass
    ``device="cpu"`` for the plain path.  Parameters are created
    uninitialized: fill them with :meth:`initialize` or
    :func:`mxnet_tpu_torch.convert.load_params`."""

    def __init__(self, cfg: LlamaConfig = None, device=None, **kwargs):
        super().__init__()
        cfg = cfg or LlamaConfig(**kwargs)
        device = resolve_device(device)
        self.cfg = cfg
        self.tok_embeddings = Embedding(cfg.vocab_size, cfg.dim,
                                        dtype=cfg.dtype, device=device)
        blocks = []
        for i in range(cfg.n_layers):
            blk = TransformerBlock(cfg, layer_idx=i, device=device)
            setattr(self, "layer%d" % i, blk)   # keys layer0.*, as in JAX
            blocks.append(blk)
        self.layers = tuple(blocks)
        self.norm = RMSNorm(cfg.dim, epsilon=cfg.norm_eps, device=device)
        self.output = Dense(cfg.vocab_size, cfg.dim, use_bias=False,
                            dtype=cfg.dtype, device=device)

    @torch.no_grad()
    def initialize(self, generator, std=0.02):
        """Weights from N(0, std) drawn from ``generator`` (which must
        live on the parameters' device), norm gains 1."""
        for name, p in self.named_parameters():
            if name.endswith("gamma"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
        return self

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
