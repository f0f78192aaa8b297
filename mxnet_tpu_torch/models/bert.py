"""BERT encoder and its pretraining heads.

Counterpart of ``mxnet_tpu/models/bert.py:22-181``: ``BertConfig``,
``bert_base_config``, ``bert_tiny_config``, ``BertSelfAttention``,
``BertLayer``, ``BERTModel`` and ``BERTForPretrain``, with the same
module tree and so the same parameter names.  Post-LN layers, erf GELU
FFN, MLM and NSP heads.

Attention without ``valid_length`` goes through the flash kernel
(``cuda_ops.flash_attention``, non-causal), as the JAX model's goes to
the Pallas kernel (:80); on CUDA that needs bf16 q/k/v with head_dim 64
or 128 (BERT-base: 12 heads of 64), and its backward runs the flash
backward kernels.  With ``valid_length`` it goes through
``ops.nn.dot_product_attention`` with the padding mask (:74-77).

Precision for a bf16 config follows the JAX model's parameter dtypes:
Dense and Embedding weights are bf16, LayerNorm gains float32, so the
residual stream after each norm is float32 and every matmul takes bf16
operands (``Dense`` casts its input).

Layers are made without a device: ``initialize(device=...)`` (or a
loader after it) places them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..gluon.block import HybridBlock
from ..gluon.nn import Dense, Dropout, Embedding, LayerNorm
from ..ops import nn as F
from ..ops.cuda_ops import flash_attention

__all__ = ["BertConfig", "bert_base_config", "bert_tiny_config",
           "BertSelfAttention", "BertLayer", "BERTModel", "BERTForPretrain"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    dtype: str = "float32"


def bert_base_config(**over):
    cfg = BertConfig()
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def bert_tiny_config(**over):
    cfg = BertConfig(vocab_size=1024, hidden_size=128, num_layers=2,
                     num_heads=4, intermediate_size=256,
                     max_position_embeddings=128)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def _dense(cfg, units, in_units, **kw):
    return Dense(units, flatten=False, in_units=in_units, dtype=cfg.dtype,
                 **kw)


class BertSelfAttention(HybridBlock):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.qkv = _dense(cfg, 3 * h, h)
        self.out = _dense(cfg, h, h)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, mask=None):
        B, T, H = x.shape
        nh = self.cfg.num_heads
        # one qkv projection split into (B, nh, T, hd) heads; the kernel
        # takes contiguous q/k/v
        q, k, v = (t.transpose(1, 2).contiguous() for t in
                   self.qkv(x).view(B, T, 3, nh, H // nh).unbind(2))
        if mask is not None:
            o = F.dot_product_attention(q, k, v,
                                        mask=mask[:, None, None, :].bool())
        else:
            o = flash_attention(q, k, v, causal=False)
        return self.dropout(self.out(o.transpose(1, 2).reshape(B, T, H)))


class BertLayer(HybridBlock):
    def __init__(self, cfg):
        super().__init__()
        self.attention = BertSelfAttention(cfg)
        self.attn_norm = LayerNorm(epsilon=cfg.layer_norm_eps,
                                   in_channels=cfg.hidden_size)
        self.inter = _dense(cfg, cfg.intermediate_size, cfg.hidden_size)
        self.output = _dense(cfg, cfg.hidden_size, cfg.intermediate_size)
        self.out_norm = LayerNorm(epsilon=cfg.layer_norm_eps,
                                  in_channels=cfg.hidden_size)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, mask=None):
        x = self.attn_norm(x + self.attention(x, mask))
        h = F.activation(self.inter(x), "gelu")
        return self.out_norm(x + self.dropout(self.output(h)))


class BERTModel(HybridBlock):
    """Encoder: ``(tokens, token_types=None, valid_length=None)`` ->
    (sequence output (B, T, hidden), pooled output (B, hidden))."""

    def __init__(self, cfg: BertConfig = None, **kwargs):
        super().__init__()
        cfg = cfg or BertConfig(**kwargs)
        self.cfg = cfg
        self.word_embed = Embedding(cfg.vocab_size, cfg.hidden_size,
                                    dtype=cfg.dtype)
        self.token_type_embed = Embedding(cfg.type_vocab_size,
                                          cfg.hidden_size, dtype=cfg.dtype)
        self.position_embed = Embedding(cfg.max_position_embeddings,
                                        cfg.hidden_size, dtype=cfg.dtype)
        self.embed_norm = LayerNorm(epsilon=cfg.layer_norm_eps,
                                    in_channels=cfg.hidden_size)
        self.embed_dropout = Dropout(cfg.dropout)
        layers = []
        for i in range(cfg.num_layers):
            layer = BertLayer(cfg)
            setattr(self, "layer%d" % i, layer)    # keys layer0.*, as in JAX
            layers.append(layer)
        self.layers = tuple(layers)
        self.pooler = _dense(cfg, cfg.hidden_size, cfg.hidden_size,
                             activation="tanh")

    def forward(self, tokens, token_types=None, valid_length=None):
        B, T = tokens.shape
        pos = torch.arange(T, device=tokens.device).expand(B, T)
        emb = self.word_embed(tokens) + self.position_embed(pos)
        if token_types is not None:
            emb = emb + self.token_type_embed(token_types)
        h = self.embed_dropout(self.embed_norm(emb))
        mask = None
        if valid_length is not None:
            mask = torch.arange(T, device=tokens.device)[None, :] \
                < valid_length[:, None]
        for layer in self.layers:
            h = layer(h, mask)
        return h, self.pooler(h[:, 0])


class BERTForPretrain(HybridBlock):
    """MLM + NSP heads: -> (MLM logits (B, T, vocab), NSP logits (B, 2))."""

    def __init__(self, cfg: BertConfig = None, **kwargs):
        super().__init__()
        self.bert = BERTModel(cfg, **kwargs)
        cfg = self.bert.cfg
        self.mlm_transform = _dense(cfg, cfg.hidden_size, cfg.hidden_size)
        self.mlm_norm = LayerNorm(epsilon=cfg.layer_norm_eps,
                                  in_channels=cfg.hidden_size)
        self.mlm_decoder = _dense(cfg, cfg.vocab_size, cfg.hidden_size)
        self.nsp = _dense(cfg, 2, cfg.hidden_size)

    def forward(self, tokens, token_types=None, valid_length=None):
        seq, pooled = self.bert(tokens, token_types, valid_length)
        h = self.mlm_norm(F.activation(self.mlm_transform(seq), "gelu"))
        return self.mlm_decoder(h), self.nsp(pooled)
