"""BERT for extractive QA in PyTorch (counterpart of
bert_pytorch_tpu/models/bert.py, deterministic forward only).

Numerics follow the JAX model: parameters stay f32 and are cast to the
compute dtype at use (bf16 by default); LayerNorm statistics and attention
softmax are f32; the residual add before each LayerNorm happens in the
compute dtype; the QA logits come out f32. The encoder is an
`nn.ModuleList` of layers, and the QKV projection is one (E -> 3 * H * D)
Linear whose output splits as the JAX kernel's (3, H, D) features.

`plain=True` builds the same model with every kernel call replaced by the
kernel's plain PyTorch version: a reference to hold the kernels against on
the card, never a route a served model takes.

Shape glossary: B batch, S sequence, H heads, D head_dim, E hidden.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.ops.activations import ACT2FN
from bert_pytorch_tpu_torch.ops.attention import (dot_product_attention,
                                                  make_attention_bias)
from bert_pytorch_tpu_torch.ops.layernorm import layer_norm, layer_norm_ref


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """A Linear in x's dtype with f32 parameters cast at use."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class LayerNorm(nn.Module):
    """Affine LayerNorm, eps 1e-12, f32 `scale` and `bias` (the flax names)."""

    def __init__(self, dim: int, eps: float = 1e-12, plain: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.plain = plain

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = layer_norm_ref if self.plain else layer_norm
        return fn(x, self.scale, self.bias, self.eps)


class ResidualLayerNorm(LayerNorm):
    """LN(residual + x), the add in the compute dtype: the deterministic
    form of the JAX model's ResidualDropoutLayerNorm."""

    def forward(self, x: torch.Tensor,  # type: ignore[override]
                residual: torch.Tensor) -> torch.Tensor:
        return super().forward(residual + x)


class BertEmbeddings(nn.Module):
    """word + position (+ token-type iff next_sentence) embeddings, then
    LayerNorm. `position_ids` resets positions per packed segment."""

    def __init__(self, config: BertConfig, plain: bool = False):
        super().__init__()
        e = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, e)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, e)
        self.token_type_embeddings = (
            nn.Embedding(config.type_vocab_size, e)
            if config.next_sentence else None)
        self.layer_norm = LayerNorm(e, plain=plain)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor],
                position_ids: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)[None, :]
        # gather in f32 then cast: the same values as casting the table
        x = (self.word_embeddings(input_ids).to(dtype)
             + self.position_embeddings(position_ids).to(dtype))
        if self.token_type_embeddings is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + self.token_type_embeddings(token_type_ids).to(dtype)
        return self.layer_norm(x)


class BertSelfAttention(nn.Module):
    """Fused QKV projection -> attention -> output projection."""

    def __init__(self, config: BertConfig, plain: bool = False):
        super().__init__()
        self.n_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        e = config.hidden_size
        self.qkv = nn.Linear(e, 3 * self.n_heads * self.head_dim)
        self.output = nn.Linear(self.n_heads * self.head_dim, e)
        self.plain = plain

    def forward(self, hidden: torch.Tensor, attention_bias: torch.Tensor,
                segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, _ = hidden.shape
        qkv = _linear(hidden, self.qkv).view(b, s, 3, self.n_heads,
                                             self.head_dim)
        # strided views: the flash kernel reads them in place
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        ctx = dot_product_attention(q, k, v, attention_bias, segment_ids,
                                    plain=self.plain)
        return _linear(ctx.reshape(b, s, -1), self.output)


class BertLayer(nn.Module):
    """attention -> add&LN -> MLP -> add&LN."""

    def __init__(self, config: BertConfig, plain: bool = False):
        super().__init__()
        e = config.hidden_size
        self.attention = BertSelfAttention(config, plain=plain)
        self.attention_layer_norm = ResidualLayerNorm(e, plain=plain)
        self.intermediate = nn.Linear(e, config.intermediate_size)
        self.mlp_output = nn.Linear(config.intermediate_size, e)
        self.output_layer_norm = ResidualLayerNorm(e, plain=plain)
        self.act = ACT2FN[config.hidden_act]

    def forward(self, hidden: torch.Tensor, attention_bias: torch.Tensor,
                segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
        attn = self.attention(hidden, attention_bias, segment_ids)
        hidden = self.attention_layer_norm(attn, hidden)
        inter = self.act(_linear(hidden, self.intermediate))
        return self.output_layer_norm(_linear(inter, self.mlp_output), hidden)


class BertEncoder(nn.Module):
    def __init__(self, config: BertConfig, plain: bool = False):
        super().__init__()
        self.layers = nn.ModuleList(
            BertLayer(config, plain=plain)
            for _ in range(config.num_hidden_layers))

    def forward(self, hidden: torch.Tensor, attention_bias: torch.Tensor,
                segment_ids: Optional[torch.Tensor]) -> torch.Tensor:
        for layer in self.layers:
            hidden = layer(hidden, attention_bias, segment_ids)
        return hidden


class BertModel(nn.Module):
    """Embeddings -> encoder. Packed rows pass `position_ids` and
    `segment_ids` (1..n per row, 0 = pad); attention is then restricted
    to q_seg == k_seg blocks. The JAX model's NSP pooler is not built: the
    QA head never reads it (models/convert.py drops its parameters)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.bfloat16,
                 plain: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = BertEmbeddings(config, plain=plain)
        self.encoder = BertEncoder(config, plain=plain)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S, E) sequence output in the compute dtype."""
        if attention_mask is None:
            attention_mask = (segment_ids > 0 if segment_ids is not None
                              else torch.ones_like(input_ids))
        bias = make_attention_bias(attention_mask).contiguous()
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32).contiguous()
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            self.dtype)
        return self.encoder(x, bias, segment_ids)


class BertForQuestionAnswering(nn.Module):
    """Per-token (start, end) logits, f32, each (B, S)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.bfloat16,
                 plain: bool = False):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, dtype=dtype, plain=plain)
        self.qa_outputs = nn.Linear(config.hidden_size, 2)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        seq = self.bert(input_ids, token_type_ids, attention_mask,
                        position_ids, segment_ids)
        logits = _linear(seq, self.qa_outputs).float()
        return logits[..., 0], logits[..., 1]


def init_weights(model: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Random weights as the JAX model initialises them: normal(0, std)
    for Linear and Embedding weights, zero biases, unit LayerNorm scales.
    Draws from `generator` on the parameters' device, in module order."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
    return model
