"""BERT in PyTorch: the encoder, the task heads (QA, token and sequence
classification, multiple choice, sentence embedding) and the pretraining
heads (counterpart of bert_pytorch_tpu/models/bert.py).

Numerics follow the JAX model: parameters stay f32 and are cast to the
compute dtype at use (bf16 by default); LayerNorm statistics and attention
softmax are f32; the QA and NSP logits come out f32, and the tied MLM
decoder computes f32 logits from compute-dtype operands. The encoder is an
`nn.ModuleList` of layers (the JAX package's unstacked layout), and the
QKV projection is one (E -> 3 * H * D) Linear whose output splits as the
JAX kernel's (3, H, D) features.

Training: `dropout_seeds`, an int32 tensor of 1 + 3L seeds on the host,
turns dropout on; None is the deterministic (eval and serving) forward.
The JAX model draws one seed per dropout site per micro-step, in this
order: the embeddings, then for each layer the attention probabilities,
the attention tail and the MLP tail. Every site uses a counter-hash
mask: `hash_dropout` at the embeddings and at the attention probabilities
of plain attention, the flash kernels' own mask at the attention
probabilities where attention takes the flash route (seq > 256 and a
multiple of 128: phase 2's 512, SQuAD's 384), the fused
residual-dropout-LayerNorm kernel at both residual tails. The token
and sequence classification and the multiple-choice heads add one site
after the encoder (2 + 3L seeds); the embedding head adds none.

Taps (distillation's layer-matched losses, training/distill.py): a task
head called with `return_taps=True` returns `(outputs, taps)`, `taps` a
list of one dict a layer, {"attention_out": the attention residual tail's
LayerNorm output, "mlp_out": the layer's output}, each (B, S, E) in the
compute dtype: the two points the JAX model sows under `debug_taps`.
Without the flag the forward is unchanged.

K-FAC's taps (`config.kfac_taps`, optim/kfac.py): the pretraining head
called with `kfac=KFACTaps()` records, for each tapped Linear (the four of
every layer: `attention.qkv`, `attention.output`, `intermediate`,
`mlp_output`; the pooler's `dense`; `cls_seq_relationship`), its input,
and adds a zero tensor to its output whose gradient is the loss's
gradient with respect to that output (the JAX model's sow and perturb).
They are K-FAC's own, apart from the distillation taps above.

Activation checkpointing (`config.checkpoint_activations`, training
only: a forward under grad): each encoder layer runs under
`torch.utils.checkpoint` (non-reentrant), by `config.remat_policy` as the
JAX model's nn.remat policies: "nothing" recomputes the whole layer in the
backward pass, "dots" keeps the cuBLAS products' outputs and recomputes
the rest (selective checkpointing, whose policy sees dispatcher ops: the
hand-written kernels are recomputed with everything else), "mlp_only"
recomputes only the (B, S, I) up-projection and its activation. The
recomputed forward takes the same parameter tensors and the same dropout
seeds, so it draws the same masks and the gradients are the bits of the
run without it; each kernel launch of the recompute counts in
`ops/kernels.LAUNCHES` as any other.

`plain=True` builds the same model with every kernel call replaced by the
kernel's plain PyTorch version, differentiated by autograd: a reference to
hold the kernels against on the card, never a route a run takes.

Shape glossary: B batch, S sequence, H heads, D head_dim, E hidden,
P masked positions per row, V vocab, G packed segments per row, C
choices.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from bert_pytorch_tpu_torch.config import BertConfig
from bert_pytorch_tpu_torch.models.losses import segment_onehot
from bert_pytorch_tpu_torch.ops.activations import ACT2FN
from bert_pytorch_tpu_torch.ops.attention import (dot_product_attention,
                                                  hash_dropout, keep_dropout,
                                                  make_attention_bias)
from bert_pytorch_tpu_torch.ops.layernorm import (add_dropout_layer_norm,
                                                  add_dropout_layer_norm_ref,
                                                  adln_shard_seed,
                                                  layer_norm, layer_norm_ref)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """A Linear in x's dtype with f32 parameters cast at use (a no-op cast
    for the weights `cast_for_serving` already holds in x's dtype)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def _row_linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`_linear` for a head of a few outputs, as one f32 product-sum a
    output over the last axis (plus the bias, rounded once to x's dtype,
    as the GEMM's epilogue rounds): each row's sum runs in the same order
    wherever the row sits in the batch. cuBLAS's GEMM at N = 2 does not:
    the same row read one bf16 ulp apart packed and alone on the card
    (PERF.md, ROADMAP queue C item 2), so the QA head takes this route."""
    w = layer.weight.to(x.dtype).float()
    xf = x.float()
    out = torch.stack([(xf * w[i]).sum(-1) for i in range(w.shape[0])], -1)
    return (out + layer.bias.to(x.dtype).float()).to(x.dtype)


class KFACTaps:
    """K-FAC's taps of one microbatch's forward. Each tapped Linear calls
    `taps(site, x, y)` with its input `x` and output `y` and goes on with
    the result, `y` plus a zero tensor that requires grad (`perts[site]`):
    the loss's gradient with respect to it is the gradient with respect
    to the Linear's output, from the same backward pass as the
    parameters' (JAX's flax `perturb`). `acts[site]` keeps `x`, detached,
    in the compute dtype. A site records once: the recompute of an
    activation-checkpointed region calls it again and gets the same
    perturbation back, so the statistics equal those of the run without
    remat. `site` is the Linear's module name (`kfac_site`, set by
    `name_kfac_sites`)."""

    def __init__(self):
        self.acts: Dict[str, torch.Tensor] = {}
        self.perts: Dict[str, torch.Tensor] = {}

    def __call__(self, site: str, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        pert = self.perts.get(site)
        if pert is None:
            self.acts[site] = x.detach()
            pert = torch.zeros_like(y, requires_grad=True)
            self.perts[site] = pert
        return y + pert


def _tap(kfac: Optional[KFACTaps], layer: nn.Linear, x: torch.Tensor,
         y: torch.Tensor) -> torch.Tensor:
    """y = layer(x) through K-FAC's taps when they are on."""
    return y if kfac is None else kfac(layer.kfac_site, x, y)


def name_kfac_sites(model: nn.Module) -> List[str]:
    """Name each K-FAC-tapped Linear of `model` by its module name (its
    `kfac_site`, which its parameters' names extend with .weight and
    .bias); returns the sites in module order."""
    sites = []
    for name, mod in model.named_modules():
        if getattr(mod, "kfac_tapped", False):
            mod.kfac_site = name
            sites.append(name)
    return sites


def _tapped(layer: nn.Linear) -> nn.Linear:
    layer.kfac_tapped = True
    return layer


def cast_for_serving(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Hold every Linear weight and bias and every Embedding table of a
    served model in `dtype`, cast once: the same values the casts at use
    give (`_linear`, the embedding gathers), so the outputs are the same
    bits, without a cast of each weight in every forward. LayerNorm
    scales and biases stay f32, as the LayerNorm kernels take them. A
    no-op for f32."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                for name, p in list(mod.named_parameters(recurse=False)):
                    if p.dtype != dtype:
                        setattr(mod, name, nn.Parameter(
                            p.to(dtype), requires_grad=False))
    return model


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


class ResidualDropoutLayerNorm(LayerNorm):
    """LN(residual + dropout(x)), the tail of both residual sites in every
    layer. Deterministic (no seed) or at rate 0: LN(residual + x) with the
    add in the compute dtype. Training: the fused kernel, which adds in
    f32 after dropping x with the counter-hash mask of `seed`."""

    # the data-parallel shard this replica trains (set_dropout_shard)
    dropout_shard = 0

    def __init__(self, dim: int, rate: float, eps: float = 1e-12,
                 plain: bool = False):
        super().__init__(dim, eps, plain)
        self.rate = rate

    def forward(self, x: torch.Tensor,  # type: ignore[override]
                residual: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        if seed is None or self.rate == 0.0:
            return super().forward(residual + x)
        if self.dropout_shard:
            if x.shape[-1] % 128:
                from bert_pytorch_tpu_torch import PARALLEL_GAPS

                # JAX runs this width through its XLA path, whose
                # global-view mask the kernel's hash cannot offset
                raise NotImplementedError(
                    f"residual dropout at width {x.shape[-1]} (not a "
                    "multiple of 128) on a data-parallel shard is not "
                    f"ported yet (see {PARALLEL_GAPS})")
            seed = adln_shard_seed(seed, self.dropout_shard)
        fn = add_dropout_layer_norm_ref if self.plain else add_dropout_layer_norm
        return fn(x, residual, self.scale, self.bias, seed, self.rate,
                  self.eps)


def _select_rows(table: torch.Tensor, ids: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """`table[ids]` in `dtype`, as a one-hot product: the same values as
    the gather (one exact product a position), and a backward that is a
    matmul summed in a fixed order. The embedding backward on the card
    sums the thousands of tokens each row of a 2-row table receives in an
    order that changes from run to run (PERF.md, ROADMAP queue C item 1),
    so the token-type table takes this route."""
    onehot = ids.long()[..., None] == torch.arange(
        table.shape[0], device=ids.device)
    return torch.matmul(onehot.to(dtype), table.to(dtype))


class BertEmbeddings(nn.Module):
    """word + position (+ token-type iff next_sentence) embeddings, then
    LayerNorm and (training) hash dropout. `position_ids` resets positions
    per packed segment."""

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
        self.rate = config.hidden_dropout_prob

    # the data-parallel shard this replica trains (set_dropout_shard)
    dropout_shard = 0

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor],
                position_ids: Optional[torch.Tensor],
                dtype: torch.dtype,
                seed: Optional[int] = None) -> torch.Tensor:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)[None, :]
        # gather in f32 then cast: the same values as casting the table
        x = (self.word_embeddings(input_ids).to(dtype)
             + self.position_embeddings(position_ids).to(dtype))
        if self.token_type_embeddings is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            x = x + _select_rows(self.token_type_embeddings.weight,
                                 token_type_ids, dtype)
        x = self.layer_norm(x)
        if seed is not None and self.rate > 0.0:
            x = hash_dropout(x, seed, self.rate,
                             self.dropout_shard * x.shape[0] * x.shape[1])
        return x


class BertSelfAttention(nn.Module):
    """Fused QKV projection -> attention -> output projection."""

    def __init__(self, config: BertConfig, plain: bool = False):
        super().__init__()
        self.n_heads = config.num_attention_heads
        self.head_dim = config.head_dim
        e = config.hidden_size
        self.qkv = _tapped(nn.Linear(e, 3 * self.n_heads * self.head_dim))
        self.output = _tapped(nn.Linear(self.n_heads * self.head_dim, e))
        self.rate = config.attention_probs_dropout_prob
        self.plain = plain

    # the data-parallel shard this replica trains (set_dropout_shard)
    dropout_shard = 0

    def forward(self, hidden: torch.Tensor, attention_bias: torch.Tensor,
                segment_ids: Optional[torch.Tensor],
                seed: Optional[int] = None,
                kfac: Optional[KFACTaps] = None) -> torch.Tensor:
        b, s, _ = hidden.shape
        qkv = _tap(kfac, self.qkv, hidden, _linear(hidden, self.qkv))
        qkv = qkv.view(b, s, 3, self.n_heads, self.head_dim)
        # strided views: the flash kernel reads them in place
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        ctx = dot_product_attention(q, k, v, attention_bias, segment_ids,
                                    plain=self.plain, dropout_seed=seed,
                                    dropout_rate=self.rate,
                                    dropout_shard=self.dropout_shard)
        ctx = ctx.reshape(b, s, -1)
        return _tap(kfac, self.output, ctx, _linear(ctx, self.output))


def _mlp(act, hidden: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
         w_out: torch.Tensor, b_out: torch.Tensor,
         kfac: Optional[KFACTaps] = None, sites=(None, None)
         ) -> torch.Tensor:
    """The MLP's up-projection, activation and down-projection from its
    four parameter tensors (`_linear`'s casts at use); with `kfac`, both
    products tapped as `sites` (up, down)."""
    dt = hidden.dtype
    inter = F.linear(hidden, w_in.to(dt), b_in.to(dt))
    if kfac is not None:
        inter = kfac(sites[0], hidden, inter)
    inter = act(inter)
    out = F.linear(inter, w_out.to(dt), b_out.to(dt))
    return out if kfac is None else kfac(sites[1], inter, out)


# The dispatcher ops whose outputs remat_policy "dots" keeps: the cuBLAS
# products (F.linear and einsum reach these); every other op, the
# hand-written kernels' launches included, is recomputed.
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                      torch.ops.aten.bmm.default,
                      torch.ops.aten.baddbmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, *tensors: torch.Tensor, policy: str = "nothing"):
    """fn(*tensors) under non-reentrant activation checkpointing. `fn`
    must reach every tensor it uses through its arguments: the recompute
    runs in the backward pass, after `functional_call` has put the
    module's own parameters back."""
    kw: Dict[str, Any] = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    # the dropout masks are counter hashes of explicit seeds: no RNG state
    # to stash
    return checkpoint(fn, *tensors, use_reentrant=False,
                      preserve_rng_state=False, **kw)


class BertLayer(nn.Module):
    """attention -> add&LN -> MLP -> add&LN. `remat_mlp` (remat_policy
    "mlp_only"): in training the MLP runs under activation checkpointing,
    so its (B, S, I) activations are recomputed, not kept."""

    def __init__(self, config: BertConfig, plain: bool = False,
                 remat_mlp: bool = False):
        super().__init__()
        e = config.hidden_size
        rate = config.hidden_dropout_prob
        self.attention = BertSelfAttention(config, plain=plain)
        self.attention_layer_norm = ResidualDropoutLayerNorm(e, rate,
                                                             plain=plain)
        self.intermediate = _tapped(nn.Linear(e, config.intermediate_size))
        self.mlp_output = _tapped(nn.Linear(config.intermediate_size, e))
        self.output_layer_norm = ResidualDropoutLayerNorm(e, rate,
                                                          plain=plain)
        self.act = ACT2FN[config.hidden_act]
        self.remat_mlp = remat_mlp

    def forward(self, hidden: torch.Tensor, attention_bias: torch.Tensor,
                segment_ids: Optional[torch.Tensor],
                seeds: Sequence[Optional[int]] = (None, None, None),
                taps: Optional[List[Dict[str, torch.Tensor]]] = None,
                kfac: Optional[KFACTaps] = None) -> torch.Tensor:
        """`seeds`: (attention probabilities, attention tail, MLP tail).
        `taps`, when given, receives this layer's tap dict; `kfac`,
        K-FAC's taps of its four Linears."""
        attn = self.attention(hidden, attention_bias, segment_ids, seeds[0],
                              kfac)
        hidden = self.attention_layer_norm(attn, hidden, seeds[1])
        weights = (self.intermediate.weight, self.intermediate.bias,
                   self.mlp_output.weight, self.mlp_output.bias)
        mlp_fn = functools.partial(_mlp, self.act)
        if kfac is not None:
            mlp_fn = functools.partial(
                mlp_fn, kfac=kfac, sites=(self.intermediate.kfac_site,
                                          self.mlp_output.kfac_site))
        if self.remat_mlp and torch.is_grad_enabled():
            mlp = _remat(mlp_fn, hidden, *weights)
        else:
            mlp = mlp_fn(hidden, *weights)
        out = self.output_layer_norm(mlp, hidden, seeds[2])
        if taps is not None:
            taps.append({"attention_out": hidden, "mlp_out": out})
        return out


class BertEncoder(nn.Module):
    """The layers in turn; under `config.checkpoint_activations` with the
    policy "nothing" or "dots", each layer in training runs as one
    checkpointed region (module docstring)."""

    def __init__(self, config: BertConfig, plain: bool = False):
        super().__init__()
        remat = config.checkpoint_activations
        self.remat_policy = config.remat_policy if remat else None
        self.layers = nn.ModuleList(
            BertLayer(config, plain=plain,
                      remat_mlp=self.remat_policy == "mlp_only")
            for _ in range(config.num_hidden_layers))

    def forward(self, hidden: torch.Tensor, attention_bias: torch.Tensor,
                segment_ids: Optional[torch.Tensor],
                seeds: Optional[List[int]] = None,
                taps: Optional[List[Dict[str, torch.Tensor]]] = None,
                kfac: Optional[KFACTaps] = None) -> torch.Tensor:
        whole = (self.remat_policy in ("nothing", "dots")
                 and torch.is_grad_enabled())
        for i, layer in enumerate(self.layers):
            layer_seeds = ((None, None, None) if seeds is None
                           else seeds[3 * i:3 * i + 3])
            if whole:
                hidden = self._remat_layer(layer, hidden, attention_bias,
                                           segment_ids, layer_seeds, taps,
                                           kfac)
            else:
                hidden = layer(hidden, attention_bias, segment_ids,
                               layer_seeds, taps, kfac)
        return hidden

    def _remat_layer(self, layer: BertLayer, hidden, attention_bias,
                     segment_ids, seeds, taps, kfac=None):
        """One layer as a checkpointed region. Its parameters (under
        `functional_call`, the step's compute copies) enter as inputs and
        are put back into the layer for the recompute; a tap dict comes
        out as the region's outputs, so the recompute adds none."""
        names, params = zip(*layer.named_parameters())

        def run(h, *flat):
            local = [] if taps is not None else None
            out = functional_call(layer, dict(zip(names, flat)),
                                  (h, attention_bias, segment_ids, seeds),
                                  {"taps": local, "kfac": kfac})
            if local is None:
                return out
            return out, local[0]["attention_out"]

        res = _remat(run, hidden, *params, policy=self.remat_policy)
        if taps is None:
            return res
        out, attention_out = res
        taps.append({"attention_out": attention_out, "mlp_out": out})
        return out


class BertPooler(nn.Module):
    """tanh(dense([CLS])) in the compute dtype. `positions` (B, G) gathers
    G tokens a row instead of row position 0 (each packed segment's
    [CLS]), so the pooled output is (B, G, E)."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.dense = _tapped(nn.Linear(config.hidden_size,
                                       config.hidden_size))

    def forward(self, hidden: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kfac: Optional[KFACTaps] = None) -> torch.Tensor:
        if positions is None:
            cls = hidden[:, 0]
        else:
            cls = torch.take_along_dim(hidden, positions.long()[..., None],
                                       dim=1)
        # tapped before the tanh: K-FAC's G is of the product's output
        return torch.tanh(_tap(kfac, self.dense, cls,
                               _linear(cls, self.dense)))


def set_dropout_shard(model: nn.Module, shard: int) -> nn.Module:
    """Make `model` the replica of data-parallel shard (rank) `shard`:
    each dropout site then draws what the JAX package's one-process
    data-parallel mesh draws on that shard from the same site seed. The
    fused residual-dropout-LayerNorm adds shard x 0x3C6EF35F to its seed
    (JAX's _adln_sharded); the flash kernels XOR theirs with shard x
    0x9E3779B9 (_flash_sharded); the embeddings' and plain attention's
    hash_dropout, global-view functions that GSPMD partitions over the
    batch, hash the shard's rows of the global batch (rows offset by
    shard x B x S and shard x B x H x S, B the shard's batch). Shard 0
    folds nothing, so a one-card run draws what it always drew. The
    pretraining model has no other site; the task heads' dropout is
    finetuning's, which does not run over ranks."""
    for mod in model.modules():
        if isinstance(mod, (BertEmbeddings, BertSelfAttention,
                            ResidualDropoutLayerNorm)):
            mod.dropout_shard = int(shard)
    return model


def dropout_seed_list(config: BertConfig,
                      dropout_seeds: Optional[torch.Tensor]
                      ) -> Optional[List[int]]:
    """The (1 + 3L,) int32 seed tensor as Python ints, checked: the sites
    are the embeddings, then per layer the attention probabilities, the
    attention tail and the MLP tail."""
    if dropout_seeds is None:
        return None
    seeds = [int(s) for s in dropout_seeds.reshape(-1).tolist()]
    want = 1 + 3 * config.num_hidden_layers
    if len(seeds) != want:
        raise ValueError(f"dropout_seeds holds {len(seeds)} seeds; this "
                         f"model has {want} dropout sites (1 + 3L)")
    rates = (config.hidden_dropout_prob, config.attention_probs_dropout_prob)
    if not config.fused_dropout_ln and max(rates) > 0.0:
        raise NotImplementedError(
            "training with fused_dropout_ln=False (the nn.Dropout stream) "
            "is not ported; the port's dropout is the counter-hash mask")
    return seeds


class BertModel(nn.Module):
    """Embeddings -> encoder. Packed rows pass `position_ids` and
    `segment_ids` (1..n per row, 0 = pad); attention is then restricted
    to q_seg == k_seg blocks. The NSP pooler is built iff
    `config.next_sentence`, as in the JAX model; the forward returns the
    sequence output and the pretraining head applies the pooler."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.bfloat16,
                 plain: bool = False):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = BertEmbeddings(config, plain=plain)
        self.encoder = BertEncoder(config, plain=plain)
        self.pooler = BertPooler(config) if config.next_sentence else None

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                dropout_seeds: Optional[torch.Tensor] = None,
                taps: Optional[List[Dict[str, torch.Tensor]]] = None,
                embeddings_tap: Optional[List[torch.Tensor]] = None,
                kfac: Optional[KFACTaps] = None) -> torch.Tensor:
        """(B, S, E) sequence output in the compute dtype; `taps`, when
        given, receives one tap dict a layer, `embeddings_tap` the
        embeddings' output, and `kfac` K-FAC's taps."""
        seeds = dropout_seed_list(self.config, dropout_seeds)
        if attention_mask is None:
            attention_mask = (segment_ids > 0 if segment_ids is not None
                              else torch.ones_like(input_ids))
        bias = make_attention_bias(attention_mask).contiguous()
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32).contiguous()
        x = self.embeddings(input_ids, token_type_ids, position_ids,
                            self.dtype, None if seeds is None else seeds[0])
        if embeddings_tap is not None:
            embeddings_tap.append(x)
        return self.encoder(x, bias, segment_ids,
                            None if seeds is None else seeds[1:], taps, kfac)


class BertForQuestionAnswering(nn.Module):
    """Per-token (start, end) logits, f32, each (B, S). `dropout_seeds`
    (1 + 3L, training) as BertModel takes them."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.bfloat16,
                 plain: bool = False):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, dtype=dtype, plain=plain)
        self.qa_outputs = nn.Linear(config.hidden_size, 2)
        self.n_dropout_sites = 1 + 3 * config.num_hidden_layers

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                dropout_seeds: Optional[torch.Tensor] = None,
                return_taps: bool = False):
        taps = [] if return_taps else None
        seq = self.bert(input_ids, token_type_ids, attention_mask,
                        position_ids, segment_ids, dropout_seeds, taps)
        logits = _row_linear(seq, self.qa_outputs).float()
        return _with_taps((logits[..., 0], logits[..., 1]), taps)


def _with_taps(out, taps: Optional[list]):
    """A head's output, or (output, taps) when the taps were asked for."""
    return out if taps is None else (out, taps)


def _head_seeds(dropout_seeds: Optional[torch.Tensor], n_sites: int
                ) -> Tuple[Optional[torch.Tensor], Optional[int]]:
    """(BertModel's 1 + 3L seeds, the head's seed) of a head model's
    2 + 3L seeds; (None, None) for the deterministic forward."""
    if dropout_seeds is None:
        return None, None
    flat = dropout_seeds.reshape(-1)
    if flat.numel() != n_sites:
        raise ValueError(f"dropout_seeds holds {flat.numel()} seeds; this "
                         f"model has {n_sites} dropout sites (2 + 3L)")
    return flat[:-1], int(flat[-1])


def _head_dropout(x: torch.Tensor, seed: Optional[int],
                  keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """The head's dropout site (flax nn.Dropout in the JAX heads): the mask
    `keep` when given, else `hash_dropout` from `seed`; the identity in
    the deterministic forward."""
    if seed is None or rate == 0.0:
        return x
    return (keep_dropout(x, keep, rate) if keep is not None
            else hash_dropout(x, seed, rate))


def positions_from_segment_ids(segment_ids: torch.Tensor,
                               max_segments: int) -> torch.Tensor:
    """(B, S) packed segment ids (1..G, 0 = pad) -> (B, G) row position of
    each segment's first token, the [CLS] a pooled head gathers. argmax
    takes the first maximal index, as jnp.argmax does; an empty slot
    resolves to position 0 (its output is never read)."""
    hits = segment_onehot(segment_ids, max_segments).to(torch.int32)
    return torch.argmax(hits, dim=-1).to(torch.int32)


class BertForTokenClassification(nn.Module):
    """Per-token logits (B, S, num_labels), f32: sequence output ->
    dropout -> `classifier` Linear (the NER head).

    Training takes 2 + 3L dropout seeds: BertModel's 1 + 3L, then the
    head's. The JAX head is flax `nn.Dropout`, a threefry Bernoulli mask;
    the port draws the head's mask with `hash_dropout` from its seed, or
    takes it as `head_keep` ((B, S, E) bool), an input as the seeds are,
    so a test can feed the mask flax drew."""

    def __init__(self, config: BertConfig, num_labels: int = 2,
                 dtype: torch.dtype = torch.bfloat16, plain: bool = False):
        super().__init__()
        self.config = config
        self.num_labels = num_labels
        self.bert = BertModel(config, dtype=dtype, plain=plain)
        self.classifier = nn.Linear(config.hidden_size, num_labels)
        self.n_dropout_sites = 2 + 3 * config.num_hidden_layers

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                dropout_seeds: Optional[torch.Tensor] = None,
                head_keep: Optional[torch.Tensor] = None,
                return_taps: bool = False):
        body_seeds, head_seed = _head_seeds(dropout_seeds,
                                            self.n_dropout_sites)
        taps = [] if return_taps else None
        seq = self.bert(input_ids, token_type_ids, attention_mask,
                        position_ids, segment_ids, body_seeds, taps)
        seq = _head_dropout(seq, head_seed, head_keep,
                            self.config.hidden_dropout_prob)
        return _with_taps(_linear(seq, self.classifier).float(), taps)


class BertForSequenceClassification(nn.Module):
    """Pooled [CLS] -> dropout -> `classifier` Linear: f32 logits
    (B, num_labels), or (B, G, num_labels) for packed rows, whose pooler
    gathers every segment's first token (`positions_from_segment_ids`).
    The pooler is always built (`next_sentence` forced on). Dropout
    seeds and `head_keep` ((B, E) or (B, G, E) bool) as
    BertForTokenClassification takes them."""

    def __init__(self, config: BertConfig, num_labels: int = 2,
                 max_segments: int = 8,
                 dtype: torch.dtype = torch.bfloat16, plain: bool = False):
        super().__init__()
        self.config = config.replace(next_sentence=True)
        self.num_labels = num_labels
        self.max_segments = max_segments
        self.bert = BertModel(self.config, dtype=dtype, plain=plain)
        self.classifier = nn.Linear(config.hidden_size, num_labels)
        self.n_dropout_sites = 2 + 3 * config.num_hidden_layers

    def pooled(self, input_ids, token_type_ids, attention_mask,
               position_ids, segment_ids, dropout_seeds, head_keep,
               taps=None) -> torch.Tensor:
        """The pooled output after the head's dropout."""
        body_seeds, head_seed = _head_seeds(dropout_seeds,
                                            self.n_dropout_sites)
        seq = self.bert(input_ids, token_type_ids, attention_mask,
                        position_ids, segment_ids, body_seeds, taps)
        positions = (None if segment_ids is None else
                     positions_from_segment_ids(segment_ids,
                                                self.max_segments))
        return _head_dropout(self.bert.pooler(seq, positions), head_seed,
                             head_keep, self.config.hidden_dropout_prob)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                dropout_seeds: Optional[torch.Tensor] = None,
                head_keep: Optional[torch.Tensor] = None,
                return_taps: bool = False):
        taps = [] if return_taps else None
        pooled = self.pooled(input_ids, token_type_ids, attention_mask,
                             position_ids, segment_ids, dropout_seeds,
                             head_keep, taps)
        return _with_taps(_linear(pooled, self.classifier).float(), taps)


class BertForMultipleChoice(BertForSequenceClassification):
    """One f32 score per (question, choice) row from the pooled [CLS] and a
    1-wide `classifier`. The reference-shaped (B, C, S) input is scored as
    B * C rows and comes back (B, C) (`head_keep` then (B * C, E)); a 2-D
    input gives (B,) scores, or (B, G) for packed rows, one per segment
    (serving sends one segment per choice). The same parameters either
    way."""

    def __init__(self, config: BertConfig, max_segments: int = 8,
                 dtype: torch.dtype = torch.bfloat16, plain: bool = False):
        super().__init__(config, num_labels=1, max_segments=max_segments,
                         dtype=dtype, plain=plain)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                dropout_seeds: Optional[torch.Tensor] = None,
                head_keep: Optional[torch.Tensor] = None,
                return_taps: bool = False):
        shape = input_ids.shape
        if input_ids.dim() == 3:
            b, c, s = shape

            def flat(t):
                return None if t is None else t.reshape(b * c, s)

            input_ids, token_type_ids, attention_mask = (
                flat(input_ids), flat(token_type_ids), flat(attention_mask))
            position_ids = segment_ids = None
        taps = [] if return_taps else None
        pooled = self.pooled(input_ids, token_type_ids, attention_mask,
                             position_ids, segment_ids, dropout_seeds,
                             head_keep, taps)
        scores = _linear(pooled, self.classifier)[..., 0].float()
        return _with_taps(
            scores.reshape(shape[:2]) if len(shape) == 3 else scores, taps)


class BertForSentenceEmbedding(nn.Module):
    """Mean-pooled sentence embeddings and a linear probe. The f32 mean of
    the sequence output over each example's real tokens (a mask-weighted
    f32 einsum: one (B, 1, S) mask a row, or `segment_onehot` for packed
    rows), L2-normalised with a 1e-12 floor on the squared norm; the probe
    `classifier` reads the unnormalised mean cast to the compute dtype.
    Returns (embeddings, logits): (B, E) and (B, num_labels) f32, or
    (B, G, E) and (B, G, num_labels) packed. No pooler (`next_sentence`
    forced off, so no token-type table either) and no head dropout:
    training takes BertModel's 1 + 3L seeds."""

    def __init__(self, config: BertConfig, num_labels: int = 2,
                 max_segments: int = 8, normalize: bool = True,
                 dtype: torch.dtype = torch.bfloat16, plain: bool = False):
        super().__init__()
        self.config = config.replace(next_sentence=False)
        self.num_labels = num_labels
        self.max_segments = max_segments
        self.normalize = normalize
        self.dtype = dtype
        self.bert = BertModel(self.config, dtype=dtype, plain=plain)
        self.classifier = nn.Linear(config.hidden_size, num_labels)
        self.n_dropout_sites = 1 + 3 * config.num_hidden_layers

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                dropout_seeds: Optional[torch.Tensor] = None,
                return_taps: bool = False):
        if attention_mask is None:
            attention_mask = (segment_ids > 0 if segment_ids is not None
                              else torch.ones_like(input_ids))
        taps = [] if return_taps else None
        seq = self.bert(input_ids, token_type_ids, attention_mask,
                        position_ids, segment_ids, dropout_seeds, taps)
        packed = segment_ids is not None
        onehot = (segment_onehot(segment_ids, self.max_segments) if packed
                  else (attention_mask > 0)[:, None, :]).float()
        # pad and other segments' tokens weigh exactly 0 in the sum
        sums = torch.einsum("bgs,bse->bge", onehot, seq.float())
        mean = sums / onehot.sum(-1)[..., None].clamp_min(1.0)
        emb = mean
        if self.normalize:
            emb = emb / torch.sqrt(torch.sum(emb * emb, dim=-1,
                                             keepdim=True).clamp_min(1e-12))
        logits = _linear(mean.to(self.dtype), self.classifier).float()
        if not packed:
            emb, logits = emb[:, 0], logits[:, 0]
        return _with_taps((emb, logits), taps)


class BertMLMHead(nn.Module):
    """transform (dense + act + LayerNorm), then the decoder tied to the
    word-embedding table plus a free f32 bias. The logits are f32 from
    compute-dtype operands: products of bf16 values are exact in f32, so
    an f32 product of the upcast operands (TF32 off) is the JAX einsum's
    preferred_element_type=f32 value, never rounded to bf16."""

    def __init__(self, config: BertConfig, plain: bool = False):
        super().__init__()
        e = config.hidden_size
        self.transform = nn.Linear(e, e)
        self.act = ACT2FN["gelu" if config.hidden_act == "bias_gelu"
                          else config.hidden_act]
        self.layer_norm = LayerNorm(e, plain=plain)
        self.bias = nn.Parameter(torch.zeros(config.vocab_size))

    def forward(self, hidden: torch.Tensor,
                word_embedding: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(self.act(_linear(hidden, self.transform)))
        table = word_embedding.to(x.dtype)
        return torch.matmul(x.float(), table.float().t()) + self.bias


class BertForPreTraining(nn.Module):
    """MLM + NSP heads. `masked_positions` (B, P) gathers the hidden
    states at those positions before the MLM head, so the logits are
    (B, P, V) f32 and the (B, S, V) tensor never exists; None scores every
    position. Returns (mlm_logits, nsp_logits (B, 2) f32 or None).

    Packed rows (data/packing.py) pass `position_ids`, `segment_ids` and
    `nsp_positions` (B, G): the pooler gathers each segment's [CLS], so
    the NSP logits are (B, G, 2). `return_taps=True` returns
    ((mlm_logits, nsp_logits), taps) with the bisect's tap points, taps =
    {"embeddings": (B, S, E), "layers": one {"attention_out", "mlp_out"}
    a layer, "pooler", "mlm_head", "nsp_head"}: the points the JAX model
    sows under `debug_taps`, read by tools/replay.py --bisect. Built with
    `config.kfac_taps`, it names K-FAC's sites (`kfac_sites`) and takes
    `kfac=KFACTaps()`."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.bfloat16,
                 plain: bool = False):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, dtype=dtype, plain=plain)
        self.cls_predictions = BertMLMHead(config, plain=plain)
        self.cls_seq_relationship = (
            _tapped(nn.Linear(config.hidden_size, 2))
            if config.next_sentence else None)
        self.n_dropout_sites = 1 + 3 * config.num_hidden_layers
        self.kfac_sites = (name_kfac_sites(self) if config.kfac_taps
                           else [])

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                masked_positions: Optional[torch.Tensor] = None,
                dropout_seeds: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                nsp_positions: Optional[torch.Tensor] = None,
                return_taps: bool = False,
                kfac: Optional[KFACTaps] = None):
        if kfac is not None and not self.config.kfac_taps:
            raise ValueError("K-FAC's taps need a model built with "
                             "config.kfac_taps")
        layer_taps = [] if return_taps else None
        emb_tap = [] if return_taps else None
        seq = self.bert(input_ids, token_type_ids, attention_mask,
                        position_ids, segment_ids, dropout_seeds,
                        layer_taps, emb_tap, kfac)
        hidden = seq
        if masked_positions is not None:
            index = masked_positions.long()[..., None].expand(
                -1, -1, seq.shape[-1])
            hidden = torch.gather(seq, 1, index)
        mlm_logits = self.cls_predictions(
            hidden, self.bert.embeddings.word_embeddings.weight)
        nsp_logits = pooled = None
        if self.cls_seq_relationship is not None:
            pooled = self.bert.pooler(seq, nsp_positions, kfac)
            nsp_logits = _tap(kfac, self.cls_seq_relationship, pooled,
                              _linear(pooled, self.cls_seq_relationship))
            nsp_logits = nsp_logits.float()
        if not return_taps:
            return mlm_logits, nsp_logits
        return (mlm_logits, nsp_logits), {
            "embeddings": emb_tap[0], "layers": layer_taps,
            "pooler": pooled, "mlm_head": mlm_logits,
            "nsp_head": nsp_logits}


def init_weights(model: nn.Module, generator: torch.Generator,
                 std: float = 0.02) -> nn.Module:
    """Random weights as the JAX model initialises them: normal(0, std)
    for Linear and Embedding weights, zero biases, unit LayerNorm scales
    (the MLM head's free bias stays zero). Draws from `generator` on the
    parameters' device, in module order."""
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
