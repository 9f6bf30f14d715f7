"""BERT encoder for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/bert/modeling_bert.py
(BertEmbeddings, BertAttention, BertLayer, BertEncoder, BertPooler,
BertModel, BertMLMHead, BertForMaskedLM), post-LN or, with
`pre_layer_norm=True` (MegatronBERT), pre-LN, with the same numerics:

- parameters are f32; the dense layers compute in `dtype` (bf16 by default)
  and LayerNorm in f32, casting back to `dtype`;
- attention goes through ops/attention.py, which launches the hand-written
  CUDA kernel on a card;
- erf-gelu, LayerNorm eps from the config, truncated-normal init;
- RoBERTa's position ids where the config asks for them
  (`position_ids_from_padding_idx`, RobertaConfig): the non-pad tokens
  count from pad + 1, pad positions stay at pad.

Unlike the JAX module it keeps one module per layer (an nn.ModuleList, not a
scan) and separate query/key/value projections, so parameter names are the
HF ones (`encoder.layer.{i}.attention.self.query.weight`, ...) and a
reference `pytorch_model.bin` loads with `load_state_dict(strict=True)` after
key normalisation (conversion.py). `output_hidden_states` stacks the L
layers' outputs as one [L, B, S, E] tensor, as the JAX scan collects them
(not HF's tuple of L + 1 that starts with the embeddings);
`output_attentions` stacks each layer's masked pre-softmax scores as
[L, B, H, S, S], -1e4 on masked keys, as the JAX module's explicit-scores
path gives them (not HF's probabilities). Activation checkpointing
(`--remat`) follows the JAX package's REMAT_POLICIES (below).

Pre-LN (the JAX module's `pre_layer_norm`, modeling_bert.py:157-200,
:259, :284-314) keeps HF MegatronBertModel's names: no embedding
LayerNorm, `attention.ln` before the attention, `ln` before the MLP,
residuals without a norm, and a final `encoder.ln`.
"""

import contextlib
import functools
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from easynlp_tpu_torch.modelzoo.modeling_utils import (
    one_hot_rows,
    truncated_normal_,
)
from easynlp_tpu_torch.ops.attention import attention

ACT2FN = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "relu": F.relu,
    "swish": F.silu,
    "silu": F.silu,
    "tanh": torch.tanh,
}


def dense(layer, x, dtype):
    """`layer` (an f32 nn.Linear) applied in `dtype`, as flax Dense with
    dtype=`dtype` and f32 params does."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def layer_norm(layer, x, dtype):
    """f32 LayerNorm whatever the compute dtype, cast back to `dtype`."""
    return layer(x.float()).to(dtype)


class BertEmbeddings(nn.Module):
    """Word + position (+ token-type) embeddings, then an f32 LayerNorm
    unless use_layer_norm is False (pre-LN: the first layer normalises)."""

    def __init__(self, config, dtype=torch.float32, device=None,
                 use_layer_norm=True):
        super().__init__()
        c = config
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size,
                                            device=device)
        self.position_embeddings = nn.Embedding(
            c.max_position_embeddings, c.hidden_size, device=device)
        self.token_type_embeddings = (
            nn.Embedding(c.type_vocab_size, c.hidden_size, device=device)
            if c.type_vocab_size else None)
        self.LayerNorm = (nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                       device=device)
                          if use_layer_norm else None)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids, position_ids,
                one_hot_positions=False):
        """one_hot_positions: the position rows by one-hot contraction
        (modeling_utils.one_hot_rows: the same values, a fixed-order
        backward), for position ids that repeat thousands of times."""
        positions = (one_hot_rows(position_ids,
                                  self.position_embeddings.weight)
                     if one_hot_positions
                     else self.position_embeddings(position_ids))
        emb = self.word_embeddings(input_ids) + positions
        if self.token_type_embeddings is not None:
            emb = emb + self.token_types(token_type_ids)
        if self.LayerNorm is not None:
            # f32 LayerNorm: the sum is bf16 when serving casts the tables
            emb = self.LayerNorm(emb.float())
        return self.dropout(emb).to(self.dtype)

    def token_types(self, token_type_ids):
        """The token-type rows of the ids, selected type by type with
        torch.where: exact, and its gradient is a sum over each type's
        positions in a fixed order. (nn.Embedding's CUDA backward sums a row
        that thousands of positions share, as type 0 is, in an order that
        changes from run to run, so two runs of one training step would
        not give the same bits.)"""
        table = self.token_type_embeddings.weight
        out = table[0].expand(*token_type_ids.shape, table.shape[1])
        for t in range(1, table.shape[0]):
            out = torch.where((token_type_ids == t)[..., None], table[t], out)
        return out


class BertSelfAttention(nn.Module):
    """The q/k/v projections (HF's `attention.self`), `width` wide (the
    hidden size unless given: Kangaroo's entity stream is narrower)."""

    def __init__(self, config, device=None, width=None):
        super().__init__()
        e = width or config.hidden_size
        self.query = nn.Linear(e, e, device=device)
        self.key = nn.Linear(e, e, device=device)
        self.value = nn.Linear(e, e, device=device)

    def heads(self, hidden, num_heads, dtype):
        """q, k, v [B,S,H,W/H] in dtype of hidden [B,S,W]."""
        b, s, w = hidden.shape
        with checkpoint_name("qkv_out"):
            return tuple(dense(p, hidden, dtype).view(b, s, num_heads,
                                                      w // num_heads)
                         for p in (self.query, self.key, self.value))


class BertSelfOutput(nn.Module):
    """Output projection + post-LN (HF's `attention.output`), `width` wide
    as BertSelfAttention; no LayerNorm under pre-LN."""

    def __init__(self, config, device=None, pre_layer_norm=False,
                 width=None):
        super().__init__()
        e = width or config.hidden_size
        self.dense = nn.Linear(e, e, device=device)
        self.LayerNorm = (None if pre_layer_norm else
                          nn.LayerNorm(e, eps=config.layer_norm_eps,
                                       device=device))
        self.dropout = nn.Dropout(config.hidden_dropout_prob)

    def forward(self, hidden, ctx, dtype):
        """hidden + the projection of the attention context ctx, in dtype;
        post-LN then normalises the sum."""
        with checkpoint_name("attn_proj_out"):
            out = dense(self.dense, ctx, dtype)
        out = hidden + self.dropout(out)
        if self.LayerNorm is None:
            return out
        return layer_norm(self.LayerNorm, out, dtype)


# --remat: what each policy keeps for the backward pass, as the JAX
# package's REMAT_POLICIES (easynlp_tpu modeling_bert.py:203-219) do.
# None keeps the output of every projection (jax's "dots with no batch
# dims") and the attention context; a tuple keeps the projections tagged
# with those names (checkpoint_name below); () keeps nothing.
REMAT_POLICIES = {
    "full": (),
    "selective": None,
    "names": ("qkv_out", "attn_out", "attn_proj_out", "mlp_wo_out"),
}
_PROJECTIONS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_TAG = threading.local()


@contextlib.contextmanager
def checkpoint_name(name):
    """Tags the projections run inside the block with `name`, for the
    `names` policy (jax.ad_checkpoint.checkpoint_name's counterpart)."""
    outer = getattr(_TAG, "name", None)
    _TAG.name = name
    try:
        yield
    finally:
        _TAG.name = outer


def _policy_context(saved):
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
    )

    def policy(ctx, op, *args, **kwargs):
        if op in _PROJECTIONS and (
                saved is None or getattr(_TAG, "name", None) in saved):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return create_selective_checkpoint_contexts(policy)


def remat_call(policy, fn, *args):
    """fn(*args) with its activations dropped after the forward and
    recomputed in the backward, but for what `policy` keeps
    (REMAT_POLICIES). torch.utils.checkpoint, non-reentrant: the autograd
    graph is the one without checkpointing, the RNG state is replayed for
    dropout, and the recomputed values are those of the forward bit for
    bit, so every policy gives the same gradients as none."""
    from torch.utils.checkpoint import checkpoint
    saved = REMAT_POLICIES[policy]
    if saved == ():
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=functools.partial(_policy_context, saved))


def set_remat(module, policy):
    """Set the --remat policy of every layer in `module` that has one
    (BertLayer, BartLayer); 'none' turns it off."""
    if policy != "none" and policy not in REMAT_POLICIES:
        raise ValueError("unknown --remat policy %r (none, %s)"
                         % (policy, ", ".join(REMAT_POLICIES)))
    for m in module.modules():
        if hasattr(m, "remat"):
            m.remat = policy


class BertAttention(nn.Module):
    """q/k/v, the attention and the output projection; under pre-LN also
    `ln`, the LayerNorm of its input (HF MegatronBERT's `attention.ln`)."""

    def __init__(self, config, dtype=torch.float32, device=None,
                 pre_layer_norm=False):
        super().__init__()
        self.dtype = dtype
        self.num_heads = config.num_attention_heads
        if pre_layer_norm:
            self.ln = nn.LayerNorm(config.hidden_size,
                                   eps=config.layer_norm_eps, device=device)
        self.self = BertSelfAttention(config, device=device)
        self.output = BertSelfOutput(config, device=device,
                                     pre_layer_norm=pre_layer_norm)

    def context(self, hidden, kv_mask, output_scores=False, bias=None):
        """hidden [B,S,E] in dtype, kv_mask [B,S] int32 (or None) -> the
        attention context [B,S,E] in dtype, and with output_scores the
        masked pre-softmax scores [B,H,S,S] in f32. An additive f32 `bias`
        [B,1|H,S,S] (K-BERT's visible matrix) takes attention's plain
        path, as in the JAX package: no kernel takes a bias."""
        b, s, e = hidden.shape
        h, dt = self.num_heads, self.dtype
        q, k, v = self.self.heads(hidden, h, dt)
        if not output_scores:
            return attention(q, k, v, kv_mask=kv_mask,
                             bias=bias).reshape(b, s, e)
        # The JAX module's explicit-scores path (modeling_bert.py:116-128),
        # which never calls attention(): the scores of attention-transfer
        # distillation (MetaKD), -1e4 on masked keys as the reference's
        # extended attention mask, so MetaKD's "zero out <= -1e2" applies.
        # It runs only when the caller asks for the scores.
        scale = 1.0 / math.sqrt(e // h)
        raw = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        scores = raw + torch.where(kv_mask[:, None, None, :] != 0, 0.0,
                                   -1e4)
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(dt), v)
        return ctx.reshape(b, s, e), scores

    def project(self, hidden, ctx):
        """hidden + the output projection of ctx, in dtype; post-LN then
        normalises the sum."""
        return self.output(hidden, ctx, self.dtype)


class BertIntermediate(nn.Module):
    def __init__(self, config, device=None):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size,
                               device=device)


class BertOutput(nn.Module):
    """The MLP's output projection + post-LN; no LayerNorm under pre-LN."""

    def __init__(self, config, device=None, pre_layer_norm=False):
        super().__init__()
        self.dense = nn.Linear(config.intermediate_size, config.hidden_size,
                               device=device)
        self.LayerNorm = (None if pre_layer_norm else
                          nn.LayerNorm(config.hidden_size,
                                       eps=config.layer_norm_eps,
                                       device=device))
        self.dropout = nn.Dropout(config.hidden_dropout_prob)


class BertLayer(nn.Module):
    """One transformer block, post-LN or (pre_layer_norm, MegatronBERT)
    pre-LN: `attention.ln` before the attention, `ln` before the MLP,
    both residuals without a norm. `remat` (set_remat) is its --remat
    policy while it trains: 'full' recomputes the whole block in the
    backward, attention kernel included; 'selective' and 'names' keep the
    q/k/v projections and the attention kernel (and pre-LN's
    attention.ln) out of the recomputed part (the kernel's autograd
    Function keeps q, k, v and the context for its own backward: JAX's
    qkv_out and attn_out, saved by both policies) and recompute the rest
    under the policy."""

    def __init__(self, config, dtype=torch.float32, device=None,
                 pre_layer_norm=False):
        super().__init__()
        self.dtype = dtype
        self.remat = "none"
        self.act = ACT2FN[config.hidden_act]
        self.attention = BertAttention(config, dtype=dtype, device=device,
                                       pre_layer_norm=pre_layer_norm)
        if pre_layer_norm:
            self.ln = nn.LayerNorm(config.hidden_size,
                                   eps=config.layer_norm_eps, device=device)
        self.pre_layer_norm = pre_layer_norm
        self.intermediate = BertIntermediate(config, device=device)
        self.output = BertOutput(config, device=device,
                                 pre_layer_norm=pre_layer_norm)

    def forward(self, hidden, kv_mask, output_scores=False, bias=None):
        """The block's output [B,S,E] in dtype; with output_scores, (that,
        the attention's masked scores [B,H,S,S])."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return self._block(hidden, kv_mask, output_scores, bias)
        if self.remat == "full":
            return remat_call("full", self._block, hidden, kv_mask,
                              output_scores, bias)
        ctx = self.attention.context(self._attention_input(hidden), kv_mask,
                                     output_scores, bias)
        if output_scores:
            ctx, scores = ctx
            return remat_call(self.remat, self._after_attention, hidden,
                              ctx), scores
        return remat_call(self.remat, self._after_attention, hidden, ctx)

    def _attention_input(self, hidden):
        if not self.pre_layer_norm:
            return hidden
        return layer_norm(self.attention.ln, hidden, self.dtype)

    def _block(self, hidden, kv_mask, output_scores=False, bias=None):
        ctx = self.attention.context(self._attention_input(hidden), kv_mask,
                                     output_scores, bias)
        if output_scores:
            ctx, scores = ctx
            return self._after_attention(hidden, ctx), scores
        return self._after_attention(hidden, ctx)

    def _after_attention(self, hidden, ctx):
        dt = self.dtype
        hidden = self.attention.project(hidden, ctx)
        normed = layer_norm(self.ln, hidden, dt) if self.pre_layer_norm \
            else hidden
        with checkpoint_name("mlp_wi_out"):
            mlp = dense(self.intermediate.dense, normed, dt)
        mlp = self.act(mlp)
        with checkpoint_name("mlp_wo_out"):
            mlp = dense(self.output.dense, mlp, dt)
        mlp = self.output.dropout(mlp)
        if self.pre_layer_norm:
            return hidden + mlp
        return layer_norm(self.output.LayerNorm, hidden + mlp, dt)


class BertEncoder(nn.Module):
    """The layers; under pre-LN also `ln`, the final LayerNorm (HF
    MegatronBERT's `encoder.ln`, JAX's `final_ln`), which normalises the
    last layer's output but not the collected hidden states."""

    def __init__(self, config, dtype=torch.float32, device=None,
                 pre_layer_norm=False):
        super().__init__()
        self.dtype = dtype
        self.layer = nn.ModuleList(
            BertLayer(config, dtype=dtype, device=device,
                      pre_layer_norm=pre_layer_norm)
            for _ in range(config.num_hidden_layers))
        if pre_layer_norm:
            self.ln = nn.LayerNorm(config.hidden_size,
                                   eps=config.layer_norm_eps, device=device)
        self.pre_layer_norm = pre_layer_norm

    def forward(self, hidden, kv_mask, output_hidden_states=False,
                output_attentions=False, bias=None):
        """(the last layer's output, [L, B, S, E] of every layer's output
        or None, [L, B, H, S, S] of every layer's masked scores or None).
        `bias`: an additive attention bias for every layer (K-BERT)."""
        collected, scores = [], []
        for layer in self.layer:
            hidden = layer(hidden, kv_mask, output_attentions, bias)
            if output_attentions:
                hidden, layer_scores = hidden
                scores.append(layer_scores)
            if output_hidden_states:
                collected.append(hidden)
        if self.pre_layer_norm:
            hidden = layer_norm(self.ln, hidden, self.dtype)
        return (hidden, torch.stack(collected) if collected else None,
                torch.stack(scores) if scores else None)


class BertPooler(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(config.hidden_size, config.hidden_size,
                               device=device)

    def forward(self, hidden):
        return torch.tanh(dense(self.dense, hidden[:, 0], self.dtype))


@torch.no_grad()
def init_bert_weights(module, std, generator):
    """Truncated-normal(std) kernels and embeddings, zero biases, unit
    LayerNorm scales, drawn from `generator` in module order."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            truncated_normal_(m.weight, std, generator)
        if isinstance(m, nn.Linear):
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class BertModel(nn.Module):
    """Returns {'last_hidden_state': [B,S,E], 'pooler_output': [B,E]}, with
    output_hidden_states 'hidden_states' [L,B,S,E], all in `dtype`, and
    with output_attentions 'attentions' [L,B,H,S,S], the masked pre-softmax
    scores in f32. pre_layer_norm=True is MegatronBERT's pre-LN layout."""

    def __init__(self, config, dtype=torch.float32, add_pooling_layer=True,
                 device=None, output_hidden_states=False,
                 output_attentions=False, pre_layer_norm=False):
        super().__init__()
        self.config = config
        self.output_hidden_states = output_hidden_states
        self.output_attentions = output_attentions
        self.embeddings = BertEmbeddings(config, dtype=dtype, device=device,
                                         use_layer_norm=not pre_layer_norm)
        self.encoder = BertEncoder(config, dtype=dtype, device=device,
                                   pre_layer_norm=pre_layer_norm)
        self.pooler = (BertPooler(config, dtype=dtype, device=device)
                       if add_pooling_layer else None)

    @torch.no_grad()
    def init_weights(self, generator):
        init_bert_weights(self, self.config.initializer_range, generator)

    def embed(self, input_ids, attention_mask=None, token_type_ids=None,
              position_ids=None):
        """(embedded tokens [B,S,E] in dtype, the int32 kv_mask [B,S]): the
        encoder's inputs."""
        b, s = input_ids.shape
        device = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32,
                                        device=device)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.int32,
                                         device=device)
        if position_ids is None:
            if getattr(self.config, "position_ids_from_padding_idx", False):
                pad = self.config.pad_token_id
                not_pad = (input_ids != pad).to(torch.int64)
                position_ids = torch.cumsum(not_pad, dim=1) * not_pad + pad
            else:
                position_ids = torch.arange(s, device=device)[None, :] \
                    .expand(b, s)
        # int32 once here, so no layer converts the mask again
        kv_mask = attention_mask.to(torch.int32).contiguous()
        return (self.embeddings(input_ids, token_type_ids, position_ids),
                kv_mask)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None):
        hidden, kv_mask = self.embed(input_ids, attention_mask,
                                     token_type_ids, position_ids)
        hidden, all_hidden, all_scores = self.encoder(
            hidden, kv_mask, self.output_hidden_states,
            self.output_attentions)
        out = {"last_hidden_state": hidden}
        if all_hidden is not None:
            out["hidden_states"] = all_hidden
        if all_scores is not None:
            out["attentions"] = all_scores
        if self.pooler is not None:
            out["pooler_output"] = self.pooler(hidden)
        return out


class BertMLMHead(nn.Module):
    """The MLM head: dense -> activation -> f32 LayerNorm, then the decoder
    tied to the word embeddings (a plain matmul with their [V, E] table in
    `dtype`) plus a vocab bias, both in `dtype`, as the JAX head computes
    them."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.act = ACT2FN[config.hidden_act]
        self.dense = nn.Linear(config.hidden_size, config.hidden_size,
                               device=device)
        self.LayerNorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps,
                                      device=device)
        self.bias = nn.Parameter(torch.zeros(config.vocab_size,
                                             device=device))

    def forward(self, hidden, word_embeddings):
        dt = self.dtype
        h = layer_norm(self.LayerNorm, self.act(dense(self.dense, hidden,
                                                      dt)), dt)
        return torch.matmul(h, word_embeddings.to(dt).t()) + self.bias.to(dt)


class BertForMaskedLM(nn.Module):
    """BertModel without a pooler and the tied MLM head. Returns {'logits':
    [B,S,V], 'last_hidden_state': [B,S,E]}, both in `dtype`."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, dtype=dtype, add_pooling_layer=False,
                              device=device)
        self.cls = BertMLMHead(config, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        """The backbone's init, then the head's: truncated-normal dense,
        unit LayerNorm, zero biases."""
        self.bert.init_weights(generator)
        truncated_normal_(self.cls.dense.weight,
                          self.config.initializer_range, generator)
        self.cls.dense.bias.zero_()
        self.cls.LayerNorm.weight.fill_(1.0)
        self.cls.LayerNorm.bias.zero_()
        self.cls.bias.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None):
        out = self.bert(input_ids, attention_mask, token_type_ids,
                        position_ids)
        logits = self.cls(out["last_hidden_state"],
                          self.bert.embeddings.word_embeddings.weight)
        return {"logits": logits, **out}
