"""Kangaroo for the PyTorch port: a dual-stream knowledge-enhanced BERT with
entity-tree contrastive samples and Poincaré concept embeddings.

Counterpart of easynlp_tpu/modelzoo/models/kangaroo/modeling_kangaroo.py:
- three layer kinds, by config.layer_types (default: a third each of
  `sim`, `norm`, `mix`): `sim` is a plain post-LN BertLayer; `norm` also
  runs a small attention (ent_size wide, ent_heads heads) over the entity
  stream; `mix` carries the entity stream through unattended. In `norm` and
  `mix` the FFN fuses the streams: the intermediate adds
  `intermediate.dense_ent(entity stream)` before the activation, and the
  output splits into `output.dense` (text) and `output.dense_ent` (entity);
- each entity's contrastive sample sentences ([B, ent_num, sample_num,
  Ss]) are folded into one batch and encoded by the first contiguous `sim`
  layers, whose weights the text stream shares (`encode_samples`); the
  positive's [CLS] goes through `encoder.linear` and, with the concept
  embedding, `encoder.linear2`; the entity stream starts as those rows
  gathered at each token's entity index, row 0 (no entity) being zero;
- the pretraining head: MLM tied to the word embeddings, plus the cosine
  similarity of `cls.token_emb(token state)` against [positive;
  negatives], with label 0 at entity tokens and -100 elsewhere.

The entity attention has head dim 25 at the published widths (100 over 4
heads), not a multiple of 8, so it takes attention's plain path, as JAX's
takes XLA's (ROADMAP A13, open); the text attention and the sample
encoding take the kernels. An entity slot with no entity has an all-zero
sample mask: its rows attend to no key (the mean of V, ROADMAP C1), and
its [CLS] is never gathered. Like the JAX KangarooForPreTraining, which
never passes `remat` to its model, this module checkpoints nothing under
--remat (its layers have no `remat` policy for set_remat to set).

Each layer is a BertLayer (KangarooLayer adds the entity parts), and the
MLM head is BertMLMHead. Parameter names follow the reference torch
checkpoint that the JAX package's convert_kangaroo reads
(`kangaroo.embeddings.*`,
`kangaroo.encoder.layer.{i}.attention.{self,self_ent,output,output_ent}`,
`.intermediate.dense{,_ent}`, `.output.{dense,dense_ent,LayerNorm{,_ent}}`,
`kangaroo.encoder.linear{,2}`, `cls.token_emb`), but for the MLM head's
transform, which is BertMLMHead's `cls.predictions.{dense,LayerNorm}`
in the module and the reference's `cls.predictions.transform.*` in a
checkpoint (`reference_state_dict`, `from_reference_names`), so such a
checkpoint loads strictly.
"""

import torch
from torch import nn

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig
from easynlp_tpu_torch.modelzoo.modeling_utils import one_hot_rows
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    MLM_NAMES,
    mlm_head_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
    BertEmbeddings,
    BertLayer,
    BertMLMHead,
    BertPooler,
    BertSelfAttention,
    BertSelfOutput,
    dense,
    init_bert_weights,
    layer_norm,
)
from easynlp_tpu_torch.ops.attention import attention

LAYER_TYPES = ("sim", "norm", "mix")


def _default_layer_types(n):
    third = n // 3
    return ["sim"] * third + ["norm"] * third + ["mix"] * (n - 2 * third)


class KangarooConfig(PretrainedConfig):
    model_type = "kangaroo"

    def __init__(self, vocab_size=21128, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 pad_token_id=0, ent_size=100, ent_heads=4, concept_size=10,
                 ent_num=3, sample_num=4, layer_types=None, **kwargs):
        self.ent_size = ent_size
        self.ent_heads = ent_heads
        self.concept_size = concept_size
        self.ent_num = ent_num
        self.sample_num = sample_num
        self.layer_types = list(layer_types) if layer_types is not None \
            else _default_layer_types(num_hidden_layers)
        super().__init__(
            vocab_size=vocab_size, hidden_size=hidden_size,
            num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads,
            intermediate_size=intermediate_size, hidden_act=hidden_act,
            hidden_dropout_prob=hidden_dropout_prob,
            attention_probs_dropout_prob=attention_probs_dropout_prob,
            max_position_embeddings=max_position_embeddings,
            type_vocab_size=type_vocab_size,
            initializer_range=initializer_range,
            layer_norm_eps=layer_norm_eps, pad_token_id=pad_token_id,
            **kwargs)


class KangarooLayer(BertLayer):
    """One Kangaroo layer of kind `layer_type` (sim | norm | mix): a post-LN
    BertLayer under BERT's names, to which `norm` adds the entity attention
    (`attention.self_ent`, `attention.output_ent`, ent_size wide) and
    `norm` and `mix` the entity stream's FFN parts
    (`intermediate.dense_ent`, `output.dense_ent`, `output.LayerNorm_ent`).
    """

    def __init__(self, config, layer_type, dtype=torch.float32,
                 device=None):
        if layer_type not in LAYER_TYPES:
            raise ValueError("unknown Kangaroo layer type %r (%s)"
                             % (layer_type, ", ".join(LAYER_TYPES)))
        super().__init__(config, dtype=dtype, device=device)
        # the JAX KangarooForPreTraining passes its model no remat:
        # set_remat leaves these layers alone
        del self.remat
        self.layer_type = layer_type
        self.ent_heads = config.ent_heads
        c = config
        if layer_type == "norm":
            self.attention.self_ent = BertSelfAttention(c, device=device,
                                                        width=c.ent_size)
            self.attention.output_ent = BertSelfOutput(c, device=device,
                                                       width=c.ent_size)
        if layer_type != "sim":
            self.intermediate.dense_ent = nn.Linear(
                c.ent_size, c.intermediate_size, device=device)
            self.output.dense_ent = nn.Linear(
                c.intermediate_size, c.ent_size, device=device)
            # the JAX layer's output_ln_ent has eps 1e-12 whatever the
            # config says (modeling_kangaroo.py:176)
            self.output.LayerNorm_ent = nn.LayerNorm(c.ent_size, eps=1e-12,
                                                     device=device)

    def forward(self, hidden, kv_mask, hidden_ent=None, ent_kv_mask=None,
                ent_mask=None):
        """(text stream [B,S,E], entity stream [B,S,ent_size] or the
        hidden_ent given, for `sim`), both in dtype."""
        if self.layer_type == "sim":
            return self._block(hidden, kv_mask), hidden_ent
        dt, a, o = self.dtype, self.attention, self.output
        attn_out = a.project(hidden, a.context(hidden, kv_mask))
        inter = dense(self.intermediate.dense, attn_out, dt)
        keep = ent_mask[..., None].to(dt)
        if self.layer_type == "norm":
            q, k, v = a.self_ent.heads(hidden_ent, self.ent_heads, dt)
            ctx = attention(q, k, v, kv_mask=ent_kv_mask)
            attn_ent = a.output_ent(hidden_ent, ctx.reshape(
                hidden_ent.shape), dt) * keep
        else:
            attn_ent = hidden_ent * keep
        inter = self.act(inter + dense(self.intermediate.dense_ent,
                                       attn_ent, dt))
        out = o.dropout(dense(o.dense, inter, dt))
        hidden = layer_norm(o.LayerNorm, attn_out + out, dt)
        out_ent = o.dropout(dense(o.dense_ent, inter, dt))
        hidden_ent = layer_norm(o.LayerNorm_ent, attn_ent + out_ent, dt)
        return hidden, hidden_ent


class KangarooEncoder(nn.Module):
    """The heterogeneous layer stack and the sample projections `linear`
    (hidden -> ent_size) and `linear2` (ent_size + concept_size ->
    ent_size), both f32."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        c = config
        if len(c.layer_types) != c.num_hidden_layers:
            raise ValueError("layer_types has %d entries for %d layers"
                             % (len(c.layer_types), c.num_hidden_layers))
        self.layer = nn.ModuleList(
            KangarooLayer(c, t, dtype=dtype, device=device)
            for t in c.layer_types)
        self.linear = nn.Linear(c.hidden_size, c.ent_size, device=device)
        self.linear2 = nn.Linear(c.ent_size + c.concept_size, c.ent_size,
                                 device=device)
        # the first contiguous run of `sim` layers encodes the samples
        n = 0
        while n < len(c.layer_types) and c.layer_types[n] == "sim":
            n += 1
        self.sample_layers = n


class KangarooModel(nn.Module):
    """Returns {'last_hidden_state' [B,S,E], 'pooler_output' [B,E]} and,
    given the samples, 'positive_ent' [B,S,ent_size] (in dtype) and
    'negative_ent' [B,S,sample_num-1,ent_size] (f32, or None when
    sample_num is 1)."""

    def __init__(self, config, dtype=torch.float32, add_pooling_layer=True,
                 device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.embeddings = BertEmbeddings(config, dtype=dtype, device=device)
        self.encoder = KangarooEncoder(config, dtype=dtype, device=device)
        self.pooler = (BertPooler(config, dtype=dtype, device=device)
                       if add_pooling_layer else None)

    def init_weights(self, generator):
        init_bert_weights(self, self.config.initializer_range, generator)

    def encode_samples(self, sample_token_id, sample_position_id,
                       sample_mask):
        """[B, ent_num, sample_num, Ss] -> the [CLS] states [B, ent_num,
        sample_num, E] in dtype, through the first `sim` layers, all
        samples in one batch."""
        c = self.config
        b, ss = sample_token_id.shape[0], sample_token_id.shape[-1]
        ids = sample_token_id.reshape(-1, ss)
        pos = (sample_position_id.reshape(-1, ss)
               if sample_position_id is not None else
               torch.arange(ss, device=ids.device)[None].expand(ids.shape))
        mask = (sample_mask.reshape(-1, ss) if sample_mask is not None
                else (ids != c.pad_token_id))
        # a few position ids repeat thousands of times here: their rows by
        # one-hot contraction, for a fixed-order backward (ROADMAP C29)
        emb = self.embeddings(ids, torch.zeros_like(ids), pos,
                              one_hot_positions=True)
        kv = mask.to(torch.int32).contiguous()
        for layer in self.encoder.layer[:self.encoder.sample_layers]:
            emb, _ = layer(emb, kv)
        return emb[:, 0].reshape(b, c.ent_num, c.sample_num, -1)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, entities_position=None, ent_mask=None,
                sample_token_id=None, sample_position_id=None,
                sample_mask=None, concept_emb=None):
        c, dt, enc = self.config, self.dtype, self.encoder
        b, s = input_ids.shape
        device = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32,
                                        device=device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if position_ids is None:
            position_ids = torch.arange(s, device=device)[None].expand(b, s)
        kv_mask = attention_mask.to(torch.int32).contiguous()
        hidden = self.embeddings(input_ids, token_type_ids, position_ids)
        if ent_mask is None:
            ent_mask = torch.zeros((b, s), dtype=torch.int32, device=device)
        # the entity attention sees only entity positions; its fully
        # masked rows are masked out again by ent_mask in every layer
        ent_kv_mask = ent_mask.to(torch.int32).contiguous()
        hidden_ent = torch.zeros((b, s, c.ent_size), dtype=dt, device=device)
        positive = negative = None
        if sample_token_id is not None:
            cls = self.encode_samples(sample_token_id, sample_position_id,
                                      sample_mask).float()
            pos_emb = enc.linear(cls[:, :, 0])
            if concept_emb is not None:
                pos_emb = enc.linear2(torch.cat([pos_emb,
                                                 concept_emb.float()], -1))
            # row 0 is "no entity": entities_position 0 gathers zeros
            table = torch.cat([pos_emb.new_zeros((b, 1, c.ent_size)),
                               pos_emb], dim=1)
            # the gathers as one-hot contractions: a fixed-order backward
            # (torch.gather's CUDA backward adds repeated indices in a
            # varying order; ROADMAP C29)
            index = entities_position.long()
            hidden_ent = one_hot_rows(index, table).to(dt)
            positive = hidden_ent
            if c.sample_num > 1:
                neg = enc.linear(cls[:, :, 1:])
                neg = torch.cat([neg.new_zeros((b, 1) + neg.shape[2:]), neg],
                                dim=1)
                negative = one_hot_rows(index, neg.flatten(2)).view(
                    b, s, c.sample_num - 1, c.ent_size)
        for layer in enc.layer:
            hidden, hidden_ent = layer(hidden, kv_mask, hidden_ent,
                                       ent_kv_mask, ent_mask)
        out = {"last_hidden_state": hidden}
        if positive is not None:
            out["positive_ent"] = positive
            out["negative_ent"] = negative
        if self.pooler is not None:
            out["pooler_output"] = self.pooler(hidden)
        return out


class KangarooHead(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        self.predictions = BertMLMHead(config, dtype=dtype, device=device)
        self.token_emb = nn.Linear(config.hidden_size, config.ent_size,
                                   device=device)


class KangarooForPreTraining(nn.Module):
    """KangarooModel without a pooler, the MLM head and the entity contrast
    head. Returns {'logits' [B,S,V], 'last_hidden_state'} and, given the
    samples with sample_num > 1, 'cos_score' [B,S,sample_num] (f32) and
    'sample_label' [B,S] (0 at entity tokens, -100 elsewhere)."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.kangaroo = KangarooModel(config, dtype=dtype,
                                      add_pooling_layer=False, device=device)
        self.cls = KangarooHead(config, dtype, device)

    def init_weights(self, generator):
        init_bert_weights(self, self.config.initializer_range, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                entities_position=None, ent_mask=None, sample_token_id=None,
                sample_position_id=None, sample_mask=None, concept_emb=None):
        out = self.kangaroo(
            input_ids, attention_mask=attention_mask,
            token_type_ids=token_type_ids,
            entities_position=entities_position, ent_mask=ent_mask,
            sample_token_id=sample_token_id,
            sample_position_id=sample_position_id, sample_mask=sample_mask,
            concept_emb=concept_emb)
        last = out["last_hidden_state"]
        result = {"logits": self.cls.predictions(
            last, self.kangaroo.embeddings.word_embeddings.weight),
            "last_hidden_state": last}
        if out.get("negative_ent") is not None:
            tok = self.cls.token_emb(last.float())
            cand = torch.cat([out["positive_ent"][:, :, None].float(),
                              out["negative_ent"].float()], dim=2)
            tok = tok / (torch.linalg.vector_norm(tok, dim=-1, keepdim=True)
                         + 1e-8)
            cand = cand / (torch.linalg.vector_norm(cand, dim=-1,
                                                    keepdim=True) + 1e-8)
            result["cos_score"] = torch.einsum("bse,bske->bsk", tok, cand)
            result["sample_label"] = torch.where(
                ent_mask != 0, 0, -100).to(torch.int32)
        return result


def _tensor(arr):
    import numpy as np
    return torch.tensor(np.asarray(arr, dtype=np.float32))


def model_state_dict_from_jax(params, config):
    """A KangarooModel state dict from the JAX KangarooModel's param tree
    (numpy leaves): fused qkv kernels split into query/key/value, [in,
    out] kernels transposed, `layer_{i}` to `encoder.layer.{i}`; the
    inverse of the JAX package's convert_kangaroo."""
    state = {}

    def put_dense(key, p):
        state[key + ".weight"] = _tensor(p["kernel"]).t().contiguous()
        state[key + ".bias"] = _tensor(p["bias"])

    def put_ln(key, p):
        state[key + ".weight"] = _tensor(p["scale"])
        state[key + ".bias"] = _tensor(p["bias"])

    def put_attention(base, p):
        kernel, bias = _tensor(p["qkv"]["kernel"]), _tensor(p["qkv"]["bias"])
        w = kernel.shape[0]
        for j, name in enumerate(("query", "key", "value")):
            state["%s.%s.weight" % (base[0], name)] = \
                kernel[:, j * w:(j + 1) * w].t().contiguous()
            state["%s.%s.bias" % (base[0], name)] = bias[j * w:(j + 1) * w]
        put_dense(base[1] + ".dense", p["output"])
        put_ln(base[1] + ".LayerNorm", p["ln"])

    emb = params["embeddings"]
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        state["embeddings.%s.weight" % name] = _tensor(
            emb[name]["embedding"])
    put_ln("embeddings.LayerNorm", emb["LayerNorm"])
    for i, kind in enumerate(config.layer_types):
        p, base = params["layer_%d" % i], "encoder.layer.%d." % i
        put_attention((base + "attention.self", base + "attention.output"),
                      p["attention"])
        if kind == "norm":
            put_attention((base + "attention.self_ent",
                           base + "attention.output_ent"),
                          p["attention_ent"])
        put_dense(base + "intermediate.dense", p["intermediate"])
        put_dense(base + "output.dense", p["output"])
        put_ln(base + "output.LayerNorm", p["output_ln"])
        if kind != "sim":
            put_dense(base + "intermediate.dense_ent", p["intermediate_ent"])
            put_dense(base + "output.dense_ent", p["output_ent"])
            put_ln(base + "output.LayerNorm_ent", p["output_ln_ent"])
    put_dense("encoder.linear", params["linear"])
    put_dense("encoder.linear2", params["linear2"])
    if "pooler" in params:
        put_dense("pooler.dense", params["pooler"]["dense"])
    return state


# the reference checkpoint's MLM head names -> the port's (BertMLMHead's)
_HEAD_NAMES = {ref: "cls.predictions." + ours
               for ref, ours in MLM_NAMES["bert"][1].items()}


def _renamed(state, names):
    out = {}
    for k, v in state.items():
        hit = next((n for n in names if k.startswith(n)), None)
        out[names[hit] + k[len(hit):] if hit else k] = v
    return out


def from_reference_names(state):
    """A KangarooForPreTraining state dict under the reference
    checkpoint's names -> under the module's."""
    return _renamed(state, _HEAD_NAMES)


def reference_state_dict(module):
    """A KangarooForPreTraining's weights under the reference checkpoint's
    names (`cls.predictions.transform.*`)."""
    return _renamed(module.state_dict(),
                    {ours: ref for ref, ours in _HEAD_NAMES.items()})


def state_dict_from_jax(params, config):
    """A KangarooForPreTraining state dict from the JAX module's param
    tree: `kangaroo.*` as above, `mlm_head` to `cls.predictions.*`,
    `token_emb` to `cls.token_emb`."""
    state = {"kangaroo." + k: v for k, v in
             model_state_dict_from_jax(params["kangaroo"], config).items()}
    state.update({"cls.predictions." + k: v for k, v in
                  mlm_head_from_jax(params["mlm_head"]).items()})
    state["cls.token_emb.weight"] = _tensor(
        params["token_emb"]["kernel"]).t().contiguous()
    state["cls.token_emb.bias"] = _tensor(params["token_emb"]["bias"])
    return state
