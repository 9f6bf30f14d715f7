"""The knowledge models (MegatronBERT, K-BERT, DKPLM, CKBERT, Kangaroo) in the
PyTorch port against the JAX package, in f32 on the CPU, at tiny widths (2-3
layers, hidden 32, dropout 0); AutoConfig/AutoModel/AutoTokenizer; the
--remat + enable_lora repair.

Each JAX module starts from its own init, every leaf moved by 0.05 N(0, 1)
noise (so biases and LayerNorms are exercised), and the port's module takes
the same weights through its state_dict_from_jax; both take the same
numpy-seeded inputs. Tolerances (f32 in two frameworks, summed in other
orders): hidden states and logits 1e-4 (test_torch_bart.py's), losses and
gradients 1e-5.
- MegatronBERT (pre-LN): against the JAX module with the params of
  convert_megatron_bert, and against transformers' MegatronBertModel on
  its own state dict, which AutoModel loads strictly (the JAX AutoModel
  refuses it: reference fault 22); pre-LN BERT's output_hidden_states and
  output_attentions against JAX's, and --remat bit for bit.
- K-BERT with a visible matrix that hides some keys and soft positions.
- DKPLM: logits, the MLM and decode-knowledge losses, gradients.
- CKBERT in training mode with dropout 0 (both sides build cls_view2):
  the MLM and InfoNCE terms and the gradients.
- Kangaroo with layer_types sim, norm, mix and one batch row that links no
  entity (its sample rows fully masked): logits, cos_score, both losses
  and the gradients.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_text_match import _restore_global_args  # noqa: F401

OUT_ATOL, LOSS_ATOL, GRAD_ATOL = 1e-4, 1e-5, 1e-5
TINY = dict(vocab_size=60, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            max_position_embeddings=64)
KANGAROO = dict(TINY, num_hidden_layers=3, layer_types=["sim", "norm", "mix"],
                ent_size=12, ent_heads=4, concept_size=5, ent_num=2,
                sample_num=3)


def noisy(params, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def init_jax(module, seed=0, **inputs):
    rng = jax.random.PRNGKey(seed)
    params = module.init({"params": rng, "dropout": rng},
                         **{k: jnp.asarray(v) for k, v in inputs.items()},
                         deterministic=True)["params"]
    from flax import linen as nn
    return noisy(nn.unbox(params), seed)


def ids_and_mask(seed, b=4, s=10, vocab=60):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(3, s + 1, b)
    lengths[0] = s
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, rng.randint(4, vocab, (b, s)), 0).astype(
        np.int32)
    return ids, mask


def mlm_labels(seed, ids, mask, p=0.3, vocab=60):
    rng = np.random.RandomState(seed + 100)
    return np.where((rng.rand(*ids.shape) < p) & (mask == 1),
                    rng.randint(4, vocab, ids.shape), -100).astype(np.int32)


def close(got, want, atol, what):
    np.testing.assert_allclose(
        got.detach().float().numpy() if torch.is_tensor(got) else got,
        np.asarray(want), atol=atol, rtol=0, err_msg=what)


def assert_grads(module, jax_grads, state_dict_from_jax, config):
    """Every parameter's gradient within GRAD_ATOL of jax.grad's carried
    over by state_dict_from_jax, and not all of them negligible."""
    want = state_dict_from_jax(jax.tree.map(np.asarray, jax_grads), config)
    named = dict(module.named_parameters())
    assert set(want) == set(named)
    for key, w in want.items():
        # None: a weight the loss does not reach (Kangaroo's last entity
        # projection), whose JAX gradient is zero
        g = named[key].grad
        close(torch.zeros_like(w) if g is None else g, w.numpy(), GRAD_ATOL,
              key)
    assert max(float(w.abs().max()) for w in want.values()) > 1e-3


# --------------------------------------------------------------------------
# MegatronBERT (pre-LN BERT)
# --------------------------------------------------------------------------

def _hf_megatron(monkeypatch, seed=0):
    # transformers' torch models need no TensorFlow, whose import costs
    # ~10 s here (it takes effect where no test imported transformers yet)
    monkeypatch.setenv("USE_TF", "0")
    from transformers import MegatronBertConfig, MegatronBertModel
    torch.manual_seed(seed)
    cfg = MegatronBertConfig(**{k: v for k, v in TINY.items()})
    model = MegatronBertModel(cfg).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    return cfg, model


def test_megatron_bert_matches_transformers_and_jax(tmp_path, monkeypatch):
    """AutoModel loads transformers' own MegatronBertModel state dict (its
    config.json says model_type megatron-bert) strictly; its hidden states
    and pooler output match transformers' within 1e-4, and the JAX
    MegatronBertModel's on convert_megatron_bert's params; the port's
    state_dict_from_jax inverts that converter exactly."""
    from easynlp_tpu.modelzoo.models.megatron_bert import (
        MegatronBertConfig as JaxConfig,
        MegatronBertModel as JaxModel,
        convert_megatron_bert,
    )

    from easynlp_tpu_torch.modelzoo.models.auto import AutoModel
    from easynlp_tpu_torch.modelzoo.models.megatron_bert import (
        MegatronBertModel,
        state_dict_from_jax,
    )
    hf_cfg, hf = _hf_megatron(monkeypatch)
    hf.save_pretrained(str(tmp_path), safe_serialization=False)
    with open(tmp_path / "config.json") as f:
        assert json.load(f)["model_type"] == "megatron-bert"
    port = AutoModel.from_pretrained(str(tmp_path), device="cpu")
    assert isinstance(port, MegatronBertModel)
    assert port.embeddings.LayerNorm is None
    ids, mask = ids_and_mask(1)
    t = {"input_ids": torch.from_numpy(ids).long(),
         "attention_mask": torch.from_numpy(mask)}
    with torch.no_grad():
        got = port(**t)
        want = hf(**t)
    close(got["last_hidden_state"], want.last_hidden_state, OUT_ATOL,
          "last_hidden_state vs transformers")
    close(got["pooler_output"], want.pooler_output, OUT_ATOL,
          "pooler_output vs transformers")

    hf_state = {k: v.numpy() for k, v in hf.state_dict().items()}
    jcfg = JaxConfig(**TINY)
    params = convert_megatron_bert(hf_state, jcfg)
    out = JaxModel(config=jcfg, dtype=jnp.float32).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    close(got["last_hidden_state"], out["last_hidden_state"], OUT_ATOL,
          "last_hidden_state vs JAX")
    close(got["pooler_output"], out["pooler_output"], OUT_ATOL,
          "pooler_output vs JAX")
    back = state_dict_from_jax(params, port.config)
    own = port.state_dict()
    assert set(back) == set(own)
    for k, v in back.items():
        assert torch.equal(v, own[k]), k


def test_pre_ln_collected_outputs_and_remat_match(tmp_path):
    """Pre-LN BertModel's output_hidden_states ([L, B, S, E], before the
    final LayerNorm) and output_attentions (the masked scores) against the
    JAX BertModel(pre_layer_norm=True); --remat=full and selective give
    none's output and gradients bit for bit."""
    from easynlp_tpu.modelzoo.models.bert import BertConfig as JaxConfig
    from easynlp_tpu.modelzoo.models.bert import BertModel as JaxModel

    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
        state_dict_from_jax)
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        BertModel, set_remat)
    ids, mask = ids_and_mask(2)
    jmodule = JaxModel(config=JaxConfig(**TINY), dtype=jnp.float32,
                       pre_layer_norm=True, output_hidden_states=True,
                       output_attentions=True)
    params = init_jax(jmodule, input_ids=ids, attention_mask=mask)
    assert "final_ln" in params["encoder"]
    want = jmodule.apply({"params": params}, jnp.asarray(ids),
                         jnp.asarray(mask))
    cfg = BertConfig(**TINY)
    module = BertModel(cfg, pre_layer_norm=True, device="cpu",
                       output_hidden_states=True, output_attentions=True)
    module.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    t = (torch.from_numpy(ids).long(), torch.from_numpy(mask))
    got = module(*t)
    for key in ("last_hidden_state", "hidden_states", "attentions",
                "pooler_output"):
        close(got[key], want[key], OUT_ATOL, key)

    module.output_hidden_states = module.output_attentions = False
    runs = {}
    for policy in ("none", "full", "selective"):
        module.zero_grad()
        set_remat(module, policy)
        out = module(*t)
        w = torch.linspace(-1, 1, TINY["hidden_size"])
        ((out["last_hidden_state"] * w).sum()
         + (out["pooler_output"] * w).sum()).backward()
        runs[policy] = (out["last_hidden_state"].detach(),
                        {n: p.grad.clone() for n, p in
                         module.named_parameters()})
    for policy in ("full", "selective"):
        assert torch.equal(runs[policy][0], runs["none"][0])
        for n, g in runs["none"][1].items():
            assert torch.equal(runs[policy][1][n], g), (policy, n)


# --------------------------------------------------------------------------
# K-BERT
# --------------------------------------------------------------------------

def test_kbert_matches_jax():
    """A visible matrix that hides each branch token from the tokens
    outside its branch, soft position ids that repeat, and padding: the
    hidden states, the pooler output and the gradients of a fixed
    projection of both."""
    from easynlp_tpu.modelzoo.models.kbert import (KBertConfig as JaxConfig,
                                                   KBertModel as JaxModel)

    from easynlp_tpu_torch.modelzoo.models.kbert import (KBertConfig,
                                                         KBertModel)
    from easynlp_tpu_torch.modelzoo.models.kbert.modeling_kbert import (
        state_dict_from_jax)
    ids, mask = ids_and_mask(3)
    b, s = ids.shape
    rng = np.random.RandomState(3)
    visible = np.ones((b, s, s), np.int32)
    branch = rng.rand(b, s) < 0.3          # tokens grafted from the KG
    branch[:, 0] = False
    for r in range(b):
        for q in range(s):
            for k in range(s):
                if branch[r, k] and not branch[r, q] and (q + k) % 2:
                    visible[r, q, k] = 0
    position = np.cumsum(~branch, axis=1).astype(np.int32) - 1
    inputs = dict(input_ids=ids, attention_mask=mask, position_ids=position,
                  visible_matrix=visible)
    jmodule = JaxModel(config=JaxConfig(**TINY), dtype=jnp.float32)
    params = init_jax(jmodule, **inputs)
    w = np.linspace(-1, 1, TINY["hidden_size"]).astype(np.float32)

    def loss(p):
        out = jmodule.apply({"params": p},
                            **{k: jnp.asarray(v) for k, v in inputs.items()})
        return (jnp.mean(out["last_hidden_state"] * w)
                + jnp.mean(out["pooler_output"] * w)), out

    (want_loss, want), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    cfg = KBertConfig(**TINY)
    module = KBertModel(cfg, device="cpu")
    module.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    got = module(**{k: torch.from_numpy(v).long() for k, v in inputs.items()})
    for key in ("last_hidden_state", "pooler_output"):
        close(got[key], want[key], OUT_ATOL, key)
    tw = torch.from_numpy(w)
    got_loss = (got["last_hidden_state"] * tw).mean() \
        + (got["pooler_output"] * tw).mean()
    close(got_loss, float(want_loss), LOSS_ATOL, "loss")
    got_loss.backward()
    assert_grads(module, grads, state_dict_from_jax, cfg)
    # the visible matrix matters: all-visible gives other states
    module.eval()
    with torch.no_grad():
        plain = module(**{k: torch.from_numpy(v).long() for k, v in
                          inputs.items() if k != "visible_matrix"})
    assert float((plain["last_hidden_state"]
                  - got["last_hidden_state"]).abs().max()) > 1e-2


# --------------------------------------------------------------------------
# DKPLM, CKBERT, Kangaroo (the language_modeling variants' modules)
# --------------------------------------------------------------------------

def _app_parity(jax_app, port_app, jcfg, pcfg, inputs, batch, train=False):
    """The JAX app's module and the port's from one init: outputs within
    OUT_ATOL, the loss terms within LOSS_ATOL and the gradients within
    GRAD_ATOL. train: both in training mode (dropout 0). Returns (JAX
    outputs, port outputs, JAX loss dict)."""
    jmodule = jax_app.build_module(jcfg, dtype=jnp.float32)
    params = noisy(jax_app.init_params(jmodule, jcfg, 0))
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        out = jmodule.apply({"params": p}, **jin, deterministic=not train,
                            rngs={"dropout": jax.random.PRNGKey(1)})
        terms = jax_app.loss_fn(out, jbatch)
        return terms["loss"], (out, terms)

    (_, (want, terms)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    module = port_app.build_module(pcfg, dtype=torch.float32, device="cpu")
    module.load_state_dict(port_app.state_dict_from_jax(params, pcfg),
                           strict=True)
    module.train(train)
    got = module(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    app = port_app(module, pcfg, "cpu")
    got_terms = app.loss_fn(got, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    for key, w in want.items():
        w = np.asarray(w)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)
        else:
            close(got[key], w, OUT_ATOL, key)
    assert set(got_terms) == set(terms), (set(got_terms), set(terms))
    for key, w in terms.items():
        close(got_terms[key], float(w), LOSS_ATOL, key)
    got_terms["loss"].backward()
    assert_grads(module, grads, port_app.state_dict_from_jax, pcfg)
    return want, got, terms


def test_dkplm_matches_jax():
    """Knowledge embeddings on two spans, MLM labels away from them and
    decode-knowledge labels on them."""
    from easynlp_tpu.appzoo.language_modeling.model import (
        DKPLMLanguageModeling as JaxApp)
    from easynlp_tpu.modelzoo.models.dkplm import DKPLMConfig as JaxConfig

    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        DKPLMLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.dkplm import DKPLMConfig
    ids, mask = ids_and_mask(4)
    b, s = ids.shape
    rng = np.random.RandomState(4)
    know_mask = np.zeros((b, s), np.int32)
    know_mask[:, 1:3] = 1
    know_mask[1, 5:7] = 1
    know_mask *= mask
    know_emb = (rng.standard_normal((b, s, 8)) * know_mask[..., None]) \
        .astype(np.float32)
    labels = np.where(know_mask == 0, mlm_labels(4, ids, mask), -100) \
        .astype(np.int32)
    know_labels = np.where(know_mask == 1, ids, -100).astype(np.int32)
    kw = dict(TINY, knowledge_emb_size=8)
    _, _, terms = _app_parity(
        JaxApp, DKPLMLanguageModeling, JaxConfig(**kw), DKPLMConfig(**kw),
        dict(input_ids=ids, attention_mask=mask,
             token_type_ids=np.zeros_like(ids), insert_know_emb=know_emb,
             insert_know_position_mask=know_mask),
        dict(label_ids=labels, insert_know_labels=know_labels))
    assert {"mlm_loss", "decode_know_loss"} <= set(terms)


def test_ckbert_matches_jax_in_training_mode():
    """Dropout 0 in training mode: both run the backbone twice and give
    cls_view2 (equal to cls_view1), so the InfoNCE term is exercised."""
    from easynlp_tpu.appzoo.language_modeling.model import (
        CKBertLanguageModeling as JaxApp)
    from easynlp_tpu.modelzoo.models.ckbert import CKBertConfig as JaxConfig

    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        CKBertLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.ckbert import CKBertConfig
    ids, mask = ids_and_mask(5, b=6)
    want, got, terms = _app_parity(
        JaxApp, CKBertLanguageModeling, JaxConfig(**TINY),
        CKBertConfig(**TINY),
        dict(input_ids=ids, attention_mask=mask,
             token_type_ids=np.zeros_like(ids)),
        dict(label_ids=mlm_labels(5, ids, mask)), train=True)
    assert "cls_view2" in want and "cls_view2" in got
    assert float(terms["contrastive_loss"]) > 0.1
    # eval mode runs the backbone once: no second view
    from easynlp_tpu_torch.modelzoo.models.ckbert import CKBertForPreTraining
    module = CKBertForPreTraining(CKBertConfig(**TINY)).eval()
    with torch.no_grad():
        out = module(torch.from_numpy(ids), torch.from_numpy(mask))
    assert set(out) == {"logits", "cls_view1"}


def kangaroo_inputs(seed, cfg, b=3, s=12, ss=6):
    """Entities at two spans of row 0 and one of row 1; row 2 links none,
    so its sample rows are all padding (sample_mask 0)."""
    rng = np.random.RandomState(seed)
    ids, mask = ids_and_mask(seed, b=b, s=s, vocab=cfg["vocab_size"])
    ep = np.zeros((b, s), np.int32)
    ep[0, 2:4], ep[0, 6:8], ep[1, 3:5] = 1, 2, 1
    ep *= mask
    n, k = cfg["ent_num"], cfg["sample_num"]
    linked = np.array([2, 1, 0])
    tok = rng.randint(4, cfg["vocab_size"], (b, n, k, ss)).astype(np.int32)
    lengths = rng.randint(2, ss + 1, (b, n, k))
    smask = (np.arange(ss) < lengths[..., None]).astype(np.int32)
    smask *= (np.arange(n)[None, :, None, None] < linked[:, None, None,
                                                         None])
    tok = (tok * smask).astype(np.int32)
    pos = np.broadcast_to(np.arange(ss), tok.shape).astype(np.int32) * smask
    concept = (rng.standard_normal((b, n, cfg["concept_size"]))
               * (np.arange(n)[None, :, None] < linked[:, None, None])
               ).astype(np.float32)
    inputs = dict(input_ids=ids, attention_mask=mask, entities_position=ep,
                  ent_mask=(ep != 0).astype(np.int32), sample_token_id=tok,
                  sample_position_id=pos, sample_mask=smask,
                  concept_emb=concept)
    return inputs, dict(label_ids=mlm_labels(seed, ids, mask,
                                             vocab=cfg["vocab_size"]))


def test_kangaroo_matches_jax():
    """layer_types sim, norm, mix: logits, cos_score, sample_label, the MLM
    and contrast losses and the gradients, with a row that links no entity
    (its samples fully masked: attention gives those rows the mean of V,
    and no entity index gathers them)."""
    from easynlp_tpu.appzoo.language_modeling.model import (
        KangarooLanguageModeling as JaxApp)
    from easynlp_tpu.modelzoo.models.kangaroo import (
        KangarooConfig as JaxConfig)

    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        KangarooLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.kangaroo import KangarooConfig
    inputs, batch = kangaroo_inputs(6, KANGAROO)
    assert inputs["sample_mask"][2].sum() == 0
    want, got, terms = _app_parity(
        JaxApp, KangarooLanguageModeling, JaxConfig(**KANGAROO),
        KangarooConfig(**KANGAROO), inputs, batch)
    assert {"cos_score", "sample_label"} <= set(want)
    assert {"mlm_loss", "contrast_loss"} <= set(terms)
    assert (got["sample_label"][2] == -100).all()


def test_kangaroo_checkpoint_keeps_reference_names():
    """The port's Kangaroo checkpoint (export_state_dict) is under the
    reference torch names: the JAX package's convert_kangaroo reads it
    back to the JAX params bit for bit (the MLM head under
    `cls.predictions.transform.*`, which BertMLMHead calls `dense` and
    `LayerNorm`), and it loads back into the module strictly."""
    from easynlp_tpu.appzoo.language_modeling.model import (
        KangarooLanguageModeling as JaxApp)
    from easynlp_tpu.modelzoo.models.kangaroo import (
        KangarooConfig as JaxConfig)
    from easynlp_tpu.modelzoo.models.kangaroo.modeling_kangaroo import (
        convert_kangaroo)

    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        KangarooLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.kangaroo import KangarooConfig
    jcfg, pcfg = JaxConfig(**KANGAROO), KangarooConfig(**KANGAROO)
    params = noisy(JaxApp.init_params(
        JaxApp.build_module(jcfg, dtype=jnp.float32), jcfg, 0))
    module = KangarooLanguageModeling.build_module(pcfg, device="cpu")
    module.load_state_dict(KangarooLanguageModeling.state_dict_from_jax(
        params, pcfg), strict=True)
    state = KangarooLanguageModeling(module, pcfg, "cpu").export_state_dict()
    assert "cls.predictions.transform.dense.weight" in state
    back = convert_kangaroo({k: v.numpy() for k, v in state.items()}, jcfg)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf),
                                      err_msg=str(path))
    again = KangarooLanguageModeling.build_module(pcfg, device="cpu")
    KangarooLanguageModeling.load_state_dict(again, state)
    for k, v in module.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_kangaroo_remat_checkpoints_nothing(tmp_path):
    """As the JAX KangarooForPreTraining, which never passes remat to its
    model, --remat does nothing to Kangaroo: no layer takes a policy, and
    the loss and gradients under `full` are none's bit for bit."""
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        KangarooLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        set_remat)
    from easynlp_tpu_torch.modelzoo.models.kangaroo import KangarooConfig
    cfg = KangarooConfig(**KANGAROO)
    inputs, batch = kangaroo_inputs(7, KANGAROO)
    module = KangarooLanguageModeling.build_module(cfg, device="cpu")
    module.init_weights(torch.Generator().manual_seed(0))
    assert not any(hasattr(m, "remat") for m in module.modules())
    runs = []
    for policy in ("none", "full"):
        set_remat(module, policy)
        module.zero_grad()
        out = module(**{k: torch.from_numpy(v) for k, v in inputs.items()})
        loss = KangarooLanguageModeling.loss_fn(
            out, {k: torch.from_numpy(v) for k, v in batch.items()})["loss"]
        loss.backward()
        runs.append((loss.detach(), [p.grad for p in module.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(runs[0][1], runs[1][1]))


def test_dkplm_remat_reaches_the_encoder():
    """--remat reaches DKPLM's BERT layers, as the JAX module's remat
    does: under full and selective every layer takes the policy, and the
    loss and gradients are none's bit for bit."""
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        DKPLMLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        BertLayer, set_remat)
    from easynlp_tpu_torch.modelzoo.models.dkplm import DKPLMConfig
    module = DKPLMLanguageModeling.build_module(
        DKPLMConfig(knowledge_emb_size=8, **TINY), device="cpu")
    module.init_weights(torch.Generator().manual_seed(0))
    ids, mask = ids_and_mask(9)
    rng = np.random.RandomState(9)
    inputs = {"input_ids": torch.from_numpy(ids),
              "attention_mask": torch.from_numpy(mask),
              "insert_know_emb": torch.from_numpy(
                  rng.standard_normal(ids.shape + (8,)).astype(np.float32)),
              "insert_know_position_mask": torch.from_numpy(
                  (rng.rand(*ids.shape) < 0.3).astype(np.int32))}
    batch = {"label_ids": torch.from_numpy(mlm_labels(9, ids, mask))}
    runs = {}
    for policy in ("none", "full", "selective"):
        set_remat(module, policy)
        assert all(m.remat == policy for m in module.modules()
                   if isinstance(m, BertLayer))
        module.zero_grad()
        loss = DKPLMLanguageModeling.loss_fn(module(**inputs), batch)["loss"]
        loss.backward()
        runs[policy] = (loss.detach(), [p.grad.clone()
                                        for p in module.parameters()])
    for policy in ("full", "selective"):
        assert torch.equal(runs[policy][0], runs["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(runs[policy][1],
                                                     runs["none"][1]))


# --------------------------------------------------------------------------
# width refusals
# --------------------------------------------------------------------------

class _Stand:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("name", ["concept_size", "ent_num", "sample_num"])
def test_kangaroo_width_refusal(name):
    """A dataset whose concept_size, ent_num or sample_num differ from the
    config's is refused before the first step, naming both (flax infers
    linear2's width at init and fails later with a shape error)."""
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        KangarooLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.kangaroo import KangarooConfig
    cfg = KangarooConfig(**KANGAROO)
    app = KangarooLanguageModeling(None, cfg, "cpu")
    widths = {k: getattr(cfg, k) for k in ("concept_size", "ent_num",
                                           "sample_num")}
    app.check_dataset(_Stand(**widths))
    widths[name] += 95
    with pytest.raises(ValueError, match=r"%s=%d.*%s=%d" % (
            name, getattr(cfg, name), name, widths[name])):
        app.check_dataset(_Stand(**widths))


def test_dkplm_width_refusal():
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        DKPLMLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.dkplm import DKPLMConfig
    app = DKPLMLanguageModeling(None, DKPLMConfig(**TINY), "cpu")
    app.check_dataset(_Stand(knowledge_emb_size=200))
    with pytest.raises(ValueError, match="100 wide.*knowledge_emb_size is "
                                         "200"):
        app.check_dataset(_Stand(knowledge_emb_size=100))


# --------------------------------------------------------------------------
# AutoConfig, AutoModel, AutoTokenizer
# --------------------------------------------------------------------------

def _model_dir(path, model_type, **extra):
    from make_fixtures import make_pretrained
    make_pretrained(str(path))
    with open(path / "config.json") as f:
        config = json.load(f)
    config.update(TINY, model_type=model_type, **extra)
    config["vocab_size"] = sum(1 for _ in open(path / "vocab.txt"))
    with open(path / "config.json", "w") as f:
        json.dump(config, f)
    return config


@pytest.mark.parametrize("model_type,cls_name", [
    ("megatron_bert", "MegatronBertModel"), ("kbert", "KBertModel"),
    ("dkplm", "DKPLMModel"), ("kangaroo", "KangarooModel"),
    ("ckbert", "CKBertForPreTraining"), ("bert", "BertModel")])
def test_auto_model_round_trip(tmp_path, model_type, cls_name):
    """AutoConfig, AutoModel and AutoTokenizer on a directory of each
    family: the module's weights under the reference names (its own state
    dict; CKBERT's BertForMaskedLM's HF names) written as
    pytorch_model.bin load back strictly and bit for bit with no
    converter, and the tokenizer is WordPiece."""
    from easynlp_tpu_torch.modelzoo.models import auto
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    extra = dict(KANGAROO) if model_type == "kangaroo" else {}
    if model_type == "dkplm":
        extra["knowledge_emb_size"] = 8
    _model_dir(tmp_path, model_type, **extra)
    config = auto.AutoConfig.from_pretrained(str(tmp_path))
    assert config.model_type == model_type
    module = auto.AutoModel.from_config(config, device="cpu")
    assert type(module).__name__ == cls_name
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=g))
    state = module.state_dict()
    if model_type == "ckbert":  # BertForMaskedLM's HF names
        from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
            export_mlm_state_dict)
        state = export_mlm_state_dict(module)
    torch.save(state, tmp_path / "pytorch_model.bin")
    loaded = auto.AutoModel.from_pretrained(str(tmp_path), device="cpu")
    assert not loaded.training
    for k, v in module.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert isinstance(auto.AutoTokenizer.from_pretrained(str(tmp_path)),
                      BertTokenizer)


@pytest.mark.parametrize("model_type", ["glm", "bloom", "clip", "cnn"])
def test_auto_refuses_unported_families(tmp_path, model_type):
    """bloom and cnn raise naming their ROADMAP item. glm and clip, which
    raised until slices 11 and 12, give their config, model and
    tokenizer."""
    from easynlp_tpu_torch.modelzoo.models import auto
    if model_type == "clip":
        config = _model_dir(tmp_path, model_type)
        config.update(text_config=dict(TINY, vocab_size=config["vocab_size"]),
                      vision_config=dict(image_size=16, patch_size=8,
                                         hidden_size=16, num_hidden_layers=1,
                                         num_attention_heads=2,
                                         intermediate_size=32),
                      projection_dim=8)
        with open(tmp_path / "config.json", "w") as f:
            json.dump(config, f)
        config = auto.AutoConfig.from_pretrained(str(tmp_path))
        module = auto.AutoModel.from_config(config, device="cpu")
        assert type(module).__name__ == "CLIPModel"
        assert module.text_model.config.hidden_size == TINY["hidden_size"]
        from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
        tok = auto.AutoTokenizer.from_pretrained(str(tmp_path))
        assert isinstance(tok, BertTokenizer)
        return
    _model_dir(tmp_path, model_type)
    if model_type == "glm":
        from test_torch_glm import write_glm_sp_model
        write_glm_sp_model(str(tmp_path / "spiece.model"))
        config = auto.AutoConfig.from_pretrained(str(tmp_path))
        module = auto.AutoModel.from_config(config, device="cpu")
        assert type(module).__name__ == "GLMForConditionalGeneration"
        tok = auto.AutoTokenizer.from_pretrained(str(tmp_path))
        assert type(tok).__name__ == "GLMTokenizer"
        return
    item = auto.NOT_PORTED[model_type]
    for cls in (auto.AutoConfig, auto.AutoModel, auto.AutoTokenizer):
        with pytest.raises(NotImplementedError, match="ROADMAP " + item):
            cls.from_pretrained(str(tmp_path))


def test_auto_model_reads_a_jax_checkpoint(tmp_path):
    """AutoModel on a directory holding only the JAX package's
    flax_params.msgpack of a DKPLMModel: the weights state_dict_from_jax
    gives, bit for bit."""
    from easynlp_tpu.modelzoo.modeling_utils import save_params
    from easynlp_tpu.modelzoo.models.dkplm import (DKPLMConfig as JaxConfig,
                                                   DKPLMModel as JaxModel)

    from easynlp_tpu_torch.modelzoo.models import auto
    from easynlp_tpu_torch.modelzoo.models.dkplm.modeling_dkplm import (
        state_dict_from_jax)
    config = _model_dir(tmp_path, "dkplm", knowledge_emb_size=8)
    ids, mask = ids_and_mask(8, vocab=config["vocab_size"])
    jcfg = JaxConfig(**{k: v for k, v in config.items()
                        if k != "model_type"})
    params = init_jax(JaxModel(config=jcfg), input_ids=ids,
                      insert_know_emb=np.zeros(ids.shape + (8,), np.float32))
    save_params(params, str(tmp_path))
    module = auto.AutoModel.from_pretrained(str(tmp_path), device="cpu")
    for k, v in state_dict_from_jax(params, module.config).items():
        assert torch.equal(module.state_dict()[k], v), k


def test_auto_model_reference_fault_22(tmp_path, monkeypatch):
    """ROADMAP reference fault 22: the JAX AutoModel loads none of
    megatron_bert, kbert, dkplm, kangaroo and ckbert from a
    pytorch_model.bin ("no converter"), though convert_megatron_bert,
    convert_kbert and convert_kangaroo exist; the port's modules keep the
    reference names and load with no converter."""
    from easynlp_tpu.modelzoo.models.auto.auto_factory import (
        AutoModel as JaxAutoModel)

    from easynlp_tpu_torch.modelzoo.models import auto
    _, hf = _hf_megatron(monkeypatch)
    hf.config.model_type = "megatron_bert"
    hf.save_pretrained(str(tmp_path), safe_serialization=False)
    with open(tmp_path / "config.json") as f:
        cfg = json.load(f)
    cfg["model_type"] = "megatron_bert"  # the JAX package's spelling
    with open(tmp_path / "config.json", "w") as f:
        json.dump(cfg, f)
    with pytest.raises(NotImplementedError, match="no converter"):
        JaxAutoModel.from_pretrained(str(tmp_path))
    port = auto.AutoModel.from_pretrained(str(tmp_path), device="cpu")
    for k, v in hf.state_dict().items():
        if k in port.state_dict():
            assert torch.equal(port.state_dict()[k], v), k
    assert set(port.state_dict()) <= set(hf.state_dict())


# --------------------------------------------------------------------------
# --remat with enable_lora (repaired)
# --------------------------------------------------------------------------

def test_lora_trains_under_remat_bit_for_bit(tmp_path):
    """enable_lora (adapters on every query, value and dense weight, so
    some sit inside each layer's checkpointed region under every policy)
    at --remat=full and selective gives the 4 losses and the trained
    adapters of --remat=none bit for bit, and the base stays frozen. The
    recompute reads the merged weights: each adapted weight's
    parametrization merges it wherever it is read. The port is held to itself: the
    JAX package's LoRA adapts no leaf of its scanned BERT (reference fault
    19), so it has nothing to compare under remat."""
    from make_fixtures import make_tsv
    from test_torch_text_match import make_bert_dir, run_port
    make_bert_dir(str(tmp_path / "model"), heads={"classifier": 2})
    make_tsv(str(tmp_path / "train.tsv"), 32, seed=1)
    runs = {}
    for policy in ("none", "full", "selective"):
        ckpt = str(tmp_path / policy)
        trainer = run_port([
            "--mode=train", "--tables=%s/train.tsv" % tmp_path,
            "--pretrained_model_name_or_path=%s/model" % tmp_path,
            "--checkpoint_dir=" + ckpt, "--epoch_num=1",
            "--learning_rate=1e-2", "--logging_steps=1",
            "--user_defined_parameters=enable_lora=true lora_rank=2 "
            "lora_targets=query,value,dense",
            "--app_name=text_classify",
            "--input_schema=id:str:1,sent:str:1,label:str:1",
            "--first_sequence=sent", "--label_name=label",
            "--sequence_length=16", "--micro_batch_size=8",
            "--dtype=float32", "--remat=" + policy])
        runs[policy] = (
            [r["loss"] for r in trainer.step_records],
            torch.load(os.path.join(ckpt, "pytorch_model_lora.bin"),
                       weights_only=True),
            torch.load(os.path.join(ckpt, "pytorch_model_base.bin"),
                       weights_only=True))
    losses, adapters, base = runs["none"]
    assert len(losses) == 4
    start = torch.load(str(tmp_path / "model" / "pytorch_model.bin"),
                       weights_only=True)
    for k, v in start.items():
        if k in base:
            assert torch.equal(base[k], v), k
    for policy in ("full", "selective"):
        assert runs[policy][0] == losses, policy
        assert set(runs[policy][1]) == set(adapters)
        for k, v in adapters.items():
            assert torch.equal(runs[policy][1][k], v), (policy, k)
    assert any(float(v.abs().max()) > 0 for k, v in adapters.items()
               if k.endswith(".lora_b"))
