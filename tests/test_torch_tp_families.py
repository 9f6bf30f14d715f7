"""Tensor parallelism for every family the JAX package annotates.

Each family's tiny module (2 layers, 4 heads, narrow widths) is run by two
gloo ranks on the CPU over a tensor=2 mesh (tests/torch_mesh_tasks.py,
one process start for every case) and held, in f32:

- against the JAX module applied on one device to the same numpy weights:
  the outputs within JAX_ATOL (1e-4, chip_smoke's TP_LOGITS_ATOL), the
  whole gradients of a fixed probe of them against jax.grad of the same
  probe (carried to the port's names by the family's state_dict_from_jax)
  within JAX_GRAD_RTOL of each parameter's largest entry, or
  JAX_GRAD_FLOOR (the key projections' biases get no true gradient, only
  rounding), BART's greedy and beam tokens and ARTIST's image codes and
  greedy codes equal;
- against the port's own one-process run: the outputs within ONE_ATOL
  plus ONE_RTOL and
  the whole gradients of a fixed probe of them within GRAD_ATOL (the sums
  over the group reorder a few f32 additions), and the split parameters
  local to each rank.

BART, Pegasus, T5, mT5 (tied, and untied, whose head JAX cannot build:
one process only), BLOOM, CLIP, ARTIST, DKPLM, Kangaroo, K-BERT and
TextCNN; and int8 weights under a tensor axis, which parallelize refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_tasks as T
from torch_parallel_workers import run_ranks

JAX_ATOL = 1e-4
# against jax.grad: two frameworks' f32 sums in other orders (the bound of
# the families' own gradient tests, test_torch_t5.py and the others)
JAX_GRAD_RTOL, JAX_GRAD_FLOOR = 1e-4, 1e-6
# against one process: the group's sums reorder f32 additions, which
# reach a few ulps of the largest activations (|x| near 10 in mT5's
# noisy tiny weights) by the logits
ONE_ATOL, ONE_RTOL = 5e-5, 1e-5
GRAD_ATOL = 1e-5


def _np(state):
    return {k: v.detach().numpy().copy() for k, v in state.items()}


def _init(module, seed=0, **inputs):
    """test_torch_knowledge.init_jax's params (noisy), initialised under
    one jit compile rather than op by op."""
    from flax import linen as nn
    from test_torch_knowledge import noisy
    rng = jax.random.PRNGKey(seed)
    params = jax.jit(lambda x: module.init(
        {"params": rng, "dropout": rng}, **x, deterministic=True))(
        {k: jnp.asarray(v) for k, v in inputs.items()})["params"]
    return noisy(nn.unbox(params), seed)


def _jax_grads(apply, params, keys, to_port, masks=None):
    """(the JAX outputs `apply(params)`, jax.grad of
    torch_mesh_tasks.probe_loss over them on the port's names through
    `to_port`), in one compile; each key's probe weights times its mask
    where `masks` has one."""
    def loss(p):
        out, total = apply(p), 0.0
        for k in keys:
            v = out[k].astype(jnp.float32)
            w = jnp.cos(jnp.arange(v.size, dtype=jnp.float32)).reshape(
                v.shape)
            if masks and k in masks:
                w = w * masks[k]
            total = total + (v * w).mean()
        return total, out
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return out, {k: np.asarray(v) for k, v in
                 to_port(jax.tree.map(np.asarray, grads)).items()}


def _apply_fn(module, deterministic=True, **inputs):
    x = {k: jnp.asarray(v) for k, v in inputs.items()}
    if deterministic:
        return lambda p: module.apply({"params": p}, **x, deterministic=True)
    return lambda p: module.apply({"params": p}, **x)


# ------------------------------------------------------------ the families

def _seq2seq(name):
    from test_torch_bart import TINY, _batch, _models
    from test_torch_pegasus import FAMILIES, family_state_dict
    from easynlp_tpu.modelzoo.models.bart import BartForConditionalGeneration
    from easynlp_tpu.modelzoo.models.bart.conversion import (
        convert_bart_state_dict)
    from easynlp_tpu.modelzoo.seq2seq_generation import (
        encoder_decoder_generate as jax_generate)
    from easynlp_tpu_torch.modelzoo.models.bart.conversion import (
        normalize_keys, state_dict_from_jax)
    if name == "bart":
        jax_model, params, model = _models()
        ctor, cfg = "BartForConditionalGeneration", "BartConfig"
        kwargs = TINY
    else:
        port_cfg, jax_cfg, kwargs, model_cls = FAMILIES["pegasus"]
        config = port_cfg(**kwargs)
        state = family_state_dict(config)
        model = model_cls(config).eval()
        model.load_state_dict(normalize_keys(
            {k: torch.from_numpy(v) for k, v in state.items()}, config),
            strict=True)
        jax_config = jax_cfg(**kwargs)
        params = convert_bart_state_dict(state, jax_config)
        jax_model = BartForConditionalGeneration.from_config(
            jax_config, dtype=jnp.float32)
        ctor, cfg = "PegasusForConditionalGeneration", "PegasusConfig"
    ids, mask = _batch(0, [9, 4], 9)
    dec, dec_mask = _batch(1, [5, 2], 5)
    gen_ids, gen_mask = _batch(2, [9, 6], 9)
    inputs = dict(input_ids=ids, attention_mask=mask, decoder_input_ids=dec,
                  decoder_attention_mask=dec_mask)
    want, grads = _jax_grads(_apply_fn(jax_model, **inputs), params,
                             ("logits",),
                             lambda g: state_dict_from_jax(g, model.config))
    calls, want_calls = {}, {}
    for beams in (1, 3) if name == "bart" else ():
        key = "beams%d" % beams
        calls[key] = ("torch_mesh_tasks:bart_generate", dict(
            ids=gen_ids, mask=gen_mask, max_length=12, num_beams=beams))
        want_calls[key] = np.asarray(jax_generate(
            jax_model, params, jnp.asarray(gen_ids), jnp.asarray(gen_mask),
            max_length=12, num_beams=beams))
    module = ("easynlp_tpu_torch.modelzoo.models.bart" if name == "bart"
              else "easynlp_tpu_torch.modelzoo.models.pegasus")
    case = dict(ctor=module + ":" + ctor,
                config=("easynlp_tpu_torch.modelzoo.models.bart:" + cfg,
                        kwargs),
                state=_np(model.state_dict()), inputs=inputs,
                calls=calls, probe=("logits",))
    return case, {"logits": want["logits"],
                  "encoder_last_hidden_state":
                  want["encoder_last_hidden_state"]}, want_calls, grads


def _t5(name):
    from test_torch_t5 import FAMILIES, T5_TINY, _batch, jax_params
    from test_torch_t5 import port_model
    from easynlp_tpu.modelzoo.models.t5 import T5ForConditionalGeneration
    from easynlp_tpu_torch.modelzoo.models.t5 import MT5Config
    from easynlp_tpu_torch.modelzoo.models.t5.conversion import (
        state_dict_from_jax)
    ids, mask = _batch(0, [9, 6], 9)
    dec, dec_mask = _batch(1, [5, 3], 5)
    inputs = dict(input_ids=ids, attention_mask=mask, decoder_input_ids=dec,
                  decoder_attention_mask=dec_mask)
    cfg_name = "T5Config" if name == "t5" else "MT5Config"
    kwargs = dict(T5_TINY)
    if name == "mt5-untied":
        kwargs["tie_word_embeddings"] = False
        model = port_model(MT5Config(**kwargs))
        want = grads = None
    else:
        port_cls, jax_cls, extra = FAMILIES[name]
        kwargs.update(extra)
        model = port_model(port_cls(**kwargs))
        jax_config = jax_cls(**kwargs)
        jax_model = T5ForConditionalGeneration.from_config(
            jax_config, dtype=jnp.float32)
        params = jax_params(model, jax_config)
        out, grads = _jax_grads(
            _apply_fn(jax_model, **inputs), params, ("logits",),
            lambda g: state_dict_from_jax(g, model.config))
        want = {"logits": out["logits"]}
    case = dict(ctor="easynlp_tpu_torch.modelzoo.models.t5:"
                "T5ForConditionalGeneration",
                config=("easynlp_tpu_torch.modelzoo.models.t5:" + cfg_name,
                        kwargs),
                state=_np(model.state_dict()), inputs=inputs,
                probe=("logits",))
    return case, want, {}, grads


def _bloom(_):
    from test_torch_cnn_bloom import BLOOM
    from test_torch_knowledge import ids_and_mask
    from easynlp_tpu.modelzoo.models.bloom import modeling_bloom as JB
    from easynlp_tpu_torch.modelzoo.models.bloom import modeling_bloom as PB
    ids, mask = ids_and_mask(1, b=3, s=9)
    module = JB.BloomForCausalLM(config=JB.BloomConfig(**BLOOM))
    params = _init(module, input_ids=ids, attention_mask=mask)
    # padded rows' positions differ by design (JAX's ALiBi at padding): the
    # probe reads the real rows
    real = mask.astype(bool)
    probe_mask = mask.astype(np.float32)[..., None]
    want, grads = _jax_grads(
        _apply_fn(module, input_ids=ids, attention_mask=mask), params,
        ("logits",), lambda g: PB.state_dict_from_jax(
            g, PB.BloomConfig(**BLOOM)), {"logits": probe_mask})
    mod = "easynlp_tpu_torch.modelzoo.models.bloom.modeling_bloom"
    case = dict(ctor=mod + ":BloomForCausalLM",
                config=(mod + ":BloomConfig", BLOOM),
                # the JAX module's exact GELU (fault 38)
                setup=[(mod + ":BLOOM_ACT", "gelu")],
                state=_np(PB.state_dict_from_jax(params,
                                                 PB.BloomConfig(**BLOOM))),
                inputs=dict(input_ids=ids, attention_mask=mask),
                probe=("logits",), probe_masks={"logits": probe_mask})
    return case, {"logits": (np.asarray(want["logits"]), real)}, {}, grads


def _clip(_):
    from test_torch_clip import _inputs, jax_apply, make_pair
    jax_app, app = make_pair()
    batch = _inputs(0)
    want = jax_apply(jax_app.module, jax_app.params, batch)
    _, grads = _jax_grads(
        _apply_fn(jax_app.module, False, **batch), jax_app.params,
        ("text_embeds", "image_embeds"),
        lambda g: type(app).state_dict_from_jax(g, app.config))
    cfg = app.config
    case = dict(ctor="easynlp_tpu_torch.appzoo.clip.model:CLIPApp", app=True,
                config=("easynlp_tpu_torch.modelzoo.models.clip:CLIPConfig",
                        dict(text_config=cfg.text_config.to_dict(),
                             vision_config=cfg.vision_config.to_dict(),
                             projection_dim=cfg.projection_dim)),
                state=_np(app.module.state_dict()), inputs=batch,
                probe=("text_embeds", "image_embeds"))
    return case, {k: want[k] for k in ("text_embeds", "image_embeds",
                                       "logits_per_text")}, {}, grads


def _artist(_):
    from test_torch_artist import CONFIGS, _batch, _jax_forward, make_pair
    jax_app, app, side = make_pair("deep")
    batch = _batch(0, side)
    want = _jax_forward(jax_app, batch)
    _, grads = _jax_grads(
        _apply_fn(jax_app.module, False, **batch), jax_app.params,
        ("logits", "vq_loss"),
        lambda g: type(app).state_dict_from_jax(g, app.config))
    gen = _batch(3, side, b=4, s=6)
    greedy = np.asarray(jax_app.generate(
        jnp.asarray(gen["input_ids"]), jnp.asarray(gen["attention_mask"]),
        do_sample=False))
    case = dict(ctor="easynlp_tpu_torch.appzoo.text2image_generation.model:"
                "TextImageGeneration", app=True,
                config=("easynlp_tpu_torch.modelzoo.models.artist."
                        "modeling_artist:ARTISTConfig", CONFIGS["deep"][0]),
                state=_np(app.module.state_dict()), inputs=batch,
                calls={"greedy": ("torch_mesh_tasks:artist_generate", dict(
                    ids=gen["input_ids"], mask=gen["attention_mask"]))},
                probe=("logits", "vq_loss"))
    return case, {k: want[k] for k in ("logits", "image_codes", "vq_loss",
                                       "reconstruction")}, {
        "greedy": greedy}, grads


def _knowledge_app(name):
    from test_torch_knowledge import (KANGAROO, TINY, ids_and_mask,
                                      kangaroo_inputs, noisy)
    lm = "easynlp_tpu.appzoo.language_modeling.model"
    if name == "dkplm":
        from easynlp_tpu.modelzoo.models.dkplm import DKPLMConfig as JC
        from easynlp_tpu_torch.modelzoo.models.dkplm import DKPLMConfig
        ids, mask = ids_and_mask(4)
        b, s = ids.shape
        rng = np.random.RandomState(4)
        know_mask = np.zeros((b, s), np.int32)
        know_mask[:, 1:3] = 1
        know_mask *= mask
        know = (rng.standard_normal((b, s, 8)) * know_mask[..., None]
                ).astype(np.float32)
        kw = dict(TINY, knowledge_emb_size=8)
        inputs = dict(input_ids=ids, attention_mask=mask,
                      token_type_ids=np.zeros_like(ids),
                      insert_know_emb=know,
                      insert_know_position_mask=know_mask)
        app_name, cfg_path = "DKPLMLanguageModeling", \
            "easynlp_tpu_torch.modelzoo.models.dkplm:DKPLMConfig"
        pcfg, jcfg = DKPLMConfig(**kw), JC(**kw)
    else:
        from easynlp_tpu.modelzoo.models.kangaroo import KangarooConfig as JC
        from easynlp_tpu_torch.modelzoo.models.kangaroo import (
            KangarooConfig)
        kw = KANGAROO
        inputs, _ = kangaroo_inputs(6, KANGAROO)
        app_name, cfg_path = "KangarooLanguageModeling", \
            "easynlp_tpu_torch.modelzoo.models.kangaroo:KangarooConfig"
        pcfg, jcfg = KangarooConfig(**kw), JC(**kw)
    import importlib
    jax_app = getattr(importlib.import_module(lm), app_name)
    port_app = getattr(importlib.import_module(
        "easynlp_tpu_torch.appzoo.language_modeling.model"), app_name)
    jmodule = jax_app.build_module(jcfg, dtype=jnp.float32)
    params = noisy(jax.jit(lambda: jax_app.init_params(jmodule, jcfg, 0))())
    want, grads = _jax_grads(
        _apply_fn(jmodule, **inputs), params, ("logits",),
        lambda g: port_app.state_dict_from_jax(g, pcfg))
    case = dict(ctor="easynlp_tpu_torch.appzoo.language_modeling.model:"
                + app_name, app=True, config=(cfg_path, kw),
                state=_np(port_app.state_dict_from_jax(params, pcfg)),
                inputs=inputs, probe=("logits",))
    return case, {"logits": want["logits"]}, {}, grads


def _kbert(_):
    from test_torch_knowledge import TINY, ids_and_mask
    from easynlp_tpu.modelzoo.models.kbert import KBertConfig as JC
    from easynlp_tpu.modelzoo.models.kbert import KBertModel as JM
    from easynlp_tpu_torch.modelzoo.models.kbert import KBertConfig
    from easynlp_tpu_torch.modelzoo.models.kbert.modeling_kbert import (
        state_dict_from_jax)
    ids, mask = ids_and_mask(3)
    b, s = ids.shape
    rng = np.random.RandomState(3)
    visible = (rng.rand(b, s, s) > 0.3).astype(np.int32)
    visible[:, np.arange(s), np.arange(s)] = 1
    inputs = dict(input_ids=ids, attention_mask=mask, visible_matrix=visible)
    jmodule = JM(config=JC(**TINY), dtype=jnp.float32)
    params = _init(jmodule, **inputs)
    want, grads = _jax_grads(_apply_fn(jmodule, **inputs), params,
                       ("last_hidden_state", "pooler_output"),
                       lambda g: state_dict_from_jax(g, KBertConfig(**TINY)))
    case = dict(ctor="easynlp_tpu_torch.modelzoo.models.kbert:KBertModel",
                config=("easynlp_tpu_torch.modelzoo.models.kbert:KBertConfig",
                        TINY),
                state=_np(state_dict_from_jax(params, KBertConfig(**TINY))),
                inputs={k: v.astype(np.int64) for k, v in inputs.items()},
                probe=("last_hidden_state", "pooler_output"))
    return case, {k: want[k] for k in ("last_hidden_state",
                                       "pooler_output")}, {}, grads


def _textcnn(_):
    from test_torch_knowledge import ids_and_mask
    from easynlp_tpu.modelzoo.models.cnn import modeling_cnn as JC
    from easynlp_tpu_torch.modelzoo.models.cnn import modeling_cnn as PC
    # a vocabulary of 61 rows: the split pads it with one zero row
    kw = dict(vocab_size=61, embedding_size=16, kernel_sizes=(2, 3),
              num_filters=8, hidden_dropout_prob=0.0)
    ids, mask = ids_and_mask(0, b=4, s=10, vocab=61)
    module = JC.TextCNNModel(config=JC.TextCNNConfig(**kw))
    params = _init(module, input_ids=ids, attention_mask=mask)
    want, grads = _jax_grads(
        _apply_fn(module, input_ids=ids, attention_mask=mask), params,
        ("pooler_output",),
        lambda g: PC.state_dict_from_jax(g, PC.TextCNNConfig(**kw)))
    mod = "easynlp_tpu_torch.modelzoo.models.cnn.modeling_cnn"
    case = dict(ctor=mod + ":TextCNNModel",
                config=(mod + ":TextCNNConfig", kw),
                state=_np(PC.state_dict_from_jax(params,
                                                 PC.TextCNNConfig(**kw))),
                inputs=dict(input_ids=ids, attention_mask=mask),
                probe=("pooler_output",))
    return case, {"pooler_output": want["pooler_output"]}, {}, grads


FAMILIES = {"bart": _seq2seq, "pegasus": _seq2seq, "t5": _t5,
            "mt5-tied": _t5, "mt5-untied": _t5, "bloom": _bloom,
            "clip": _clip, "artist": _artist, "dkplm": _knowledge_app,
            "kangaroo": _knowledge_app, "kbert": _kbert,
            "textcnn": _textcnn}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{family: (case, JAX outputs, JAX calls, JAX gradients, the tensor=2
    ranks' results, the one-process result)} and the refusals, from one
    start of two ranks."""
    built = {name: make(name) for name, make in FAMILIES.items()}
    names = sorted(built)
    refused = {"int8": dict(built["bart"][0],
                            before="torch_mesh_tasks:quantize_int8")}
    ranks = run_ranks("mesh_cases", 2,
                      str(tmp_path_factory.mktemp("tp_families")),
                      {"cases": [built[n][0] for n in names],
                       "refused": refused},
                      mesh={"tensor": 2}, timeout=240)
    out = {}
    for i, name in enumerate(names):
        case, want, want_calls, jax_grads = built[name]
        out[name] = (case, want, want_calls, jax_grads,
                     [r["results"][i] for r in ranks], T.run_case(case))
    return out, [r["refused"] for r in ranks]


def _close(got, want, atol, what, rtol=0):
    mask = None
    if isinstance(want, tuple):
        want, mask = want
    got, want = np.asarray(got), np.asarray(want)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_tensor2_matches_jax_and_one_process(runs, family):
    case, want, want_calls, jax_grads, ranks, one = runs[0][family]
    for r, got in enumerate(ranks):
        # the tables split something, and the ranks hold halves
        assert got["specs"], family
        for name in got["specs"]:
            assert got["local_shapes"][name] != one["local_shapes"][name], \
                name
        for key, w in (want or {}).items():
            _close(got["out"][key], w, JAX_ATOL, "%s rank %d" % (key, r))
        for key, v in one["out"].items():
            if v.dtype.is_floating_point:
                _close(got["out"][key], v, ONE_ATOL, key, ONE_RTOL)
            else:
                np.testing.assert_array_equal(got["out"][key], v, key)
        assert set(got["grads"]) == set(one["grads"])
        moved = 0
        for name, g in one["grads"].items():
            _close(got["grads"][name], g, GRAD_ATOL, name)
            moved += bool(g.abs().max() > 1e-4)
            if jax_grads is not None:
                w = jax_grads[name].reshape(g.shape)
                _close(got["grads"][name], w, max(
                    JAX_GRAD_RTOL * np.abs(w).max(), JAX_GRAD_FLOOR),
                    "%s rank %d against jax.grad" % (name, r))
        assert moved > len(one["grads"]) // 2, family
        for name, w in want_calls.items():
            np.testing.assert_array_equal(got["calls"][name], w, name)
            np.testing.assert_array_equal(one["calls"][name], w, name)
            assert len(np.unique(w)) > 2, name


def test_int8_weights_under_tensor_are_refused(runs):
    for refused in runs[1]:
        assert "int8 weights under a tensor axis" in refused["int8"]
