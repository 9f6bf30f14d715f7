"""The port's GLM (slice 11, A19) against the JAX package's, on the CPU.

A tiny GLM (2 layers, hidden 32, 4 heads, vocab 40, 64 positions, dropout
0) is initialised by the JAX package and carried into the port through
conversion.state_dict_from_jax. Held to JAX, f32:

- logits of the block-infilling forward (per-row prefix lengths, 2-D
  positions, padding), the loss and every gradient (rtol 1e-4);
- the cached generation path step by step: the prefill on JAX's bias, and
  the decode steps and a shared-index verify chunk on the route the card
  sends to the kernels (cache mask plus causality at offset `index`),
  against JAX's bias result within 1e-5;
- generate: greedy, 3 beams, prompt-lookup speculative (each token for
  token), the Transformer-XL `stream_logits` (1e-5);
- the strict load of a reference-named checkpoint and the Megatron
  tensor-parallel merge (the merged dict bit for bit, the model's logits);
- GLMTokenizer's ids (command tokens included), and both GLM datasets
  (the cloze layout and the pretraining corruption for one seed over two
  epochs) bit for bit, the pretraining evaluator's metrics (1e-5).

The CLI test runs both GLM variants' train, evaluate and predict (greedy,
2 beams, speculative) in one fresh interpreter of the port's, which must
load no jax, flax or easynlp_tpu module.
"""

import json
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from easynlp_tpu.appzoo.language_modeling import glm_pretrain as JP
from easynlp_tpu.appzoo.sequence_generation import glm as JG
from easynlp_tpu.modelzoo.models.glm import conversion as JC
from easynlp_tpu.modelzoo.models.glm import modeling_glm as JM
from easynlp_tpu_torch.appzoo.language_modeling import glm_pretrain as PP
from easynlp_tpu_torch.appzoo.sequence_generation import glm as PG
from easynlp_tpu_torch.modelzoo.models.glm import conversion as PC
from easynlp_tpu_torch.modelzoo.models.glm import modeling_glm as PM
from test_torch_text_match import REPO, _restore_global_args  # noqa: F401

TINY = dict(vocab_size=40, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_sequence_length=64,
            embedding_dropout_prob=0.0, attention_dropout_prob=0.0,
            output_dropout_prob=0.0)
GMASK, SOP, EOP, PAD = 36, 37, 38, 0
SPECIAL = dict(gmask_id=GMASK, sop_id=SOP, eop_id=EOP, pad_id=PAD)
ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """(JAX app, port app) with the same weights."""
    cfg = JM.GLMConfig(**TINY)
    module = JG.GLMSequenceGeneration.build_module(cfg, dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, JG.GLMSequenceGeneration.init_params(module, cfg,
                                                         seed=3))
    jax_app = JG.GLMSequenceGeneration(module, params, cfg)
    config = PM.GLMConfig(**TINY)
    model = PM.GLMForConditionalGeneration(config)
    model.load_state_dict(PC.state_dict_from_jax(params, config),
                          strict=True)
    return jax_app, PG.GLMSequenceGeneration(model.eval(), config, "cpu")


def _cloze_batch(seed, b=3, s=14):
    """Random ids with GLM's 2-D positions, per-row prefix lengths and
    right padding."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 36, (b, s)).astype(np.int32)
    prefix = rng.randint(2, s - 4, b).astype(np.int32)
    lengths = np.minimum(prefix + rng.randint(2, 6, b), s)
    mask = (np.arange(s)[None] < lengths[:, None]).astype(np.int32)
    pos = np.where(np.arange(s)[None] < prefix[:, None], np.arange(s)[None],
                   prefix[:, None] - 1).astype(np.int32)
    blocks = np.maximum(np.arange(s)[None] - prefix[:, None] + 1,
                        0).astype(np.int32)
    labels = np.where((np.arange(s)[None] >= prefix[:, None]) & (mask == 1),
                      rng.randint(1, 36, (b, s)), -100).astype(np.int32)
    return dict(input_ids=ids, attention_mask=mask, position_ids=pos,
                block_position_ids=blocks, prefix_lengths=prefix,
                labels=labels)


def _jax_forward(jax_app, batch, **kw):
    return jax_app.module.apply(
        {"params": jax_app.params}, deterministic=True,
        **{k: jnp.asarray(batch[k]) for k in jax_app.model_input_keys
           if k in batch}, **kw)


def _port_forward(app, batch, **kw):
    return app.module(**{k: torch.from_numpy(batch[k])
                         for k in app.model_input_keys if k in batch}, **kw)


def test_logits_loss_and_gradients_match_jax(pair):
    jax_app, app = pair
    batch = _cloze_batch(0)
    want = np.asarray(_jax_forward(jax_app, batch)["logits"])
    app.module.train()
    try:
        out = _port_forward(app, batch)
        loss = app.loss_fn(out, {"labels": torch.from_numpy(
            batch["labels"])})["loss"]
        loss.backward()
    finally:
        app.module.eval()
    np.testing.assert_allclose(out["logits"].detach().numpy(), want,
                               atol=ATOL)

    def jax_loss(params):
        out = jax_app.module.apply(
            {"params": params}, deterministic=True,
            **{k: jnp.asarray(batch[k]) for k in jax_app.model_input_keys})
        return jax_app.loss_fn(out, {"labels": jnp.asarray(
            batch["labels"])})["loss"]

    jl, jgrads = jax.value_and_grad(jax_loss)(jax_app.params)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want_g = PC.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), app.config)
    for name, p in app.module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        p.grad = None


def test_cached_steps_match_jax_and_take_the_kernel_route(pair,
                                                          monkeypatch):
    """Prefill, two decode steps and a 3-token verify chunk through both
    packages' generation fns: logits within 1e-5 at every step, and the
    first three equal to one forward without a cache. The port's prefill
    passes JAX's bias; its decode steps and chunk pass none (the kernels'
    kv_mask + causal route), JAX's pass its bias."""
    jax_app, app = pair
    calls = []
    real = PM.attention

    def spy(q, k, v, kv_mask=None, causal=False, bias=None, **kw):
        calls.append((q.shape[1], bias is not None, causal))
        return real(q, k, v, kv_mask=kv_mask, causal=causal, bias=bias, **kw)

    monkeypatch.setattr(PM, "attention", spy)
    rng = np.random.RandomState(1)
    prompts = [list(rng.randint(1, 36, n)) + [GMASK, SOP] for n in (5, 8, 3)]
    from easynlp_tpu_torch.modelzoo.generation_utils import left_pad
    ids, mask = left_pad(prompts, PAD)
    total = ids.shape[1] + 10
    jp, jd = JG.make_glm_generation_fns(jax_app.module, total, cache_slack=4)
    pp, pd = PG.make_glm_generation_fns(app.module, total, cache_slack=4)
    with torch.inference_mode():
        jl, jc = jp(jax_app.params, jnp.asarray(ids), jnp.asarray(mask))
        pl, pc = pp(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
        assert calls and all(bias for _, bias, _ in calls)
        calls.clear()
        cached = [pl]
        for tok in (5, 9):
            t = np.full((3, 1), tok, np.int32)
            jl, jc = jd(jax_app.params, jnp.asarray(t), jc)
            pl, pc = pd(torch.from_numpy(t).long(), pc)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl),
                                       atol=ATOL)
            cached.append(pl)
        # the same three positions without a cache: one forward over the
        # prompt and the two tokens, GLM's 2-D positions, prefix p - 1
        steps = list(calls)
        p = ids.shape[1]
        m = torch.from_numpy(mask).long()
        mask_pos = m.sum(-1) - 2
        pos = (m.cumsum(-1) - 1).clamp(min=0)
        pos[:, -1] = mask_pos
        blocks = torch.zeros_like(pos)
        blocks[:, -1] = 1
        full = app.module(
            torch.cat([torch.from_numpy(ids).long(),
                       torch.tensor([[5, 9]] * 3)], 1),
            position_ids=torch.cat([pos, mask_pos[:, None].expand(3, 2)], 1),
            block_position_ids=torch.cat(
                [blocks, torch.tensor([[2, 3]] * 3)], 1),
            prefix_lengths=torch.full((3,), p - 1),
            attention_mask=torch.cat([m, torch.ones(3, 2).long()], 1))
        torch.testing.assert_close(full["logits"][:, p - 1:],
                                   torch.stack(cached, 1), atol=ATOL,
                                   rtol=0)
        calls[:] = steps
        chunk = rng.randint(1, 36, (3, 3)).astype(np.int32)
        jl, jc = jd.chunk(jax_app.params, jnp.asarray(chunk), jc)
        pl, pc = pd.chunk(torch.from_numpy(chunk).long(), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
        jc = jd.rollback(jc, 2)
        pc = pd.rollback(pc, 2)
        jl, jc = jd(jax_app.params, jnp.asarray(chunk[:, :1]), jc)
        pl, pc = pd(torch.from_numpy(chunk[:, :1]).long(), pc)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
    layers = TINY["num_layers"]
    assert calls == ([(1, False, False)] * layers * 2
                     + [(3, False, True)] * layers
                     + [(1, False, False)] * layers)


@pytest.mark.parametrize("kw", [{}, {"num_beams": 3},
                                {"speculative": "prompt_lookup",
                                 "num_draft_tokens": 3}],
                         ids=["greedy", "beams", "speculative"])
def test_generate_matches_jax(pair, kw):
    jax_app, app = pair
    rng = np.random.RandomState(2)
    motif = list(rng.randint(1, 36, 3))
    src = np.zeros((3, 12), np.int32)
    src[0, :12] = (motif * 4)[:12]
    src[1, :7] = rng.randint(1, 36, 7)
    src[2, :9] = (motif * 3)[:9]
    mask = (src != 0).astype(np.int32)
    want = np.asarray(jax_app.generate(jnp.asarray(src), jnp.asarray(mask),
                                       max_length=10, **SPECIAL, **kw))
    got = app.generate(src, mask, max_length=10, **SPECIAL, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    greedy = app.generate(src, mask, max_length=10, **SPECIAL).numpy()
    if "speculative" in kw:
        np.testing.assert_array_equal(got, greedy)


def test_stream_logits_match_jax(pair):
    """Transformer-XL segments (mem_length 8 over segments of 8) against
    JAX's, and the first segment against the plain causal forward."""
    jax_app, app = pair
    rng = np.random.RandomState(4)
    ids = rng.randint(1, 36, (2, 24)).astype(np.int32)
    want = np.asarray(jax_app.stream_logits(ids, segment_length=8,
                                            mem_length=8))
    got = app.stream_logits(ids, segment_length=8, mem_length=8).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    with torch.inference_mode():
        plain = app.module(torch.from_numpy(ids[:, :8]).long())["logits"]
    np.testing.assert_allclose(got[:, :8], plain.numpy(), atol=ATOL)


def _reference_state(app, rng):
    """The port's weights under the Megatron names (no `glm.` prefix,
    `transformer.` kept), each moved so no two tensors share values."""
    out = {}
    for k, v in app.module.state_dict().items():
        out[k[len("glm."):]] = (v.numpy() + 0.01 * rng.standard_normal(
            v.shape)).astype(np.float32)
    return out


def _split(state, ranks):
    """Megatron TP slices of a full state dict (the inverse of the merge:
    q|k|v sections split per rank, column/vocab rows, row-parallel
    weight columns; the rest replicated)."""
    slices = [{} for _ in range(ranks)]
    for k, v in state.items():
        if "query_key_value" in k:
            parts = [np.split(sec, ranks, axis=0)
                     for sec in np.split(v, 3, axis=0)]
            for r in range(ranks):
                slices[r][k] = np.concatenate([p[r] for p in parts], axis=0)
        elif any(m in k for m in ("dense_h_to_4h", "word_embeddings")):
            for r, part in enumerate(np.split(v, ranks, axis=0)):
                slices[r][k] = part
        elif any(m in k for m in ("attention.dense", "dense_4h_to_h")) \
                and k.endswith(".weight"):
            for r, part in enumerate(np.split(v, ranks, axis=1)):
                slices[r][k] = part
        else:
            for r in range(ranks):
                slices[r][k] = v
    return slices


def test_strict_load_and_tensor_parallel_merge(pair, tmp_path):
    """Two Megatron mp_rank slices merge (both packages' merges, bit for
    bit) and load strictly onto one model; its logits equal JAX's on
    convert_glm of the same dict. A reference-named pytorch_model.bin
    (HF's `glm.` prefix) loads strictly through the app."""
    _, app = pair
    state = _reference_state(app, np.random.RandomState(5))
    slices = _split(state, 2)
    merged = PC.merge_megatron_tp_slices(slices)
    jax_merged = JC.merge_megatron_tp_slices(slices)
    assert set(merged) == set(jax_merged) == set(state)
    for k in state:
        np.testing.assert_array_equal(merged[k], jax_merged[k], err_msg=k)
        np.testing.assert_array_equal(merged[k], state[k], err_msg=k)
    for r, sl in enumerate(slices):
        os.makedirs(tmp_path / ("mp_rank_%02d" % r))
        torch.save({"module": {k: torch.from_numpy(v)
                               for k, v in sl.items()}},
                   tmp_path / ("mp_rank_%02d" % r) / "model_optim_rng.pt")
    config = PM.GLMConfig(**TINY)
    model = PM.GLMForConditionalGeneration(config).eval()
    model.load_state_dict(PC.load_megatron_glm_checkpoint(str(tmp_path)),
                          strict=True)
    params = {"glm": JC.convert_glm(jax_merged, JM.GLMConfig(**TINY))}
    jax_module = JM.GLMForConditionalGeneration(JM.GLMConfig(**TINY),
                                                dtype=jnp.float32)
    batch = _cloze_batch(6)
    want = jax_module.apply({"params": params}, deterministic=True,
                            **{k: jnp.asarray(v) for k, v in batch.items()
                               if k != "labels"})["logits"]
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in batch.items()
                       if k != "labels"})["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    hf = {"glm." + k: torch.from_numpy(v) for k, v in state.items()}
    fresh = PM.GLMForConditionalGeneration(config)
    PG.GLMSequenceGeneration.load_state_dict(fresh, hf)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def write_glm_sp_model(path, n=200):
    sys.path.insert(0, REPO)
    import chip_smoke
    pieces = chip_smoke.t5_sp_pieces(random.Random(0), n)
    with open(path, "wb") as f:
        f.write(chip_smoke.sp_model_bytes(pieces))


def test_tokenizer_ids_match_jax(tmp_path):
    from easynlp_tpu.modelzoo.models.glm import GLMTokenizer as JaxTok

    from easynlp_tpu_torch.modelzoo.models.auto import AutoTokenizer
    from easynlp_tpu_torch.modelzoo.models.glm import GLMTokenizer
    write_glm_sp_model(str(tmp_path / "spiece.model"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(TINY, vocab_size=208, model_type="glm"), f)
    ours = AutoTokenizer.from_pretrained(str(tmp_path))
    assert isinstance(ours, GLMTokenizer)
    theirs = JaxTok.from_pretrained(str(tmp_path))
    texts = ["the other here", "a model then there", ""]
    a, b = ours(texts, max_length=12), theirs(texts, max_length=12)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    for name in ("gmask_token_id", "smask_token_id", "sop_token_id",
                 "eop_token_id", "cls_token_id", "mask_token_id",
                 "pad_token_id", "eos_token_id"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert ours.gmask_token_id == 200 + 2  # after the pieces, in order
    ids = ours.convert_tokens_to_ids(ours.tokenize(texts[1]))
    assert ours.decode(ids) == theirs.decode(ids)


class _IdTok:
    """Space-separated integer tokens (the JAX GLM tests' tokenizer)."""

    pad_token_id = PAD
    mask_token_id = 35
    cls_token_id = 34
    all_special_ids = [PAD, 34, 35]
    gmask_token_id, sop_token_id, eop_token_id = GMASK, SOP, EOP

    def __call__(self, texts, max_length=16):
        out = []
        for t in texts:
            ids = [int(x) for x in str(t).split()][:max_length]
            out.append(ids + [PAD] * (max_length - len(ids)))
        return {"input_ids": out,
                "attention_mask": [[int(x != PAD) for x in row]
                                   for row in out]}

    def get_vocab(self):
        return {str(i): i for i in range(40)}


def _corpus(path, n_rows=12, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n_rows):
            f.write("%d\t%s\n" % (i, " ".join(
                str(x) for x in rng.randint(1, 34, rng.randint(3, 30)))))


@pytest.mark.parametrize("udp", [{}, {"gap_sentence_prob": "0.3",
                                      "task_mask": "1"},
                                 {"bert_prob": "0", "gpt_infill_prob": "0.5",
                                  "shuffle_blocks": "0"}],
                         ids=["default", "gap-sentence", "gpt"])
def test_pretrain_layouts_match_jax(tmp_path, udp):
    """GLMPretrainDataset bit for bit for seed 7, epochs 0 and 1 (the
    corruption changes between them), and the cloze fine-tuning layout."""
    path = str(tmp_path / "corpus.tsv")
    _corpus(path)
    kw = dict(tokenizer=_IdTok(), max_seq_length=32,
              input_schema="id:str:1,text:str:1", first_sequence="text",
              user_defined_parameters=dict(udp, seed="7"))
    ours, theirs = PP.GLMPretrainDataset(path, **kw), \
        JP.GLMPretrainDataset(path, **kw)
    assert len(ours) == len(theirs) == 12
    epochs = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a = ours.batch_fn([ours[i] for i in range(len(ours))])
        b = theirs.batch_fn([theirs[i] for i in range(len(theirs))])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        epochs.append(a["input_ids"])
    assert not np.array_equal(*epochs)
    rows = str(tmp_path / "rows.tsv")
    with open(rows, "w") as f:
        for i in range(6):
            f.write("5 6 7 %d\t%d %d\n" % (i, 10 + i % 3, 11 + i % 3))
    kw = dict(tokenizer=_IdTok(), max_seq_length=16, max_target_length=4,
              input_schema="src:str:1,tgt:str:1", first_sequence="src",
              second_sequence="tgt", user_defined_parameters={
                  "src_len": 6, "tgt_len": 4})
    a = PG.GLMSequenceGenerationDataset(rows, **kw).features
    b = JG.GLMSequenceGenerationDataset(rows, **kw).features
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pretrain_evaluator_matches_jax(pair, tmp_path):
    from easynlp_tpu.utils import global_vars as jgv
    from easynlp_tpu.testing import make_args

    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    jax_app, app = pair
    path = str(tmp_path / "corpus.tsv")
    _corpus(path, n_rows=10, seed=3)
    kw = dict(tokenizer=_IdTok(), max_seq_length=32,
              input_schema="id:str:1,text:str:1", first_sequence="text")
    args = initialize_easynlp(args_list=["--device=cpu",
                                         "--micro_batch_size=4"])
    ours = PP.GLMPretrainEvaluator(PP.GLMPretrainDataset(path, **kw),
                                   args=args).evaluate(app)
    jgv._GLOBAL_ARGS = None
    jargs = make_args(micro_batch_size=4)
    theirs = JP.GLMPretrainEvaluator(JP.GLMPretrainDataset(path, **kw),
                                     args=jargs).evaluate(jax_app)
    assert [m for m, _ in ours] == [m for m, _ in theirs]
    np.testing.assert_allclose([v for _, v in ours],
                               [v for _, v in theirs], rtol=1e-5)


# -- the CLI -------------------------------------------------------------------

SG_SCHEMA = "id:str:1,src:str:1,tgt:str:1"
LM_SCHEMA = "id:str:1,text:str:1"
WORDS = ["the", "other", "here", "there", "model", "then", "thee", "a"]


def make_glm_dir(base):
    """A tiny GLM directory: config.json, spiece.model and a reference-named
    pytorch_model.bin from the port's init (seed 0)."""
    model_dir = os.path.join(base, "model")
    os.makedirs(model_dir)
    write_glm_sp_model(os.path.join(model_dir, "spiece.model"))
    config = dict(TINY, vocab_size=208, model_type="glm")
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f)
    model = PM.GLMForConditionalGeneration(PM.GLMConfig(**config))
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), os.path.join(model_dir,
                                                "pytorch_model.bin"))
    rng = np.random.RandomState(1)
    with open(os.path.join(base, "sg.tsv"), "w") as f:
        for i in range(16):
            f.write("%d\t%s\t%s\n" % (i, " ".join(rng.choice(WORDS, 6)),
                                      " ".join(rng.choice(WORDS, 3))))
    with open(os.path.join(base, "lm.tsv"), "w") as f:
        for i in range(16):
            f.write("%d\t%s\n" % (i, " ".join(rng.choice(WORDS, 20))))
    return model_dir


def glm_argv(base, app, mode, udp="", out="pred"):
    sg = app == "sequence_generation"
    common = ["--app_name=" + app, "--sequence_length=%d" % (24 if sg
                                                             else 32),
              "--micro_batch_size=8", "--dtype=float32", "--device=cpu",
              "--input_schema=" + (SG_SCHEMA if sg else LM_SCHEMA),
              "--first_sequence=" + ("src" if sg else "text")]
    if sg:
        common.append("--second_sequence=tgt")
    table = os.path.join(base, "sg.tsv" if sg else "lm.tsv")
    ckpt = os.path.join(base, "ckpt_" + app)
    udp = "--user_defined_parameters=enable_glm=true " + udp
    if mode == "train":
        return common + ["--mode=train", "--tables=%s,%s" % (table, table),
                         "--pretrained_model_name_or_path=%s/model" % base,
                         "--checkpoint_dir=" + ckpt, "--epoch_num=1",
                         "--learning_rate=1e-3", "--logging_steps=1", udp]
    if mode == "evaluate":
        return common + ["--mode=evaluate", "--tables=" + table,
                         "--checkpoint_dir=" + ckpt, udp]
    return common + ["--mode=predict", "--tables=" + table,
                     "--checkpoint_dir=" + ckpt,
                     "--outputs=%s/%s.tsv" % (base, out),
                     "--output_schema=predictions,generated_ids",
                     "--append_cols=id", udp + " max_decoder_length=6"]


GLM_RUN = """
import json, sys
from easynlp_tpu_torch.appzoo.api import default_main_fn
from easynlp_tpu_torch.utils.initializer import initialize_easynlp
out = {}
for name, argv in %r:
    result = default_main_fn(initialize_easynlp(args_list=argv))
    out[name] = (result.global_step if hasattr(result, "global_step")
                 else result if isinstance(result, list) else None)
bad = [m for m in sys.modules if m in ("jax", "flax", "easynlp_tpu")
       or m.startswith("easynlp_tpu.")]
print("RESULT " + json.dumps({"runs": out, "bad": bad}))
"""


@pytest.fixture(scope="module")
def glm_cli(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_glm_cli"))
    make_glm_dir(base)
    spec = "speculative_decoding=prompt_lookup num_draft_tokens=3"
    runs = [
        ("sg_train", glm_argv(base, "sequence_generation", "train")),
        ("sg_eval", glm_argv(base, "sequence_generation", "evaluate")),
        ("sg_greedy", glm_argv(base, "sequence_generation", "predict",
                               out="greedy")),
        ("sg_beams", glm_argv(base, "sequence_generation", "predict",
                              "num_beams=2", out="beams")),
        ("sg_spec", glm_argv(base, "sequence_generation", "predict", spec,
                             out="spec")),
        ("lm_train", glm_argv(base, "language_modeling", "train")),
        ("lm_eval", glm_argv(base, "language_modeling", "evaluate")),
    ]
    proc = subprocess.run(
        [sys.executable, "-c", GLM_RUN % (runs,)], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    preds = {}
    for name, argv in runs:
        out = [a for a in argv if a.startswith("--outputs=")]
        if out:
            with open(out[0][len("--outputs="):]) as f:
                preds[name] = [ln.rstrip("\n").split("\t") for ln in f]
    return base, json.loads(line[len("RESULT "):]), preds


def test_glm_cli_trains_evaluates_and_predicts(glm_cli):
    """Both enable_glm variants through the port's CLI in one fresh
    interpreter that loads no jax, flax or easynlp_tpu module: 2 training
    steps each, evaluate's metrics finite, and predict's speculative
    output equal to its greedy output row for row."""
    base, result, preds = glm_cli
    assert result["bad"] == []
    runs = result["runs"]
    assert runs["sg_train"] == 2 and runs["lm_train"] == 2
    assert [m for m, _ in runs["sg_eval"]] == ["bleu", "rouge_l"]
    assert [m for m, _ in runs["lm_eval"]] == ["accuracy", "perplexity"]
    assert all(np.isfinite(v) for _, v in runs["sg_eval"] + runs["lm_eval"])
    assert len(preds["sg_greedy"]) == len(preds["sg_beams"]) == 16
    assert preds["sg_spec"] == preds["sg_greedy"]
    ids = [row[1].split() for row in preds["sg_greedy"]]
    assert all(len(r) == 6 for r in ids)
