"""The port's CLIP retrieval (slice 12, A20) against the JAX package's, on
the CPU.

A tiny Chinese-CLIP (tests/test_clip.py's widths: a 2-layer BERT text
tower of width 32, a 2-layer quick_gelu ViT of width 24 over 32 x 32
images in 8 x 8 patches, projection 16) is initialised by the JAX package
and carried into the port through conversion.state_dict_from_jax, or
built by transformers' ChineseCLIPModel and read by both packages from its
HF state dict. Held to JAX in f32 (bounds in ATOL/RTOL below):

- the ViT encoder on float pixels and on uint8 pixels (config mean/std
  overrides included), the dual tower's normalised embeddings and logits,
  the contrastive loss and every gradient;
- HF's own ChineseCLIPModel on the port's weights (embeddings);
- the datasets (TSV rows, a webdataset .tar, the RAM cache) bit for bit,
  the evaluator's recalls (equal) and cosine mode, the predictor's rows;
- the Wukong/OpenAI dialect (the same weights renamed: equal embeddings);
- CLIP4Clip's masked frame mean;
- image_utils against JAX's, and the mean/std constants in one place.

The CLI test runs clip train, evaluate and predict, wukong_clip predict and
text2video_retrieval train, evaluate and predict in one fresh interpreter
of the port's, which must load no jax, flax or easynlp_tpu module.
"""

import base64
import io as _io
import json
import os
import subprocess
import sys
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from easynlp_tpu.appzoo.clip import model as JM
from easynlp_tpu.modelzoo.models.clip import CLIPConfig as JaxConfig
from easynlp_tpu_torch.appzoo.clip import model as PM
from easynlp_tpu_torch.modelzoo.models.clip import CLIPConfig, conversion
from test_torch_text_match import REPO, _restore_global_args  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
sys.path.insert(0, REPO)  # chip_smoke's Wukong renaming
from make_fixtures import make_pretrained  # noqa: E402

TEXT_CFG = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=64, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
VISION_CFG = dict(image_size=32, patch_size=8, hidden_size=24,
                  num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=48, hidden_act="quick_gelu")
EMBED_ATOL = 2e-5      # normalised embeddings, f32
HIDDEN_ATOL = 1e-4     # ViT hidden states (unnormalised, |x| ~ 1-4)
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5
HF_ATOL = 2e-4         # as tests/test_clip.py holds JAX to HF


def b64_png(seed, size=40):
    from PIL import Image
    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 255, (size, size + seed % 7, 3),
                                      np.uint8))
    buf = _io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_apply(module, params, batch):
    """module.apply on the numpy batch, jitted (one compile, where the
    eager apply compiles op by op)."""
    return jax.jit(lambda p, b: module.apply({"params": p}, **b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})


def make_pair(cls_jax=JM.CLIPApp, cls_port=PM.CLIPApp, seed=3,
              vocab_size=120, **vision):
    """(JAX app, port app) with the same weights."""
    text = dict(TEXT_CFG, vocab_size=vocab_size)
    vis = dict(VISION_CFG, **vision)
    jcfg = JaxConfig(text_config=text, vision_config=vis, projection_dim=16)
    module = cls_jax.build_module(jcfg, dtype=jnp.float32)
    params = np_tree(jax.jit(lambda: cls_jax.init_params(  # one compile
        module, jcfg, seed=seed))())
    jax_app = cls_jax(module, params, jcfg)
    cfg = CLIPConfig(text_config=text, vision_config=vis, projection_dim=16)
    model = cls_port.build_module(cfg)
    model.load_state_dict(cls_port.state_dict_from_jax(params, cfg),
                          strict=True)
    return jax_app, cls_port(model.eval(), cfg, "cpu")


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def _inputs(seed, b=4, s=10, vocab=120):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[1, 7:] = 0
    mask[b - 1, 4:] = 0
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": np.zeros((b, s), np.int32),
            "pixel_values": rng.rand(b, 32, 32, 3).astype(np.float32)}


def _port(app, batch, grad=False):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if grad:
        return app.forward(t)
    with torch.no_grad():
        return app.forward(t)


@pytest.mark.parametrize("case", ["float", "uint8", "uint8-mean-std"])
def test_vit_encoder_matches_jax(case):
    """The ViT's last hidden state and pooled CLS row: float pixels pass
    through, uint8 pixels are normalised in the model with the config's
    image_mean/image_std where set."""
    from easynlp_tpu.modelzoo.models.clip import CLIPVisionConfig as JVC
    from easynlp_tpu.modelzoo.models.clip import ViTEncoder as JViT
    from easynlp_tpu_torch.modelzoo.models.clip import (CLIPVisionConfig,
                                                        ViTEncoder)
    extra = ({"image_mean": [0.5, 0.4, 0.3], "image_std": [0.2, 0.3, 0.4]}
             if case == "uint8-mean-std" else {})
    jcfg = JVC(**VISION_CFG, **extra)
    jmod = JViT(config=jcfg, dtype=jnp.float32)
    rng = np.random.RandomState(7)
    pixels = (rng.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
              if case != "float" else rng.randn(3, 32, 32, 3)
              .astype(np.float32))
    params = np_tree(nn.unbox(jmod.init(jax.random.PRNGKey(1),
                                        jnp.asarray(pixels))["params"]))
    want = jax.jit(lambda p, x: jmod.apply({"params": p}, x))(
        params, jnp.asarray(pixels))
    cfg = CLIPVisionConfig(**VISION_CFG, **extra)
    vit = ViTEncoder(cfg)
    vit.load_state_dict(conversion.vision_state_dict_from_jax(params, cfg),
                        strict=True)
    with torch.no_grad():
        got = vit(torch.from_numpy(pixels))
    for key in ("last_hidden_state", "pooler_output"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=HIDDEN_ATOL, rtol=0)


def test_clip_model_loss_and_gradients_match_jax(pair):
    """Embeddings within 2e-5, logits_per_text within 1e-5 relative, the
    contrastive loss within 1e-5 relative and every gradient within 1e-5
    (JAX's gradient tree carried to the port's names by the same map as
    the weights)."""
    jax_app, app = pair
    batch = _inputs(0)

    def jax_loss(p):
        o = jax_app.module.apply({"params": p}, **{
            k: jnp.asarray(v) for k, v in batch.items()})
        return JM.CLIPApp.loss_fn(o, batch)["loss"], o
    (want_loss, want), grads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(jax_app.params)
    app.module.zero_grad()
    out = _port(app, batch, grad=True)
    for key in ("text_embeds", "image_embeds"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(want[key]), atol=EMBED_ATOL,
                                   rtol=0)
    np.testing.assert_allclose(out["logits_per_text"].detach().numpy(),
                               np.asarray(want["logits_per_text"]),
                               rtol=LOSS_RTOL, atol=1e-6)
    loss = app.loss_fn(out, batch)["loss"]
    loss.backward()
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    want_grads = conversion.state_dict_from_jax(np_tree(grads), app.config)
    for name, p in app.module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(),
                                   want_grads[name].numpy(),
                                   atol=GRAD_ATOL, rtol=1e-4, err_msg=name)


def _hf_clip(seed=0):
    transformers = pytest.importorskip("transformers")
    tcfg = transformers.ChineseCLIPTextConfig(**TEXT_CFG)
    vcfg = transformers.ChineseCLIPVisionConfig(
        **{k: v for k, v in VISION_CFG.items() if k != "hidden_act"},
        attention_dropout=0.0, hidden_act="quick_gelu")
    hf_cfg = transformers.ChineseCLIPConfig(
        text_config=tcfg.to_dict(), vision_config=vcfg.to_dict(),
        projection_dim=16)
    torch.manual_seed(seed)
    return transformers.ChineseCLIPModel(hf_cfg).eval()


def test_hf_chinese_clip_layout_matches_hf_and_jax():
    """An HF ChineseCLIPModel's state dict loads into the port with no
    converter (the port's CLIPApp.load_state_dict normalises names only)
    and into JAX through convert_chinese_clip: the port's embeddings equal
    HF's own within 2e-4 and JAX's within 2e-5."""
    from easynlp_tpu.modelzoo.models.clip.conversion import (
        convert_chinese_clip)
    hf = _hf_clip()
    state = hf.state_dict()
    cfg = CLIPConfig(text_config=TEXT_CFG, vision_config=VISION_CFG,
                     projection_dim=16)
    model = PM.CLIPApp.build_module(cfg)
    PM.CLIPApp.load_state_dict(model, state)
    app = PM.CLIPApp(model.eval(), cfg, "cpu")
    batch = _inputs(1)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(batch["input_ids"]).long(),
                 attention_mask=torch.tensor(batch["attention_mask"]).long(),
                 pixel_values=torch.tensor(
                     batch["pixel_values"].transpose(0, 3, 1, 2)))
    got = _port(app, batch)
    np.testing.assert_allclose(got["text_embeds"].numpy(),
                               ref.text_embeds.numpy(), atol=HF_ATOL)
    np.testing.assert_allclose(got["image_embeds"].numpy(),
                               ref.image_embeds.numpy(), atol=HF_ATOL)
    jcfg = JaxConfig(text_config=TEXT_CFG, vision_config=VISION_CFG,
                     projection_dim=16)
    jmod = JM.CLIPApp.build_module(jcfg, dtype=jnp.float32)
    params = convert_chinese_clip({k: v.numpy() for k, v in state.items()},
                                  jcfg)
    want = jax_apply(jmod, params, batch)
    for key in ("text_embeds", "image_embeds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=EMBED_ATOL, rtol=0)
    # the other route, through JAX's tree: the same weights bit for bit
    via_jax = PM.CLIPApp.state_dict_from_jax(np_tree(params), cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(via_jax[k], v), k
    # the port's own export reads back bit for bit
    again = PM.CLIPApp.build_module(cfg)
    PM.CLIPApp.load_state_dict(again, app.export_state_dict())
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_remat_checkpoints_each_vit_block(pair):
    """--remat=full (modeling_bert.set_remat) reaches every ViT block and
    BERT layer; the gradients equal those without it, bit for bit."""
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        set_remat)
    _, app = pair
    batch = _inputs(5)
    grads = {}
    for policy in ("none", "full"):
        set_remat(app.module, policy)
        app.module.zero_grad()
        out = _port(app, batch, grad=True)
        app.loss_fn(out, batch)["loss"].backward()
        grads[policy] = {n: p.grad.clone()
                         for n, p in app.module.named_parameters()}
    set_remat(app.module, "none")
    assert all(b.remat == "none"
               for b in app.module.vision_model.encoder.layers)
    for name, g in grads["none"].items():
        assert torch.equal(grads["full"][name], g), name


def test_wukong_dialect_matches_clip_and_jax(pair):
    """The same weights under the Wukong/OpenAI names: WukongCLIP gives
    CLIP's embeddings bit for bit, and JAX's convert_wukong on the same
    dict gives them within 2e-5."""
    from easynlp_tpu.appzoo.wukong_clip.model import WukongCLIP as JW
    from easynlp_tpu_torch.appzoo.wukong_clip.model import WukongCLIP
    from chip_smoke import wukong_state_dict
    _, app = pair
    state = wukong_state_dict(
        {k: v.clone() for k, v in app.module.state_dict().items()},
        VISION_CFG["num_hidden_layers"])
    model = WukongCLIP.build_module(app.config)
    WukongCLIP.load_state_dict(model, state)
    wukong = WukongCLIP(model.eval(), app.config, "cpu")
    batch = _inputs(2)
    want, got = _port(app, batch), _port(wukong, batch)
    for key in ("text_embeds", "image_embeds", "logits_per_text"):
        assert torch.equal(got[key], want[key]), key
    jcfg = JaxConfig(text_config=TEXT_CFG, vision_config=VISION_CFG,
                     projection_dim=16)
    jmod = JW.build_module(jcfg, dtype=jnp.float32)
    params = JW.convert_pytorch_state_dict(
        {k: v.numpy() for k, v in state.items()}, jcfg)
    out = jax_apply(jmod, params, batch)
    for key in ("text_embeds", "image_embeds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(out[key]),
                                   atol=EMBED_ATOL, rtol=0)
    # without text_projection and logit_scale those keep their init
    partial = {k: v for k, v in state.items()
               if k not in ("text_projection", "logit_scale")}
    fresh = WukongCLIP.build_module(app.config)
    fresh.init_weights(torch.Generator().manual_seed(0))
    init_proj = fresh.text_projection.weight.clone()
    WukongCLIP.load_state_dict(fresh, partial)
    assert torch.equal(fresh.text_projection.weight, init_proj)
    assert torch.equal(fresh.visual_projection.weight,
                       app.module.visual_projection.weight)


def test_clip4clip_masked_frame_mean_matches_jax():
    """Text2VideoRetrieval's module on [B, F, H, W, 3] frames with
    video_masks (a video of one real frame, one of all four): the video
    embeddings within 2e-5 of JAX's, and equal to the masked mean of the
    frames' normalised embeddings, normalised again."""
    from easynlp_tpu.appzoo.text2video_retrieval import model as JT
    from easynlp_tpu_torch.appzoo.text2video_retrieval import model as PT
    jax_app, app = make_pair(JT.Text2VideoRetrieval, PT.Text2VideoRetrieval)
    batch = _inputs(3, b=2)
    rng = np.random.RandomState(4)
    batch["pixel_values"] = rng.rand(2, 4, 32, 32, 3).astype(np.float32)
    batch["video_masks"] = np.array([[1, 0, 0, 0], [1, 1, 1, 1]], np.int32)
    want = jax_apply(jax_app.module, jax_app.params, batch)
    got = _port(app, batch)
    for key in ("text_embeds", "video_embeds", "image_embeds"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=EMBED_ATOL, rtol=0)
    with torch.no_grad():
        frames = app.module.get_image_features(torch.from_numpy(
            batch["pixel_values"].reshape(8, 32, 32, 3))).view(2, 4, -1)
    first = frames[0, 0] / (frames[0, 0].norm() + 1e-8)
    np.testing.assert_allclose(got["video_embeds"][0].numpy(),
                               first.numpy(), atol=1e-6)
    loss = app.loss_fn(got, batch)["loss"]
    assert float(loss) == pytest.approx(
        float(JM.CLIPApp.loss_fn(want, batch)["loss"]), rel=LOSS_RTOL)


# -- data, evaluator, predictor -----------------------------------------------

@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """(model dir with the fixtures' BERT vocab, clip.tsv of 13 rows)."""
    base = tmp_path_factory.mktemp("torch_clip_rows")
    model_dir = make_pretrained(str(base / "tiny-bert"))
    path = str(base / "clip.tsv")
    with open(path, "w") as f:
        for i in range(13):
            f.write("a good day %d\t%s\n" % (i, b64_png(i)))
    return model_dir, path


DS_KW = dict(max_seq_length=16, input_schema="text:str:1,image:str:1",
             first_sequence="text", second_sequence="image", image_size=32)


def test_clip_tsv_dataset_and_ram_cache_match_jax(rows):
    """Rows, tokens and uint8 pixels bit for bit; the RAM cache returns
    the same pixels cold and hot, bounded by image_cache_items."""
    from easynlp_tpu.appzoo.clip.data import CLIPDataset as JD
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JTok
    from easynlp_tpu_torch.appzoo.clip.data import CLIPDataset
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model_dir, path = rows
    want = JD(path, JTok.from_pretrained(model_dir), **DS_KW)
    got = CLIPDataset(path, BertTokenizer.from_pretrained(model_dir),
                      **DS_KW)
    cached = CLIPDataset(path, BertTokenizer.from_pretrained(model_dir),
                         image_cache="ram", image_cache_items=5, **DS_KW)
    assert len(got) == len(want) == 13
    b_got = got.batch_fn([got[i] for i in range(13)])
    b_want = want.batch_fn([want[i] for i in range(13)])
    assert sorted(b_got) == sorted(b_want)
    for k in b_got:
        assert b_got[k].dtype == b_want[k].dtype
        np.testing.assert_array_equal(b_got[k], b_want[k])
    assert b_got["pixel_values"].dtype == np.uint8
    for _ in range(2):
        for i in range(13):
            np.testing.assert_array_equal(cached[i]["pixel_values"],
                                          b_want["pixel_values"][i])
    assert len(cached._img_cache) == 5


def write_tar(path, n=6):
    """A webdataset shard: %05d.png images with .txt or .json captions."""
    from PIL import Image
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            arr = (np.random.RandomState(i).rand(10, 12, 3)
                   * 255).astype(np.uint8)
            buf = _io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            cap = json.dumps({"caption": "picture %d" % i}).encode() \
                if i % 2 else ("caption %d" % i).encode()
            for name, data in (("%05d.png" % i, buf.getvalue()),
                               ("%05d.%s" % (i, "json" if i % 2 else "txt"),
                                cap)):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, _io.BytesIO(data))


def test_clip_tar_dataset_matches_jax(tmp_path):
    """A .tar shard (members grouped by stem, .txt and .json captions),
    whole and split across two ranks: captions, tokens and pixels bit for
    bit."""
    from easynlp_tpu.appzoo.clip.data import CLIPDataset as JD
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JTok
    from easynlp_tpu_torch.appzoo.clip.data import CLIPDataset
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    tar = str(tmp_path / "shard-000.tar")
    write_tar(tar)
    vocab = str(tmp_path / "v.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                           "picture", "caption"] + [str(i)
                                                    for i in range(8)]))
    for extra in ({}, {"process_index": 1, "num_processes": 2}):
        want = JD(tar, JTok(vocab), max_seq_length=8, image_size=16,
                  **extra)
        got = CLIPDataset(tar, BertTokenizer(vocab), max_seq_length=8,
                          image_size=16, **extra)
        assert got.texts == want.texts and len(got) == (3 if extra else 6)
        for i in range(len(got)):
            for k, v in want[i].items():
                np.testing.assert_array_equal(got[i][k], v)


def _args(**kw):
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    return initialize_easynlp(args_list=["--device=cpu", "--mode=evaluate",
                                         "--micro_batch_size=4"] + [
        "--%s=%s" % kv for kv in kw.items()])


def test_clip_evaluator_and_predictor_match_jax(rows, pair):
    """On the same weights (the fixtures' vocabulary): recall@1/5/10 and
    their mean equal JAX's, the cosine mode within 1e-6, and the
    predictor's text and image embeddings within 2e-5 (printed %.8f)."""
    from easynlp_tpu.appzoo.clip.data import CLIPDataset as JD
    from easynlp_tpu.appzoo.clip.evaluator import CLIPEvaluator as JE
    from easynlp_tpu.appzoo.clip.predictor import CLIPPredictor as JP
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JTok
    from easynlp_tpu.testing import make_args
    from easynlp_tpu_torch.appzoo.clip.data import CLIPDataset
    from easynlp_tpu_torch.appzoo.clip.evaluator import CLIPEvaluator
    from easynlp_tpu_torch.appzoo.clip.predictor import CLIPPredictor
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model_dir, path = rows
    tok = BertTokenizer.from_pretrained(model_dir)
    jax_app, app = pair  # 120 ids: the fixtures' vocabulary fits
    assert tok.vocab_size <= TEXT_CFG["vocab_size"]
    ds = CLIPDataset(path, tok, **DS_KW)
    jds = JD(path, JTok.from_pretrained(model_dir), **DS_KW)
    for cos in ("", "True"):
        udp = "cosine_similarity=" + cos if cos else ""
        jargs = make_args(micro_batch_size=4, eval_batch_size=4,
                          user_defined_parameters_dict=dict(
                              [udp.split("=")] if udp else []))
        want = JE(jds, args=jargs).evaluate(jax_app)
        got = CLIPEvaluator(ds, args=_args(
            eval_batch_size=4, user_defined_parameters=udp)).evaluate(app)
        assert [m for m, _ in got] == [m for m, _ in want]
        if cos:
            np.testing.assert_allclose(got[0][1], want[0][1], atol=1e-6)
        else:
            assert got == want
    with open(path) as f:
        cells = [line.rstrip("\n").split("\t") for line in f]
    data = {"text": [c[0] for c in cells], "image": [c[1] for c in cells]}
    kw = dict(first_sequence="text", second_sequence="image",
              sequence_length=16, batch_size=4)
    want = JP(model_dir, jax_app, **kw).run(dict(data))
    got = CLIPPredictor(model_dir, app, **kw).run(dict(data))
    for key in ("text_embeds", "image_embeds", "predictions"):
        np.testing.assert_allclose(
            [[float(x) for x in r.split()] for r in got[key]],
            [[float(x) for x in r.split()] for r in want[key]],
            atol=EMBED_ATOL)


def test_retrieval_ties_rank_the_gold_pair_lower():
    """JAX's rank rule (`>=`): a candidate scoring as high as the gold
    pair outranks it, so two identical image embeddings give each text a
    rank of 2."""
    from easynlp_tpu_torch.appzoo.clip.evaluator import retrieval_metrics
    t = np.eye(3, dtype=np.float32)
    v = np.array([[1, 0, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    got = dict(retrieval_metrics(t, v))
    assert got["t2i_r1"] == pytest.approx(1 / 3)  # row 0 ties row 1's image
    assert got["t2i_r5"] == 1.0


def test_image_utils_match_jax():
    """decode, resize + centre crop and normalisation bit for bit with the
    JAX package's (the same PIL calls), the url-safe decode and the frame
    list with its black padding; CLIP_MEAN/CLIP_STD are defined once (the
    ViT imports them)."""
    from easynlp_tpu.data import image_utils as J
    from easynlp_tpu_torch.data import image_utils as P
    from easynlp_tpu_torch.modelzoo.models.clip import modeling_clip
    assert modeling_clip.CLIP_MEAN is P.CLIP_MEAN
    np.testing.assert_array_equal(P.CLIP_MEAN, J.CLIP_MEAN)
    np.testing.assert_array_equal(P.CLIP_STD, J.CLIP_STD)
    cells = [b64_png(i, size=30 + 7 * i) for i in range(4)]
    for size in (16, 32):
        np.testing.assert_array_equal(
            P.preprocess_base64_batch(cells, size),
            J.preprocess_base64_batch(cells, size))
        np.testing.assert_array_equal(
            P.preprocess_base64_batch(cells, size, [0.5] * 3, [0.25] * 3),
            J.preprocess_base64_batch(cells, size, [0.5] * 3, [0.25] * 3))
    urlsafe = [base64.urlsafe_b64encode(base64.b64decode(c)).decode()
               for c in cells]
    frames, n = P.decode_frame_list(json.dumps(urlsafe[:3]), 5)
    jframes, jn = J.decode_frame_list(json.dumps(urlsafe[:3]), 5)
    assert n == jn == 3 and len(frames) == 5
    for a, b in zip(frames, jframes):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(Exception):
        P.decode_base64_image("bm90IGFuIGltYWdl")  # "not an image"


def test_long_rows_reference_fault_28(tmp_path):
    """A text2video row of 12 base64 frames passes 1 MiB. The JAX
    package's native TSV reader copies at most 1 MiB of a row (its
    NativeTSVReader's max_row_bytes), so such a row comes back cut and its
    frame list no longer parses; the port's reader grows its buffer and
    returns the row whole, and the dataset decodes all 12 frames."""
    from easynlp_tpu.data import native_reader as J
    from easynlp_tpu_torch.appzoo.text2video_retrieval.data import (
        Text2VideoRetrievalDataset)
    from easynlp_tpu_torch.data import native_reader as P
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    cell = video_cell(0, 1)
    frame = base64.urlsafe_b64encode(base64.b64decode(b64_png(
        1, size=300))).decode()
    big = json.dumps([frame] * 12)
    assert len(big) > 1 << 20
    path = str(tmp_path / "long.tsv")
    with open(path, "w") as f:
        f.write("a long video\t%s\nshort\t%s\n" % (big, cell))
    assert P.available()
    assert P.NativeLazyRows(path)[0] == "a long video\t" + big
    if J.available():
        assert len(J.NativeLazyRows(path)[0]) == 1 << 20
    vocab = str(tmp_path / "v.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a"]))
    ds = Text2VideoRetrievalDataset(
        path, BertTokenizer(vocab), max_seq_length=8,
        input_schema="text:str:1,video:str:1", image_size=16,
        user_defined_parameters={"max_frames": 12})
    assert ds[0]["video_masks"].tolist() == [1] * 12
    assert ds[1]["video_masks"].tolist() == [1] + [0] * 11


# -- the CLI -------------------------------------------------------------------

CLI_RUN = """
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


def make_clip_dir(base, vocab_dir):
    """config.json (CLIPConfig), vocab.txt and the port's init (seed 0)
    under HF names as pytorch_model.bin."""
    import shutil
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    from easynlp_tpu_torch.modelzoo.models.clip import CLIPModel
    model_dir = os.path.join(base, "clip")
    os.makedirs(model_dir)
    shutil.copy(os.path.join(vocab_dir, "vocab.txt"), model_dir)
    n = BertTokenizer.from_pretrained(model_dir).vocab_size
    cfg = CLIPConfig(text_config=dict(TEXT_CFG, vocab_size=n),
                     vision_config=VISION_CFG, projection_dim=16)
    cfg.save_pretrained(model_dir)
    model = CLIPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), os.path.join(model_dir,
                                                "pytorch_model.bin"))
    return model_dir


def video_cell(seed, n):
    return json.dumps([base64.urlsafe_b64encode(base64.b64decode(
        b64_png(seed + j))).decode() for j in range(n)])


@pytest.fixture(scope="module")
def clip_cli(tmp_path_factory, rows):
    base = str(tmp_path_factory.mktemp("torch_clip_cli"))
    model_dir = make_clip_dir(base, rows[0])
    video = os.path.join(base, "video.tsv")
    with open(video, "w") as f:
        for i in range(8):
            f.write("clip %d\t%s\n" % (i, video_cell(i, 1 + i % 3)))
    common = ["--device=cpu", "--dtype=float32", "--sequence_length=16",
              "--micro_batch_size=4", "--first_sequence=text",
              "--second_sequence=image",
              "--input_schema=text:str:1,image:str:1"]
    udp = "--user_defined_parameters=image_size=32"

    def argv(app, mode, table, ckpt, extra=()):
        a = ["--app_name=" + app, "--mode=" + mode, "--tables=" + table,
             udp] + common + list(extra)
        if mode == "train":
            return a + ["--pretrained_model_name_or_path=" + model_dir,
                        "--checkpoint_dir=" + ckpt, "--epoch_num=1",
                        "--learning_rate=1e-3", "--logging_steps=1"]
        return a + ["--checkpoint_dir=" + ckpt]

    def pred(app, table, ckpt, out, schema):
        return argv(app, "predict", table, ckpt, [
            "--outputs=" + os.path.join(base, out),
            "--output_schema=" + schema, "--append_cols=text"])
    ckpt = os.path.join(base, "ckpt_clip")
    vckpt = os.path.join(base, "ckpt_video")
    video_common = ["--second_sequence=video",
                    "--input_schema=text:str:1,video:str:1",
                    "--user_defined_parameters=image_size=32 max_frames=3"]
    runs = [
        ("clip_train", argv("clip", "train", rows[1] + "," + rows[1],
                            ckpt)),
        ("clip_eval", argv("clip", "evaluate", rows[1], ckpt)),
        ("clip_pred", pred("clip", rows[1], ckpt, "clip.tsv",
                           "text_embeds,image_embeds")),
        ("wukong_pred", pred("wukong_clip", rows[1], ckpt, "wukong.tsv",
                             "text_embeds,image_embeds")),
        ("video_train", argv("text2video_retrieval", "train",
                             video + "," + video, vckpt) + video_common),
        ("video_eval", argv("text2video_retrieval", "evaluate", video,
                            vckpt) + video_common),
        ("video_pred", pred("text2video_retrieval", video, vckpt,
                            "video_pred.tsv", "text_embeds,video_embeds")
         + video_common),
    ]
    proc = subprocess.run(
        [sys.executable, "-c", CLI_RUN % (runs,)], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    preds = {}
    for name in ("clip", "wukong", "video_pred"):
        with open(os.path.join(base, name + ".tsv")) as f:
            preds[name] = [ln.rstrip("\n").split("\t") for ln in f]
    return json.loads(line[len("RESULT "):]), preds


def test_clip_cli_trains_evaluates_and_predicts(clip_cli):
    """clip (3 steps of 4 rows), text2video_retrieval (2 steps of 4
    videos) train, evaluate and predict through the port's CLI in one
    fresh interpreter that loads no jax, flax or easynlp_tpu module;
    wukong_clip predicts from clip's checkpoint (HF names) the same rows;
    every recall lies in [0, 1] and every embedding has unit norm."""
    result, preds = clip_cli
    assert result["bad"] == []
    runs = result["runs"]
    assert runs["clip_train"] == 3 and runs["video_train"] == 2
    for name in ("clip_eval", "video_eval"):
        assert runs[name][0][0] == "mean_recall"
        assert all(0.0 <= v <= 1.0 for _, v in runs[name])
    assert preds["wukong"] == preds["clip"] and len(preds["clip"]) == 13
    assert len(preds["video_pred"]) == 8
    for rows_ in preds.values():
        for row in rows_:
            for cell in row[:2]:
                v = np.array([float(x) for x in cell.split()])
                assert v.shape == (16,) and abs(np.linalg.norm(v) - 1) < 1e-5
