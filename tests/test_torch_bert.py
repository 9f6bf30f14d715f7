"""The PyTorch port's BERT against the JAX package's, on test_bert.py's TINY
config: weights from a JAX init carried over by `state_dict_from_jax`,
inputs made with numpy from a seed. f32 parity bound 1e-4 on hidden states
and pooler (two frameworks summing in different orders through two layers;
test_bert.py holds JAX to HF torch within 2e-4)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import flatten_dict

from easynlp_tpu.modelzoo.models.bert import BertConfig as JaxBertConfig
from easynlp_tpu.modelzoo.models.bert import BertModel as JaxBertModel
from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTokenizer
from easynlp_tpu.modelzoo.models.bert.conversion import convert_bert_backbone
from easynlp_tpu.utils.exporter import export_bert_backbone_to_pytorch
from easynlp_tpu_torch.modelzoo.modeling_utils import (
    available_checkpoint,
    load_pytorch_state_dict,
    truncated_normal_,
)
from easynlp_tpu_torch.modelzoo.models.bert import (
    BertConfig,
    BertModel,
    BertTokenizer,
)
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    normalize_keys,
    split_backbone,
    state_dict_from_jax,
)
from easynlp_tpu_torch.ops import attention as A

TINY = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def jax_bert():
    cfg = JaxBertConfig(**TINY)
    module = JaxBertModel.from_config(cfg, dtype=jnp.float32)
    rng = jax.random.PRNGKey(3)
    params = module.init_params({"params": rng, "dropout": rng},
                                {"input_ids": jnp.ones((1, 8), jnp.int32)})
    params = jax.tree.map(np.array, nn.unbox(params))  # writable copies
    return cfg, module, params


def _inputs(padded):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, TINY["vocab_size"], (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    types = np.zeros((2, 16), np.int32)
    if padded:
        mask[1, 10:] = 0
        types[0, 9:] = 1
    return ids, mask, types


@pytest.mark.parametrize("padded", [False, True])
def test_bert_matches_jax(jax_bert, padded):
    cfg, module, params = jax_bert
    ids, mask, types = _inputs(padded)
    want = module.apply({"params": params}, input_ids=jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask),
                        token_type_ids=jnp.asarray(types), deterministic=True)
    model = BertModel(BertConfig(**TINY)).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    A.short_attention_fwd.launches = 0
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(types))
    assert A.short_attention_fwd.launches == 0  # CPU: the plain twin
    np.testing.assert_allclose(got["last_hidden_state"].numpy(),
                               np.asarray(want["last_hidden_state"]),
                               atol=1e-4)
    np.testing.assert_allclose(got["pooler_output"].numpy(),
                               np.asarray(want["pooler_output"]), atol=1e-4)


@pytest.mark.parametrize("padded", [False, True])
def test_hidden_states_match_jax(jax_bert, padded):
    """output_hidden_states: the L layers' outputs stacked [L, B, S, E], as
    the JAX scan collects them (no embeddings entry, unlike HF's tuple),
    within 1e-5 in f32; the last one is last_hidden_state."""
    cfg, _, params = jax_bert
    ids, mask, types = _inputs(padded)
    want = JaxBertModel(cfg, dtype=jnp.float32,
                        output_hidden_states=True).apply(
        {"params": params}, input_ids=jnp.asarray(ids),
        attention_mask=jnp.asarray(mask), token_type_ids=jnp.asarray(types),
        deterministic=True)["hidden_states"]
    model = BertModel(BertConfig(**TINY), output_hidden_states=True).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(types))
    assert got["hidden_states"].shape == (TINY["num_hidden_layers"], 2, 16,
                                          TINY["hidden_size"])
    np.testing.assert_allclose(got["hidden_states"].numpy(),
                               np.asarray(want), atol=1e-5, rtol=0)
    assert torch.equal(got["hidden_states"][-1], got["last_hidden_state"])
    assert "hidden_states" not in BertModel(BertConfig(**TINY)).eval()(
        torch.from_numpy(ids))


def test_bert_bf16_compute_keeps_f32_params(jax_bert):
    """dtype=bf16: dense layers run in bf16 on f32 parameters and LayerNorm in
    f32; outputs are bf16 and stay within 5e-2 of the f32 JAX model (bf16
    keeps 8 bits: 2^-8 relative per rounding, compounded over two layers of
    O(1) LayerNorm outputs)."""
    cfg, module, params = jax_bert
    ids, mask, types = _inputs(True)
    want = module.apply({"params": params}, input_ids=jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask),
                        token_type_ids=jnp.asarray(types), deterministic=True)
    model = BertModel(BertConfig(**TINY), dtype=torch.bfloat16).eval()
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.inference_mode():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(types))
    assert got["last_hidden_state"].dtype == torch.bfloat16
    np.testing.assert_allclose(got["last_hidden_state"].float().numpy(),
                               np.asarray(want["last_hidden_state"]),
                               atol=5e-2)


def test_state_dict_from_jax_matches_exporter_and_round_trips(jax_bert,
                                                             tmp_path):
    cfg, _, params = jax_bert
    ours = state_dict_from_jax(params, cfg)
    path = str(tmp_path / "exported.bin")
    export_bert_backbone_to_pytorch(params, cfg, path, prefix="")
    theirs = torch.load(path, weights_only=True)
    assert set(ours) == set(theirs)
    assert set(ours) == set(BertModel(BertConfig(**TINY)).state_dict())
    for key in ours:
        torch.testing.assert_close(ours[key], theirs[key], atol=0, rtol=0)
    back = convert_bert_backbone({k: v.numpy() for k, v in ours.items()},
                                 cfg)
    fa, fb = flatten_dict(params), flatten_dict(back)
    assert set(fa) == set(fb)
    for key in fa:
        np.testing.assert_array_equal(np.asarray(fa[key]), fb[key])


def test_hf_checkpoint_keys_load_strictly(jax_bert):
    """`bert.` prefixes, TF-style gamma/beta and saved position_ids buffers
    normalise onto the port's names; heads are split off."""
    cfg, _, params = jax_bert
    hf = {}
    for k, v in state_dict_from_jax(params, cfg).items():
        k = k.replace("LayerNorm.weight", "LayerNorm.gamma").replace(
            "LayerNorm.bias", "LayerNorm.beta")
        hf["bert." + k] = v
    hf["bert.embeddings.position_ids"] = torch.arange(64)[None]
    hf["classifier.weight"] = torch.zeros(2, 32)
    hf["cls.predictions.bias"] = torch.zeros(200)
    backbone, other = split_backbone(normalize_keys(hf))
    assert set(other) == {"classifier.weight", "cls.predictions.bias"}
    BertModel(BertConfig(**TINY)).load_state_dict(backbone, strict=True)


def test_truncated_normal_init_is_seeded_and_bounded():
    def draw(seed):
        t = torch.empty(20000)
        return truncated_normal_(t, 0.02, torch.Generator().manual_seed(seed))
    a, b = draw(0), draw(0)
    assert torch.equal(a, b) and not torch.equal(a, draw(1))
    assert a.abs().max() <= 0.04
    # std of N(0,1) truncated at +-2 is 0.8796
    assert abs(a.std().item() - 0.02 * 0.8796) < 5e-4
    model = BertModel(BertConfig(**TINY))
    model.init_weights(torch.Generator().manual_seed(0))
    ln = model.encoder.layer[0].output.LayerNorm
    assert torch.all(ln.weight == 1) and torch.all(ln.bias == 0)


def test_checkpoint_flavour_and_load(tmp_path):
    assert available_checkpoint(str(tmp_path)) is None
    (tmp_path / "flax_params.msgpack").write_bytes(b"")
    assert available_checkpoint(str(tmp_path)) == "flax"
    torch.save({"w": torch.ones(2)}, str(tmp_path / "pytorch_model.bin"))
    assert available_checkpoint(str(tmp_path)) == "pytorch"
    assert torch.equal(load_pytorch_state_dict(str(tmp_path))["w"],
                       torch.ones(2))


def test_tokenizer_gives_the_jax_ids(tmp_path):
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
    from make_fixtures import make_pretrained
    model_dir = make_pretrained(str(tmp_path / "tiny"))
    texts = ["the day was very good", "An AWFUL, sad story!",
             "unknownword [MASK] happy", "a"]
    pairs = ["it was nice", None, "lose", "b c d e f g h i j k l m n"]
    for a, b in zip(texts, pairs):
        want = JaxTokenizer.from_pretrained(model_dir)(a, b, max_length=12)
        got = BertTokenizer.from_pretrained(model_dir)(a, b, max_length=12)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
