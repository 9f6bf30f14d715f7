"""The port's TextCNN and BLOOM (modelzoo/models/cnn, modelzoo/models/bloom)
against the JAX package's, on the CPU, and BLOOM against HF transformers'.

Each module is initialised by the JAX package (its weights perturbed, so
biases and LayerNorms are not at their init) and carried into the port
through state_dict_from_jax. Held in f32, dropout off:
- TextCNN's pooled features (1e-5) at kernel sizes 2-5 (the even ones
  pad one more on the right, flax's "SAME") and at 3 alone, on rows of
  several lengths;
- BLOOM's logits and last hidden state (1e-5) with the JAX module's
  exact GELU, on right-padded rows; the ALiBi slopes and bias;
- BLOOM against transformers' BloomForCausalLM from its own state dict
  (1e-5), with BLOOM's tanh GELU, the port's default: JAX's exact GELU
  is off by more than the tolerance there (ROADMAP reference fault 38);
- AutoModel on a directory holding the JAX package's flax_params.msgpack
  or an HF pytorch_model.bin (with and without `transformer.`).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easynlp_tpu.modelzoo.models.bloom import modeling_bloom as JB
from easynlp_tpu.modelzoo.models.cnn import modeling_cnn as JC
from easynlp_tpu_torch.modelzoo.models.bloom import modeling_bloom as PB
from easynlp_tpu_torch.modelzoo.models.cnn import modeling_cnn as PC
from test_torch_knowledge import ids_and_mask, init_jax

ATOL = 1e-5
BLOOM = dict(vocab_size=60, hidden_size=32, n_layer=2, n_head=4,
             hidden_dropout=0.0, attention_dropout=0.0)


@pytest.mark.parametrize("kernel_sizes", [(2, 3, 4, 5), (3,)])
def test_textcnn_matches_jax(kernel_sizes):
    """Pooled features of rows of 3-10 real tokens: the padded output
    positions (-1e30 before the max) never win, though the windows at a
    row's end read its padding ids, as in JAX."""
    kw = dict(vocab_size=60, embedding_size=16, kernel_sizes=kernel_sizes,
              num_filters=8, hidden_dropout_prob=0.0)
    ids, mask = ids_and_mask(0, b=4, s=10)
    module = JC.TextCNNModel(config=JC.TextCNNConfig(**kw))
    params = init_jax(module, input_ids=ids, attention_mask=mask)
    want = jax.jit(lambda p: module.apply({"params": p},
                                          input_ids=jnp.asarray(ids),
                                          attention_mask=jnp.asarray(mask)))(
        params)
    cfg = PC.TextCNNConfig(**kw)
    port = PC.TextCNNModel(cfg)
    port.load_state_dict(PC.state_dict_from_jax(params, cfg), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    assert got["pooler_output"].shape == (4, 8 * len(kernel_sizes))
    np.testing.assert_allclose(got["pooler_output"].numpy(),
                               np.asarray(want["pooler_output"]),
                               atol=ATOL, rtol=0)
    assert (got["pooler_output"] >= 0).all()  # ReLU'd real positions


@pytest.fixture(scope="module")
def bloom():
    """(JAX params, the port's BloomForCausalLM with JAX's exact GELU, its
    config, ids, mask)."""
    ids, mask = ids_and_mask(1, b=3, s=9)
    module = JB.BloomForCausalLM(config=JB.BloomConfig(**BLOOM))
    params = init_jax(module, input_ids=ids, attention_mask=mask)
    cfg = PB.BloomConfig(**BLOOM)
    act, PB.BLOOM_ACT = PB.BLOOM_ACT, "gelu"  # the JAX module's numerics
    try:
        port = PB.BloomForCausalLM(cfg)
    finally:
        PB.BLOOM_ACT = act
    port.load_state_dict(PB.state_dict_from_jax(params, cfg), strict=True)
    return module, params, port.eval(), cfg, ids, mask


def test_bloom_matches_jax(bloom):
    """Logits and the final hidden state of right-padded rows (ALiBi over
    each row's real keys, causal) in f32."""
    module, params, port, _, ids, mask = bloom
    want = jax.jit(lambda p: module.apply({"params": p},
                                          input_ids=jnp.asarray(ids),
                                          attention_mask=jnp.asarray(mask)))(
        params)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask))
    real = mask.astype(bool)
    for key in ("logits", "last_hidden_state"):
        np.testing.assert_allclose(got[key].numpy()[real],
                                   np.asarray(want[key])[real],
                                   atol=ATOL, rtol=0, err_msg=key)


def test_alibi_matches_jax():
    """Slopes for 4, 12 and 20 heads (20 is not a power of two: the extra
    slopes interleave) and the bias of a left-padded row."""
    for h in (4, 12, 20):
        np.testing.assert_array_equal(PB.alibi_slopes(h),
                                      JB.alibi_slopes(h))
    mask = np.array([[0, 0, 1, 1, 1], [1, 1, 1, 1, 1]], np.int32)
    np.testing.assert_allclose(
        PB.alibi_bias(torch.from_numpy(mask), 20).numpy(),
        np.asarray(JB.alibi_bias(jnp.asarray(mask), 20)), atol=0, rtol=0)


def _hf_bloom(seed=0):
    os.environ.setdefault("USE_TF", "0")  # transformers' torch side only
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(seed)
    # weights of std 0.3, so the MLP's pre-activations spread over
    # [-3, 3], where the two GELUs part
    hf = transformers.BloomForCausalLM(transformers.BloomConfig(
        vocab_size=60, hidden_size=32, n_layer=2, n_head=4,
        hidden_dropout=0.0, attention_dropout=0.0,
        initializer_range=0.3)).eval()
    with torch.no_grad():  # biases and LayerNorms off their init
        for p in hf.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    return hf


@pytest.mark.parametrize("act", ["gelu_new", "gelu"])
def test_bloom_matches_transformers_reference_fault_38(act, monkeypatch):
    """An HF BloomForCausalLM's state dict loads with no converter; with
    BLOOM's tanh GELU (the port's default) the logits are transformers'
    within 1e-5. With the JAX module's exact erf GELU (`gelu`) they part
    by more than that: the JAX BLOOM computes another function."""
    hf = _hf_bloom()
    ids, mask = ids_and_mask(2, b=3, s=9)
    monkeypatch.setattr(PB, "BLOOM_ACT", act)
    port = PB.BloomForCausalLM(PB.BloomConfig(**BLOOM))
    port.load_state_dict(PB.normalize_keys(hf.state_dict()), strict=True)
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(ids).long(),
                  attention_mask=torch.from_numpy(mask).long()).logits
        got = port.eval()(torch.from_numpy(ids), torch.from_numpy(mask))
    real = torch.from_numpy(mask).bool()
    gap = (got["logits"] - want)[real].abs().max().item()
    if act == "gelu_new":
        assert gap <= ATOL, gap
    else:
        assert gap > 10 * ATOL, gap


@pytest.mark.parametrize("source", ["flax", "hf", "hf-prefixed"])
def test_auto_model_loads_bloom_and_cnn(tmp_path, source):
    """AutoModel.from_pretrained: a TextCNN and a BLOOM directory holding
    the JAX package's flax_params.msgpack give state_dict_from_jax's
    weights bit for bit; a BLOOM directory holding HF's pytorch_model.bin
    (keys with or without `transformer.`, the tied lm_head.weight
    included) gives HF's."""
    from easynlp_tpu.modelzoo.modeling_utils import save_params
    from easynlp_tpu_torch.modelzoo.models import auto
    bloom_dir = tmp_path / "bloom"
    bloom_dir.mkdir()
    with open(bloom_dir / "config.json", "w") as f:
        json.dump(dict(BLOOM, model_type="bloom"), f)
    if source == "flax":
        ids, mask = ids_and_mask(3)
        params = init_jax(JB.BloomForCausalLM(config=JB.BloomConfig(**BLOOM)),
                          input_ids=ids, attention_mask=mask)
        save_params(params, str(bloom_dir))
        want = PB.state_dict_from_jax(params, PB.BloomConfig(**BLOOM))
        cnn_dir = tmp_path / "cnn"
        cnn_dir.mkdir()
        kw = dict(vocab_size=60, embedding_size=16, num_filters=8)
        with open(cnn_dir / "config.json", "w") as f:
            json.dump(dict(kw, model_type="cnn"), f)
        cnn_params = init_jax(JC.TextCNNModel(config=JC.TextCNNConfig(**kw)),
                              input_ids=ids, attention_mask=mask)
        save_params(cnn_params, str(cnn_dir))
        cnn = auto.AutoModel.from_pretrained(str(cnn_dir), device="cpu")
        for k, v in PC.state_dict_from_jax(
                cnn_params, PC.TextCNNConfig(**kw)).items():
            assert torch.equal(cnn.state_dict()[k], v), k
    else:
        hf = _hf_bloom(seed=1).state_dict()
        if source == "hf":  # the bigscience checkpoints' unprefixed keys
            hf = {k[len("transformer."):] if k.startswith("transformer.")
                  else k: v for k, v in hf.items()}
        torch.save(hf, bloom_dir / "pytorch_model.bin")
        want = PB.normalize_keys(hf)
        assert "lm_head.weight" not in want
    module = auto.AutoModel.from_pretrained(str(bloom_dir), device="cpu")
    assert type(module).__name__ == "BloomForCausalLM" and not module.training
    for k, v in want.items():
        assert torch.equal(module.state_dict()[k], v), k
