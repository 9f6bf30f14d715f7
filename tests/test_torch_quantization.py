"""The port's weight-only int8 and int8 KV cache (slice 11, A16) against
the JAX package's, on the CPU.

- The quantized set: for GPT-2, BERT, BART and T5 at widths where JAX's
  size threshold (min_size=4096 over its stacked [L, in, out] leaves, and
  BERT's fused qkv) decides, the port quantizes exactly the weights whose
  JAX leaves are quantized (mapped through each family's
  state_dict_from_jax).
- The bits: int8 values and f32 scales equal JAX's, and the weights a
  forward reads equal JAX's dequantize_for in f32 and in bf16 (the scale
  rounded to bf16 first), bit for bit; quantization_report's bytes equal
  JAX's for GPT-2 (its count is per layer: JAX counts stacked leaves);
  dequantize_params gives JAX's values.
- int8 KV generation in f32, with f32 and with int8 weights, equals
  JAX's token for token; the first logits within 1e-5 (the CLI's
  kv_cache_dtype=int8 is held to JAX's in test_torch_sequence_generation.py).

The int8 text_classify pipeline against JAX's is in test_torch_serving.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from easynlp_tpu.modelzoo import quantization as JQ
from easynlp_tpu_torch.modelzoo import quantization as Q

from test_torch_generation import _models as gpt2_models
from test_torch_generation import _prompts


def _marker(qtree):
    """The JAX tree with 1.0 where a leaf is quantized, 0.0 elsewhere, in
    the dequantized leaves' shapes (f32, so the conversions take it)."""
    if isinstance(qtree, dict):
        if JQ.QKEY in qtree:
            return np.ones(qtree[JQ.QKEY].shape, np.float32)
        return {k: _marker(v) for k, v in qtree.items()}
    return np.zeros(np.shape(qtree), np.float32)


def _gpt2():
    from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
        state_dict_from_jax)
    _, params, model = gpt2_models()
    return params, model, lambda p: {
        "transformer." + k: v for k, v in
        state_dict_from_jax(p, model.config).items()}


def _bert():
    from easynlp_tpu.modelzoo.models.bert import BertConfig as JaxConfig
    from easynlp_tpu.modelzoo.models.bert import BertModel as JaxBert
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig, BertModel
    from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
        state_dict_from_jax)
    tiny = dict(vocab_size=200, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=64)
    module = JaxBert.from_config(JaxConfig(**tiny), dtype=jnp.float32)
    rng = jax.random.PRNGKey(3)
    params = jax.tree.map(np.array, nn.unbox(module.init_params(
        {"params": rng, "dropout": rng},
        {"input_ids": jnp.ones((1, 8), jnp.int32)})))
    config = BertConfig(**tiny)
    model = BertModel(config)
    return params, model, lambda p: state_dict_from_jax(p, config)


def _bart():
    from test_torch_bart import _models
    from easynlp_tpu_torch.modelzoo.models.bart.conversion import (
        state_dict_from_jax)
    _, params, model = _models()
    return params, model, lambda p: state_dict_from_jax(p, model.config)


def _t5():
    from test_torch_t5 import FAMILIES, T5_TINY, jax_params, port_model
    from easynlp_tpu_torch.modelzoo.models.t5.conversion import (
        state_dict_from_jax)
    port_cls, jax_cls, extra = FAMILIES["t5"]
    model = port_model(port_cls(**T5_TINY, **extra))
    params = jax_params(model, jax_cls(**T5_TINY, **extra))
    return params, model, lambda p: state_dict_from_jax(p, model.config)


FAMILIES = {"gpt2": _gpt2, "bert": _bert, "bart": _bart, "t5": _t5}


def _gpt2_leaf(tree, name):
    """(layer, JAX GPT-2 kernel node) of a port weight name
    (`transformer.h.{i}.attn.c_attn.weight`; JAX's block holds c_fc and
    c_proj without the port's `mlp` level)."""
    _, _, i, rest = name.split(".", 3)
    node = tree["transformer"]["h"]
    for part in rest.split(".")[:-1]:
        if part != "mlp":
            node = node[part]
    return int(i), node["kernel"]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_set_matches_jax(family):
    params, model, from_jax = FAMILIES[family]()
    marks = from_jax(_marker(JQ.quantize_params(params)))
    want = {k for k, v in marks.items() if v.numel() and bool(v.all())}
    got = set(Q.quantize_targets(model))
    assert got == want
    # the threshold decides on these widths: some weights of each family
    # are quantized, some of the same rank are not
    two_d = {n for n, p in model.named_parameters() if p.dim() == 2}
    assert got and two_d - got
    Q.quantize_params(model)
    assert Q.is_quantized(model)
    assert set(Q.dequantize_for(model)) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantized_bits_match_jax(dtype):
    """GPT-2: int8 values, scales and the dequantized weights (JAX's
    dequantize_params at the compute dtype) bit for bit."""
    from easynlp_tpu_torch.modelzoo.models.gpt2 import (GPT2Config,
                                                        GPT2LMHeadModel)
    from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
        state_dict_from_jax)
    _, params, _ = gpt2_models()
    tdt = getattr(torch, dtype)
    model = GPT2LMHeadModel(GPT2Config(**dict(
        n_layer=2, n_embd=32, n_head=2, vocab_size=97, n_positions=64)),
        dtype=tdt)
    model.transformer.load_state_dict(state_dict_from_jax(
        params, model.config), strict=True)
    Q.quantize_params(model)
    qtree = JQ.quantize_params(params)
    deq = jax.tree.map(np.asarray, JQ.dequantize_params(
        qtree, dtype=getattr(jnp, dtype)))
    ours = Q.dequantize_for(model)
    assert len(ours) == 6  # c_attn, c_fc and mlp.c_proj of 2 layers
    for name, w in ours.items():
        i, kernel = _gpt2_leaf(deq, name)
        _, qleaf = _gpt2_leaf(qtree, name)
        assert w.dtype == tdt
        np.testing.assert_array_equal(
            w.float().numpy(), np.asarray(kernel[i], np.float32),
            err_msg=name)
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        q = owner.parametrizations.weight.original0
        scale = owner.parametrizations.weight.original1
        np.testing.assert_array_equal(q.numpy(),
                                      np.asarray(qleaf[JQ.QKEY][i]))
        np.testing.assert_array_equal(scale.numpy(),
                                      np.asarray(qleaf["scale"][i]))


def test_report_and_dequantize_params_match_jax():
    _, params, model = gpt2_models()
    Q.quantize_params(model)
    qb, ob, leaves = JQ.quantization_report(JQ.quantize_params(params))
    # the bytes equal; the port counts one weight a layer where JAX counts
    # one stacked leaf
    assert Q.quantization_report(model) == (qb, ob, 2 * leaves)
    names = set(Q.dequantize_for(model))
    Q.dequantize_params(model)
    assert not Q.is_quantized(model)
    deq = JQ.dequantize_params(JQ.quantize_params(params))
    for name in names:
        i, kernel = _gpt2_leaf(deq, name)
        np.testing.assert_array_equal(
            model.get_parameter(name).detach().numpy(),
            np.asarray(kernel[i]))


def test_int8_kv_generation_matches_jax():
    """f32, int8 KV cache: the first-token logits within 1e-5 and greedy
    tokens exactly."""
    from easynlp_tpu.modelzoo import generation_utils as J
    from easynlp_tpu.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns as jax_fns)
    from easynlp_tpu_torch.modelzoo import generation_utils as G
    from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns)
    jax_model, params, model = gpt2_models()
    ids, mask = _prompts(8, [4, 9, 6], 9)
    jp, jd = jax_fns(jax_model, 30, kv_cache="int8")
    pp, pd = make_gpt2_generation_fns(model, 30, kv_cache="int8")
    assert not hasattr(pd, "chunk_rowwise")
    with torch.inference_mode():
        jl, _ = jp(params, jnp.asarray(ids), jnp.asarray(mask))
        pl, cache = pp(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5)
        assert cache.k[0].dtype == torch.int8
        assert cache.k_scale[0].dtype == torch.float32
        got = G.generate(pp, pd, torch.from_numpy(ids).long(),
                         torch.from_numpy(mask), max_length=30).numpy()
    want = np.asarray(J.generate(jp, jd, params, jnp.asarray(ids),
                                 jnp.asarray(mask), max_length=30))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="kv_cache"):
        make_gpt2_generation_fns(model, 30, kv_cache="int4")


def test_int8_weights_generate_like_jax():
    """int8 weights (and an int8 cache) in f32: the port's tokens equal
    JAX's on its quantized params."""
    from easynlp_tpu.modelzoo import generation_utils as J
    from easynlp_tpu.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns as jax_fns)
    from easynlp_tpu_torch.modelzoo import generation_utils as G
    from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns)
    jax_model, params, model = gpt2_models()
    Q.quantize_params(model)
    ids, mask = _prompts(9, [5, 3], 5)
    jp, jd = jax_fns(jax_model, 20, kv_cache="int8")
    want = np.asarray(J.generate(jp, jd, JQ.quantize_params(params),
                                 jnp.asarray(ids), jnp.asarray(mask),
                                 max_length=20))
    pp, pd = make_gpt2_generation_fns(model, 20, kv_cache="int8")
    with torch.inference_mode():
        got = G.generate(pp, pd, torch.from_numpy(ids).long(),
                         torch.from_numpy(mask), max_length=20).numpy()
    np.testing.assert_array_equal(got, want)


def test_cast_keeps_int8_and_reads_in_the_cast_dtype():
    """cast_params after quantize_params (the serving order) leaves the
    int8 values and f32 scales as they are and gives the dequantized read
    the cast dtype, as JAX's cast passes its int8 leaves through."""
    _, _, model = gpt2_models()
    Q.quantize_params(model)
    before = {n: p.clone() for n, p in model.named_parameters()
              if ".parametrizations." in n}
    Q.cast_params(model, torch.bfloat16)
    for n, p in model.named_parameters():
        if n in before:
            assert torch.equal(p, before[n]) and p.dtype == before[n].dtype
    w = model.transformer.h[0].attn.c_attn.weight
    assert w.dtype == torch.bfloat16
