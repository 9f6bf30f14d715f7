"""Slice 11's paths on the card, through the kernels.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_slice11_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

- GLM (hidden 128, 4 heads, 2 layers): a prefill on its bias (plain), then
  decode steps and a shared-index verify chunk through the short kernel
  (one launch a layer each); f32 logits within 1e-4 of
  --use_flash_attention=false on the card, and greedy generation equal
  to the CPU's token for token.
- GPT-2 with int8 weights and the int8 KV cache, speculative decoding at
  a shared index: the verify chunks take the short kernel causally, and
  the tokens equal the CPU's (f32); the dequantized weights on the card
  equal the CPU's bit for bit.
"""

import pytest
import torch

from easynlp_tpu_torch.ops import attention as A

pytestmark = pytest.mark.gpu


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _glm(device):
    from easynlp_tpu_torch.appzoo.sequence_generation.glm import (
        GLMSequenceGeneration)
    from easynlp_tpu_torch.modelzoo.models.glm import (
        GLMConfig, GLMForConditionalGeneration)
    config = GLMConfig(vocab_size=300, hidden_size=128, num_layers=2,
                       num_attention_heads=4, max_sequence_length=128,
                       embedding_dropout_prob=0.0, output_dropout_prob=0.0)
    model = GLMForConditionalGeneration(config)
    model.init_weights(torch.Generator().manual_seed(0))
    return GLMSequenceGeneration(model.to(device).eval(), config, device)


def test_glm_decode_and_verify_take_the_short_kernel():
    _need_card()
    from easynlp_tpu_torch.appzoo.sequence_generation.glm import (
        make_glm_generation_fns)
    app = _glm("cuda")
    g = torch.Generator().manual_seed(1)
    src = torch.randint(4, 290, (4, 40), generator=g)
    prompts = torch.cat([src, torch.full((4, 1), 291),
                         torch.full((4, 1), 292)], 1).cuda()
    mask = torch.ones_like(prompts, dtype=torch.int32)
    toks = torch.randint(4, 290, (4, 5), generator=g).cuda()
    logits = {}
    for use_kernel in (True, False):
        A.set_kernel_override(None if use_kernel else False)
        prefill, decode = make_glm_generation_fns(app.module, 60,
                                                  cache_slack=9)
        before = A.short_attention_fwd.launches
        with torch.inference_mode():
            first, cache = prefill(prompts, mask)
            steps = [decode(toks[:, j:j + 1], cache)[0] for j in range(2)]
            chunk, cache = decode.chunk(toks[:, 2:], cache)
        launched = A.short_attention_fwd.launches - before
        logits[use_kernel] = torch.cat([first[:, None], torch.stack(
            steps, 1), chunk], 1)
        assert launched == (3 * 2 if use_kernel else 0)
    A.set_kernel_override(None)
    torch.testing.assert_close(logits[True], logits[False], atol=1e-4,
                               rtol=0)
    src_np = src.numpy()
    kw = dict(max_length=12, gmask_id=291, sop_id=292, eop_id=293,
              pad_id=0)
    on_card = app.generate(src_np, src_np > 0, **kw).cpu()
    on_cpu = _glm("cpu").generate(src_np, src_np > 0, **kw)
    assert torch.equal(on_card, on_cpu)


def test_gpt2_int8_speculative_matches_the_cpu():
    _need_card()
    from easynlp_tpu_torch.modelzoo import generation_utils as G
    from easynlp_tpu_torch.modelzoo.models.gpt2 import (GPT2Config,
                                                        GPT2LMHeadModel)
    from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns)
    from easynlp_tpu_torch.modelzoo.quantization import (dequantize_for,
                                                         quantize_params)
    config = GPT2Config(vocab_size=300, n_positions=256, n_embd=128,
                        n_layer=2, n_head=4, resid_pdrop=0.0,
                        embd_pdrop=0.0, attn_pdrop=0.0)
    out, weights = {}, {}
    motif = torch.randint(4, 290, (4, 5),
                          generator=torch.Generator().manual_seed(2))
    ids = motif.repeat(1, 8)
    mask = torch.ones_like(ids, dtype=torch.int32)
    for device in ("cuda", "cpu"):
        model = GPT2LMHeadModel(config)
        model.init_weights(torch.Generator().manual_seed(0))
        model = quantize_params(model.to(device).eval())
        weights[device] = dequantize_for(model)
        prefill, decode = make_gpt2_generation_fns(model, 80, cache_slack=9,
                                                   kv_cache="int8")
        before = A.short_attention_fwd.launches
        with torch.inference_mode():
            out[device] = G.generate(
                prefill, decode, ids.to(device), mask.to(device),
                max_length=80, speculative="prompt_lookup").cpu()
        if device == "cuda":
            assert A.short_attention_fwd.launches > before
    assert torch.equal(out["cuda"], out["cpu"])
    for name, w in weights["cpu"].items():
        assert torch.equal(weights["cuda"][name].cpu(), w), name
