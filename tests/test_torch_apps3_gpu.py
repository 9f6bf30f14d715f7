"""--remat, LoRA and the EMA on the card, through the kernels.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_apps3_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

- --remat: BERT text_classify (width 128, 2 layers, 4 x 128, rows of 22-128
  tokens, dropout on) and BART (d_model 64, 2 + 2 layers, sources of 520
  tokens, so the encoder takes the flash kernels) train one step at every
  policy: the loss and every gradient bit for bit those of no remat, in
  bf16 and f32 (the kernels use no atomics, so the recomputed forward is
  the forward); 'full' launches the forward kernel twice a layer, the
  other policies once.
- LoRA: the merged weights on the card against the CPU's (1e-6 of the
  largest weight; one f32 rank-4 product), and the LoRA module's forward
  (the merge through each adapted weight's parametrization) against the
  plain module holding the merged weights, bit for bit.
- The EMA: 4 updates on the card against the CPU's (1e-6), the count on
  the device.
- The checkpoint snapshot (host_copy): pinned, equal, finished.
"""

import pytest
import torch

from easynlp_tpu_torch.ops import attention as A

pytestmark = pytest.mark.gpu
POLICIES = ("full", "selective", "names")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _bert(dtype):
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification)
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    config = BertConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        max_position_embeddings=130)
    module = SequenceClassification.build_module(config, dtype=dtype,
                                                 device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator().manual_seed(3)
    mask = (torch.arange(128)[None] < torch.tensor([128, 22, 64, 97])[:, None]
            ).int()
    ids = torch.randint(4, 512, (4, 128), generator=g) * mask
    inputs = {"input_ids": ids.cuda(), "attention_mask": mask.cuda(),
              "token_type_ids": torch.zeros_like(ids).cuda()}
    batch = {"label_ids": torch.tensor([0, 1, 1, 0]).cuda()}
    return SequenceClassification, module, inputs, batch


def _bart(dtype):
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    from easynlp_tpu_torch.modelzoo.models.bart import BartConfig
    config = BartConfig(vocab_size=300, d_model=64, encoder_layers=2,
                        decoder_layers=2, encoder_attention_heads=2,
                        decoder_attention_heads=2, encoder_ffn_dim=128,
                        decoder_ffn_dim=128, max_position_embeddings=600,
                        dropout=0.1, activation_dropout=0.1)
    module = SequenceGeneration.build_module(config, dtype=dtype,
                                             device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(0))
    g = torch.Generator().manual_seed(4)
    src = torch.randint(3, 300, (2, 520), generator=g)
    src_mask = (torch.arange(520)[None] < torch.tensor([520, 300])[:, None]
                ).int()
    dec = torch.randint(3, 300, (2, 16), generator=g)
    inputs = {"input_ids": src.cuda(), "attention_mask": src_mask.cuda(),
              "decoder_input_ids": dec.cuda(),
              "decoder_attention_mask": torch.ones_like(dec).int().cuda()}
    batch = {"labels": torch.randint(3, 300, (2, 16), generator=g).cuda()}
    return SequenceGeneration, module, inputs, batch


def _step(app, module, inputs, batch, policy):
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        set_remat)
    set_remat(module, policy)
    module.train()
    module.zero_grad()
    torch.manual_seed(7)
    fwd = (A.short_attention_fwd.launches, A.flash_attention_fwd.launches)
    loss = app.loss_fn(module(**inputs), batch)["loss"]
    loss.backward()
    torch.cuda.synchronize()
    launched = (A.short_attention_fwd.launches + A.flash_attention_fwd.launches
                - sum(fwd))
    return loss.detach(), {n: p.grad.clone()
                           for n, p in module.named_parameters()}, launched


# forward kernel launches a pass: BERT's 2 layers; BART's 2 encoder layers
# (flash), 2 decoder self-attentions (short) and 2 cross-attentions (flash)
FORWARD_LAUNCHES = {"bert": 2, "bart": 6}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("model", ["bert", "bart"])
def test_remat_recompute_is_bit_identical_on_the_card(model, dtype):
    _need_card()
    app, module, inputs, batch = {"bert": _bert, "bart": _bart}[model](dtype)
    loss, grads, launched = _step(app, module, inputs, batch, "none")
    assert launched == FORWARD_LAUNCHES[model]
    for policy in POLICIES:
        got_loss, got_grads, got_launched = _step(app, module, inputs, batch,
                                                  policy)
        assert torch.equal(got_loss, loss), policy
        for n, g in grads.items():
            assert torch.equal(got_grads[n], g), (policy, n)
        # BERT's selective and names keep the attention out of the
        # recomputed part; BART's policies recompute the whole layer
        again = policy == "full" or model == "bart"
        assert got_launched == launched * (2 if again else 1), \
            (policy, got_launched)


def test_lora_merge_on_the_card():
    _need_card()
    from easynlp_tpu_torch.core.lora_app import LoRAModule
    from easynlp_tpu_torch.modelzoo import lora
    from easynlp_tpu_torch.modelzoo.modeling_utils import substituted
    app, module, inputs, _ = _bert(torch.float32)
    adapters = lora.lora_init(module, rank=4, seed=1)
    assert len(adapters) == 6  # query, key and value of 2 layers
    g = torch.Generator().manual_seed(2)
    for ad in adapters.values():
        ad["b"].data.copy_(torch.randn(ad["b"].shape, generator=g))
    base = {n: p.detach().clone() for n, p in module.named_parameters()}
    merged = lora.lora_merge(module, base, adapters, 0.5)
    cpu_module = app.build_module(module.config, device="cpu")
    cpu = lora.lora_merge(
        cpu_module, {n: t.cpu() for n, t in base.items()},
        {n: {k: v.detach().cpu() for k, v in ad.items()}
         for n, ad in adapters.items()}, 0.5)
    for n, w in merged.items():
        scale = float(w.abs().max())
        torch.testing.assert_close(w.cpu(), cpu[n], atol=1e-6 * scale,
                                   rtol=0)
    wrapped = LoRAModule(module, adapters, 0.5).eval()
    with torch.no_grad():
        live = wrapped(**inputs)["logits"]
        with wrapped.plain() as inner, substituted(inner, merged):
            plain = inner(**inputs)["logits"]
    assert torch.equal(live, plain)


def test_ema_on_the_card():
    _need_card()
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion.ema import (
        ema_init,
        ema_update,
    )
    g = torch.Generator().manual_seed(5)
    steps = [[torch.randn(s, generator=g) for s in ((64, 32), (32,))]
             for _ in range(5)]
    cpu = ema_init(steps[0])
    card = ema_init([t.cuda() for t in steps[0]])
    assert card["num_updates"].device.type == "cuda"
    for params in steps[1:]:
        ema_update(cpu, params, decay=0.99)
        ema_update(card, [t.cuda() for t in params], decay=0.99)
    assert int(card["num_updates"]) == 4
    for a, b in zip(card["shadow"], cpu["shadow"]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-6, rtol=0)


def test_host_copy_on_the_card():
    """The checkpoint snapshot: pinned host copies of card tensors, equal to
    them, finished when host_copy returns (an in-place update after it
    does not reach the copy)."""
    _need_card()
    from easynlp_tpu_torch.modelzoo.modeling_utils import host_copy
    g = torch.Generator(device="cuda").manual_seed(6)
    state = {"w": torch.randn(1024, 768, device="cuda", generator=g),
             "m": [torch.randn(3072, device="cuda", generator=g)],
             "count": 3, "names": ["w"]}
    want = {"w": state["w"].cpu(), "m": [state["m"][0].cpu()]}
    snap = host_copy(state)
    state["w"].mul_(2)
    state["m"][0].zero_()
    assert snap["count"] == 3 and snap["names"] == ["w"]
    assert snap["w"].is_pinned() and snap["m"][0].is_pinned()
    assert torch.equal(snap["w"], want["w"])
    assert torch.equal(snap["m"][0], want["m"][0])
