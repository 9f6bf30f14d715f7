"""Two app paths of the PyTorch port on the card, through the kernels: BART
generation (the encoder and cross-attention past 512 keys on the flash
forward, the decoder's self-attention over its cache on the short forward,
one query a row) and one machine_reading_comprehension training step at
384 keys (the short forward, and the short backward's route past 128 keys:
an LSE pass, then the flash backward's passes).

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_apps_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

Bounds, bf16 with the kernels against the same model with
--use_flash_attention=false: teacher-forced logits and the MRC loss within
5e-2 (chip_smoke.py's SLICE_ATOL, a bf16 ulp per layer, two layers here),
and the gradient of all parameters within 5e-2 of the plain path's in
relative norm (the plain path rounds the scores and probabilities to bf16
as well), the key projections' biases left out: their true gradient is 0,
and both paths hold only rounding noise there.
"""

import pytest
import torch

from easynlp_tpu_torch.ops import attention as A

pytestmark = pytest.mark.gpu
ATOL = 5e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _counts():
    return {w: getattr(A, w).launches for w in (
        "short_attention_fwd", "short_attention_bwd", "flash_attention_fwd",
        "flash_attention_bwd")}


@pytest.mark.parametrize("num_beams", [1, 4])
def test_bart_generate_runs_the_kernels(num_beams):
    _need_card()
    from easynlp_tpu_torch.modelzoo.models.bart import (
        BartConfig,
        BartForConditionalGeneration,
    )
    from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
        encoder_decoder_generate,
    )
    config = BartConfig(vocab_size=512, d_model=128, encoder_layers=2,
                        decoder_layers=2, encoder_attention_heads=2,
                        decoder_attention_heads=2, encoder_ffn_dim=256,
                        decoder_ffn_dim=256, dropout=0.0)
    model = BartForConditionalGeneration(config, dtype=torch.bfloat16,
                                         device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    model.eval()
    g = torch.Generator().manual_seed(1)
    src = torch.randint(4, 512, (4, 700), generator=g).cuda()
    lengths = torch.tensor([700, 650, 600, 520])
    mask = (torch.arange(700)[None] < lengths[:, None]).int().cuda()
    before = _counts()
    with torch.inference_mode():
        ids = encoder_decoder_generate(model, src, mask, max_length=16,
                                       num_beams=num_beams, min_length=16)
    used = {k: v - before[k] for k, v in _counts().items()}
    assert ids.shape == (4, 16) and (ids[:, 0] == 2).all()
    # the encoder's 2 layers, then 2 decoder layers x (the start token + 14
    # decode steps), each a cross (flash) and a self (short) forward
    assert used == {"short_attention_fwd": 30, "short_attention_bwd": 0,
                    "flash_attention_fwd": 32, "flash_attention_bwd": 0}
    logits = {}
    with torch.inference_mode():
        for use_kernel in (True, False):
            A.set_kernel_override(None if use_kernel else False)
            logits[use_kernel] = model(src, mask, decoder_input_ids=ids)[
                "logits"].float()
    A.set_kernel_override(None)
    assert torch.isfinite(logits[True]).all()
    assert (logits[True] - logits[False]).abs().max().item() <= ATOL


def test_mrc_train_step_runs_the_kernels():
    _need_card()
    from easynlp_tpu_torch.appzoo.machine_reading_comprehension.model import (
        MachineReadingComprehension,
    )
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    config = BertConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256,
                        max_position_embeddings=512, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    module = MachineReadingComprehension.build_module(
        config, dtype=torch.bfloat16, device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(0))
    module.train()
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(4, 512, (4, 384), generator=g).cuda()
    lengths = torch.tensor([384, 300, 200, 97])
    mask = (torch.arange(384)[None] < lengths[:, None]).int().cuda()
    types = ((torch.arange(384)[None] >= 20).int().cuda() * mask)
    batch = {"start_positions": torch.tensor([30, 50, 21, 0]).cuda(),
             "end_positions": torch.tensor([33, 52, 40, 0]).cuda()}
    losses, grads = {}, {}
    for use_kernel in (True, False):
        A.set_kernel_override(None if use_kernel else False)
        before = _counts()
        out = module(ids, attention_mask=mask, token_type_ids=types)
        loss = MachineReadingComprehension.loss_fn(out, batch)["loss"]
        loss.backward()
        used = {k: v - before[k] for k, v in _counts().items()}
        want = dict.fromkeys(used, 0)
        if use_kernel:  # one forward and one backward launch per layer
            want.update(short_attention_fwd=2, short_attention_bwd=2)
        assert used == want
        losses[use_kernel] = loss.item()
        grads[use_kernel] = {n: p.grad.float().clone()
                             for n, p in module.named_parameters()}
        module.zero_grad(set_to_none=True)
    A.set_kernel_override(None)
    assert abs(losses[True] - losses[False]) <= ATOL
    names = [n for n in grads[True]
             if not n.endswith("attention.self.key.bias")]
    for name in names:
        assert torch.isfinite(grads[True][name]).all(), name
    flat = {k: torch.cat([grads[k][n].flatten() for n in names])
            for k in (True, False)}
    rel = (flat[True] - flat[False]).norm() / flat[False].norm()
    assert rel.item() <= ATOL, rel.item()
