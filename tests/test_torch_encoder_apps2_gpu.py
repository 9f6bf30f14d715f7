"""information_extraction, geep_classify, Lion, Adafactor and the
prefetcher's drop on the card, through the kernels.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_encoder_apps2_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

- Global Pointer span scores (BERT at width 128, 2 layers, 4 x 128 with
  rows of 22-62 real tokens, bf16) with the kernels against
  --use_flash_attention=false: within 5e-2 (chip_smoke.py's SLICE_ATOL, a
  bf16 ulp per layer) on the unmasked spans, -1e30 on the same masked ones,
  one short forward launch per layer.
- GEEP's early-exit forward against its all-layers forward on the card:
  logits, probabilities, labels and exit layers bit for bit, at a
  threshold every row reaches at the first layer (one layer launched) and
  at one no row reaches.
- One Lion and one Adafactor step on the card against the same step on the
  CPU (f32, within 1e-6 of the largest parameter), and a skipped step that
  leaves parameters, state and count bit for bit.
- device_prefetch stopped with batches staged while the compute stream is
  busy (ROADMAP C17): the blocks the dropped batches held, handed out
  again on that stream and filled there, keep what was written into them.
"""

import numpy as np
import pytest
import torch

from easynlp_tpu_torch.ops import attention as A

pytestmark = pytest.mark.gpu
ATOL = 5e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def _config():
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    return BertConfig(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                      num_attention_heads=2, intermediate_size=256,
                      max_position_embeddings=130, hidden_dropout_prob=0.0,
                      attention_probs_dropout_prob=0.0)


def _batch(lengths, seq=128, seed=3):
    g = torch.Generator().manual_seed(seed)
    mask = (torch.arange(seq)[None] < torch.tensor(lengths)[:, None]).int()
    ids = torch.randint(4, 512, (len(lengths), seq), generator=g) * mask
    return {"input_ids": ids.cuda(), "attention_mask": mask.cuda(),
            "token_type_ids": torch.zeros_like(ids).cuda()}


def _app(app_cls, **kw):
    module = app_cls.build_module(_config(), dtype=torch.bfloat16,
                                  device="cuda", **kw)
    module.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return app_cls(module.eval(), module.config, "cuda")


def test_span_scores_run_the_kernels():
    _need_card()
    from easynlp_tpu_torch.appzoo.information_extraction.model import (
        InformationExtractionModel)
    app = _app(InformationExtractionModel, num_labels=10)
    batch = _batch([62, 22, 40, 57])
    scores = {}
    for use_kernel in (True, False):
        A.set_kernel_override(None if use_kernel else False)
        before = A.short_attention_fwd.launches
        with torch.inference_mode():
            scores[use_kernel] = app.forward(batch)["span_scores"]
        assert A.short_attention_fwd.launches - before == (
            2 if use_kernel else 0)
    A.set_kernel_override(None)
    k, p = scores[True], scores[False]
    assert k.dtype == torch.float32 and k.shape == (4, 10, 128, 128)
    masked = p <= -1e29
    assert torch.equal(k <= -1e29, masked)
    assert (k[~masked] - p[~masked]).abs().max().item() <= ATOL


def test_geep_early_exit_matches_all_layers_on_the_card():
    _need_card()
    from easynlp_tpu_torch.appzoo.geep_classification.model import (
        GEEPClassification)
    app = _app(GEEPClassification, num_labels=2)
    batch = _batch([128, 90, 33, 7, 128, 64, 12, 100])
    for threshold, layers in ((0.5, 1), (1.01, 2)):
        app.module.exit_threshold = threshold
        with torch.inference_mode():
            before = A.short_attention_fwd.launches
            early = app.forward(batch)
            launched = A.short_attention_fwd.launches - before
            full = app.module(**batch, all_layers=True)
        assert launched == layers
        assert early["exit_logits"].shape[0] == layers
        for key in ("logits", "probabilities", "predictions", "exit_layer"):
            assert torch.equal(early[key], full[key]), key


def _named(device, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"dense.weight": (256, 130), "emb.weight": (128, 300),
              "dense.bias": (130,), "LayerNorm.weight": (64,)}
    return [(k, torch.nn.Parameter(torch.randn(s, generator=g).to(device)))
            for k, s in shapes.items()]


@pytest.mark.parametrize("optimizer_type", ["Lion", "Adafactor"])
def test_optimizer_step_on_the_card(optimizer_type):
    _need_card()
    from easynlp_tpu_torch.core.optimizers import get_optimizer
    runs = {}
    for device in ("cpu", "cuda"):
        named = _named(device)
        opt, _, _ = get_optimizer(named, optimizer_type=optimizer_type,
                                  learning_rate=1e-2, steps_per_epoch=4,
                                  epoch_num=1, warmup_proportion=0.0,
                                  weight_decay=0.05, max_grad_norm=0.0)
        g = torch.Generator().manual_seed(1)
        grads = [torch.randn(p.shape, generator=g).to(device)
                 for _, p in named]
        opt.step(grads, apply=torch.tensor(True, device=device))
        before = ([p.detach().clone() for _, p in named],
                  {k: [t.clone() for t in v] for k, v in opt.state.items()})
        grads[0][0, 0] = float("nan")
        opt.step(grads, apply=torch.tensor(False, device=device))
        assert int(opt.count) == 1
        for a, (_, p) in zip(before[0], named):
            assert torch.equal(a, p)
        for key, bufs in before[1].items():
            for a, b in zip(bufs, opt.state[key]):
                assert torch.equal(a, b), key
        runs[device] = [p.detach().cpu() for _, p in named]
    scale = max(p.abs().max().item() for p in runs["cpu"])
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert (a - b).abs().max().item() <= 1e-6 * scale


def test_prefetch_drop_after_a_break_keeps_the_blocks():
    _need_card()
    from easynlp_tpu_torch.data.prefetch import device_prefetch
    rng = np.random.RandomState(2)
    host = [{"x": rng.randint(0, 1000, (256, 1024)).astype(np.int32)}
            for _ in range(8)]
    a = torch.randn(4096, 4096, device="cuda")
    for round_ in range(3):
        for i, batch in enumerate(device_prefetch(iter(host), "cuda",
                                                  depth=3)):
            for _ in range(4):  # the stream is busy as the loop stops
                a = a @ a
                a = a / a.norm()
            if i == 1:
                break
        fresh = [torch.empty((256, 1024), dtype=torch.int32, device="cuda")
                 for _ in range(6)]
        for j, t in enumerate(fresh):
            t.fill_(-1 - j - 10 * round_)
        torch.cuda.synchronize()
        for j, t in enumerate(fresh):
            assert (t == -1 - j - 10 * round_).all().item(), (round_, j)
