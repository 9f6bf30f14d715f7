"""MLM pretraining and data augmentation of the PyTorch port on the card,
through the kernels, and the Trainer's prefetch and guard there.

This file imports no JAX, so the card's machine can run it:
    python -m pytest tests/test_torch_language_modeling_gpu.py -m gpu --noconftest
Each test skips itself where there is no card.

- One MLM training step (BERT at 4 x 128: the short forward and the short
  backward's one-block route; RoBERTa at 4 x 320 with rows of 160-320
  real tokens: the short backward's route past 128 keys), bf16 with the
  kernels against --use_flash_attention=false: the loss within 5e-2
  (chip_smoke.py's SLICE_ATOL, a bf16 ulp per layer, two layers here) and
  the gradient of all parameters within 5e-2 in relative norm, the key
  projections' biases left out (their true gradient is 0).
- data_augmentation's predictor with the kernels and without: each row
  gives two texts, and the refilled token ids agree wherever the plain
  logits' top-2 margin exceeds twice 5e-2.
- device_prefetch to the card (pinned staging, a side stream) hands out
  each batch intact while the compute stream is busy; a skipped optimizer
  step leaves parameters, moments and count bit for bit.
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


def _counts():
    return {w: getattr(A, w).launches for w in (
        "short_attention_fwd", "short_attention_bwd", "flash_attention_fwd",
        "flash_attention_bwd")}


def _mlm_app(model_type, seq):
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        LanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.bert import (BertConfig,
                                                         RobertaConfig)
    cls = RobertaConfig if model_type == "roberta" else BertConfig
    config = cls(vocab_size=512, hidden_size=128, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=256,
                 max_position_embeddings=seq + 2, hidden_dropout_prob=0.0,
                 attention_probs_dropout_prob=0.0)
    module = LanguageModeling.build_module(config, dtype=torch.bfloat16,
                                           device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(0))
    return LanguageModeling(module, config, "cuda")


def _mlm_batch(seq, lengths, pad, seed):
    g = torch.Generator().manual_seed(seed)
    b = len(lengths)
    mask = (torch.arange(seq)[None] < torch.tensor(lengths)[:, None]).int()
    ids = torch.where(mask == 1, torch.randint(4, 512, (b, seq), generator=g),
                      torch.full((b, seq), pad))
    pick = (torch.rand((b, seq), generator=g) < 0.15) & (mask == 1)
    labels = torch.where(pick, torch.randint(4, 512, (b, seq), generator=g),
                         torch.full((b, seq), -100))
    return {"input_ids": ids.cuda(), "attention_mask": mask.cuda(),
            "token_type_ids": torch.zeros_like(ids).cuda(),
            "label_ids": labels.cuda()}


@pytest.mark.parametrize("model_type,seq,lengths", [
    ("bert", 128, [128, 100, 77, 9]),
    ("roberta", 320, [320, 288, 200, 160]),
])
def test_mlm_train_step_runs_the_kernels(model_type, seq, lengths):
    _need_card()
    app = _mlm_app(model_type, seq)
    app.module.train()
    batch = _mlm_batch(seq, lengths, app.config.pad_token_id, seed=3)
    losses, grads = {}, {}
    for use_kernel in (True, False):
        A.set_kernel_override(None if use_kernel else False)
        before = _counts()
        loss = app.loss_fn(app.forward(batch), batch)["loss"]
        loss.backward()
        used = {k: v - before[k] for k, v in _counts().items()}
        want = dict.fromkeys(used, 0)
        if use_kernel:  # one forward and one backward launch per layer
            want.update(short_attention_fwd=2, short_attention_bwd=2)
        assert used == want
        losses[use_kernel] = loss.item()
        grads[use_kernel] = {n: p.grad.float().clone()
                             for n, p in app.module.named_parameters()}
        app.module.zero_grad(set_to_none=True)
    A.set_kernel_override(None)
    assert np.isfinite(losses[True])
    assert abs(losses[True] - losses[False]) <= ATOL
    names = [n for n in grads[True]
             if not n.endswith("attention.self.key.bias")]
    flat = {k: torch.cat([grads[k][n].flatten() for n in names])
            for k in (True, False)}
    assert torch.isfinite(flat[True]).all()
    rel = (flat[True] - flat[False]).norm() / flat[False].norm()
    assert rel.item() <= ATOL, rel.item()


def test_data_augmentation_runs_the_kernels(tmp_path):
    _need_card()
    from easynlp_tpu_torch.appzoo.data_augmentation.predictor import (
        DataAugmentationPredictor)
    words = ["the", "model", "good", "bad", "price", "phone", "very", "and"]
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    tokens += ["[unused%d]" % i for i in range(512 - len(tokens))]
    (tmp_path / "vocab.txt").write_text("\n".join(tokens) + "\n")
    app = _mlm_app("bert", 128)
    rng = np.random.RandomState(0)
    texts = [" ".join(rng.choice(words, rng.randint(20, 60)))
             for _ in range(8)]
    outs, ids = {}, {}
    for use_kernel in (True, False):
        A.set_kernel_override(None if use_kernel else False)
        predictor = DataAugmentationPredictor(
            str(tmp_path), app, first_sequence="text", sequence_length=128,
            batch_size=8, augment_count=2, seed=0)
        before = _counts()["short_attention_fwd"]
        pre = predictor.preprocess({"text": texts})
        model_inputs = {k: pre[k] for k in ("input_ids", "attention_mask",
                                            "token_type_ids")}
        chosen = pre["_chosen"]  # predict() takes it out of `pre`
        outs[use_kernel] = predictor.postprocess(predictor.predict(pre))
        assert (_counts()["short_attention_fwd"] - before
                == (4 if use_kernel else 0))  # 2 layers x 2 batches
        with torch.inference_mode():
            logits = app.forward({k: torch.from_numpy(v).cuda()
                                  for k, v in model_inputs.items()})[
                "logits"].float()
        ids[use_kernel] = (logits, chosen)
    A.set_kernel_override(None)
    for use_kernel in (True, False):
        rows = outs[use_kernel]["augmented"]
        assert len(rows) == 8 and all(len(r.split("\t")) == 2 for r in rows)
    (logits_k, chosen), (logits_p, _) = ids[True], ids[False]
    top2 = logits_p.topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > 2 * ATOL).cpu().numpy() \
        & chosen
    assert decided.sum() > 0
    agree = (logits_k.argmax(-1) == logits_p.argmax(-1)).cpu().numpy()
    assert agree[decided].all()


def test_prefetch_to_the_card_while_the_stream_is_busy():
    _need_card()
    from easynlp_tpu_torch.data.prefetch import device_prefetch
    rng = np.random.RandomState(1)
    host = [{"x": rng.randint(0, 1000, (64, 512)).astype(np.int32),
             "y": rng.standard_normal((64, 512)).astype(np.float32)}
            for _ in range(12)]
    a = torch.randn(4096, 4096, device="cuda")
    got = []
    for batch in device_prefetch(iter(host), "cuda", depth=2):
        a = a @ a  # keep the compute stream busy while copies land
        a = a / a.norm()
        assert batch["x"].is_cuda and batch["y"].is_cuda
        got.append({k: (v + 0).cpu().numpy() for k, v in batch.items()})
    assert len(got) == 12
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g["x"], h["x"])
        np.testing.assert_array_equal(g["y"], h["y"])


def test_skipped_step_keeps_state_on_the_card():
    _need_card()
    from easynlp_tpu_torch.core.optimizers import get_optimizer
    g = torch.Generator(device="cuda").manual_seed(0)
    named = [("w%d" % i, torch.nn.Parameter(torch.randn(
        (300, 70), generator=g, device="cuda"))) for i in range(3)]
    opt, _, _ = get_optimizer(named, optimizer_type="AdamW",
                              steps_per_epoch=4, epoch_num=1,
                              warmup_proportion=0.0)
    grads = [torch.randn(p.shape, generator=g, device="cuda")
             for _, p in named]
    opt.step(grads, apply=torch.tensor(True, device="cuda"))
    before = ([p.detach().clone() for _, p in named],
              [t.clone() for t in opt.state["mu"] + opt.state["nu"]])
    grads[1][0, 0] = float("nan")
    opt.step(grads, apply=torch.tensor(False, device="cuda"))
    assert int(opt.count) == 1
    for a, (_, p) in zip(before[0], named):
        assert torch.equal(a, p)
    for a, b in zip(before[1], opt.state["mu"] + opt.state["nu"]):
        assert torch.equal(a, b)
