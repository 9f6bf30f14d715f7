#!/usr/bin/env python3
"""Run-to-run determinism of the BERT-base MLM training step on one card.

    python3 chip_diag/determinism.py     (from the repository root, on a card)

Builds chip_smoke.py's BERT-base MLM directory and rows from the seed, then
(1) runs forward and backward four times on one batch, with dropout on and
off, and prints every parameter whose gradient differs from the first
run's; (2) trains 8 steps four times, at --num_host_prefetch 2, 0, 0, 2,
and prints whether each run's per-step input checksums and (loss, grad
norm) trajectory equal the first run's. Lines to read start with DIAG.
"""
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402
from easynlp_tpu_torch.appzoo.language_modeling.data import (  # noqa: E402
    LanguageModelingDataset)
from easynlp_tpu_torch.appzoo.language_modeling.model import (  # noqa: E402
    LanguageModeling)
from easynlp_tpu_torch.core import trainer as T  # noqa: E402
from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer  # noqa: E402

SEED = 1234


def main():
    work = tempfile.mkdtemp(prefix="diag_determinism_")
    cjk = C.make_model_dir(torch, os.path.join(work, C.MODEL_DIR), SEED)
    train = os.path.join(work, "train.tsv")
    C.make_tsv(train, cjk, SEED + 1)
    model_dir = C.make_mlm_model_dir(torch, work, SEED)

    ds = LanguageModelingDataset(
        train, BertTokenizer.from_pretrained(model_dir), max_seq_length=128,
        input_schema="id:str:1,sentence:str:1,label:str:1",
        first_sequence="sentence")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ds.batch_fn([ds[i] for i in range(32)]).items()}
    app = LanguageModeling.from_pretrained(model_dir, dtype=torch.bfloat16,
                                           device="cuda")
    for mode in ("train", "eval"):
        getattr(app.module, mode)()
        runs = []
        for _ in range(4):
            torch.manual_seed(7)
            loss = app.loss_fn(app.forward(batch), batch)["loss"]
            loss.backward()
            runs.append((loss.item(), {n: p.grad.clone() for n, p
                                       in app.module.named_parameters()}))
            app.module.zero_grad(set_to_none=True)
        for t in range(1, 4):
            diff = [(n, float((runs[t][1][n] - g).abs().max()))
                    for n, g in runs[0][1].items()
                    if not torch.equal(runs[t][1][n], g)]
            print("DIAG %s trial %d: loss %r vs %r; %d of %d gradients "
                  "differ: %s" % (mode, t, runs[t][0], runs[0][0], len(diff),
                                  len(runs[0][1]), diff[:8]), flush=True)
    del app

    real_step = T.Trainer._train_step
    sums = []

    def step(self, inputs):
        sums.append(torch.stack([
            v.double().sum() + (v.double() * torch.arange(
                v.numel(), device=v.device, dtype=torch.float64
            ).view_as(v)).sum() for _, v in sorted(inputs.items())]))
        return real_step(self, inputs)
    T.Trainer._train_step = step
    runs = []
    for prefetch in (2, 0, 0, 2):
        sums.clear()
        r = C.run_train(torch, model_dir, train, None, None, True, SEED,
                        common=C._mlm_argv(True, prefetch), logging_steps=8)
        runs.append((prefetch, [(x["loss"], x["grad_norm"])
                                for x in r["records"]],
                     torch.stack(sums).cpu().numpy()))
    for i in range(1, 4):
        print("DIAG run %d (prefetch %d) vs run 0 (prefetch %d): inputs "
              "identical %s, trajectory identical %s"
              % (i, runs[i][0], runs[0][0],
                 np.array_equal(runs[i][2], runs[0][2]),
                 runs[i][1] == runs[0][1]), flush=True)


if __name__ == "__main__":
    main()
