#!/usr/bin/env python3
"""Run-to-run determinism of training steps on one card.

    python3 chip_diag/determinism.py [mlm] [t5] [kangaroo]
        (from the repository root, on a card; no argument runs all three)

mlm: builds chip_smoke.py's BERT-base MLM directory and rows from the
seed, then (1) runs forward and backward four times on one batch, with
dropout on and off, and prints every parameter whose gradient differs
from the first run's; (2) trains 8 steps four times, at
--num_host_prefetch 2, 0, 0, 2, and prints whether each run's per-step
input checksums and (loss, grad norm) trajectory equal the first run's.

t5 and kangaroo: chip_smoke.py's phase-15 T5-base fixture (8 x 512
sources, 64-token targets, bf16) and phase-14 Kangaroo fixture (32 x 128,
bf16), each trained 4 steps twice through the CLI with the kernels; prints
whether the two (loss, grad norm) trajectories are bit-identical and, for
the first step whose gradients differ, every parameter whose gradient
differs (the gradients are read as the optimizer receives them). Lines to
read start with DIAG.
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


def mlm(work, train, model_dir):
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


def twice(tag, run):
    """run() (a 4-step training through the CLI) twice, capturing each
    step's gradients as the optimizer receives them; DIAG lines compare
    the trajectories and name the parameters of the first step whose
    gradients differ. Returns the two runs' [(loss, grad norm), ...] and
    the names of the gradients that differ (at the first step where any
    does)."""
    real_step = T.Trainer._train_step
    captured = []

    def step(self, inputs):
        opt_step = self.optimizer.step

        def capture(grads, apply):
            captured[-1].append({n: g.detach().clone() for n, g
                                 in zip(self.param_names, grads)})
            return opt_step(grads, apply=apply)
        self.optimizer.step = capture
        try:
            return real_step(self, inputs)
        finally:
            self.optimizer.step = opt_step
    T.Trainer._train_step = step
    runs = []
    try:
        for _ in range(2):
            captured.append([])
            r = run()
            runs.append([(x["loss"], x["grad_norm"]) for x in r["records"]])
    finally:
        T.Trainer._train_step = real_step
    print("DIAG %s: trajectory identical %s; run 0 %s; run 1 %s"
          % (tag, runs[0] == runs[1], runs[0], runs[1]), flush=True)
    diff = []
    for i, (a, b) in enumerate(zip(*captured)):
        diff = [(n, float((b[n] - g).abs().max())) for n, g in a.items()
                if not torch.equal(b[n], g)]
        print("DIAG %s step %d: %d of %d gradients differ between the runs"
              "%s" % (tag, i + 1, len(diff), len(a),
                      ": %s" % diff if diff else ""), flush=True)
        if diff:
            break
    captured.clear()
    torch.cuda.empty_cache()
    return runs, [n for n, _ in diff]


def t5(work):
    """phase 15's T5-base fixture, 4 bf16 steps of 8 x 512 / 64."""
    import random
    rng = random.Random(SEED + 15)
    words = ["".join(rng.choice(C.GEN_LETTERS)
                     for _ in range(rng.randint(2, 9))) for _ in range(3000)]
    path = os.path.join(work, "t5-random")
    C.make_s2s_model_dir(torch, path, C.T5_BASE, SEED, {
        "spiece.model": C.sp_model_bytes(C.t5_sp_pieces(rng))})
    from easynlp_tpu_torch.modelzoo.models.t5 import T5Tokenizer
    seq_len, batch, _, _ = C.S2S_RUNS["t5"]
    tsv = os.path.join(work, "t5_train.tsv")
    C.make_s2s_tsv(tsv, T5Tokenizer.from_pretrained(path).tokenize, words,
                   rng, 4 * batch, seq_len + 16)
    return twice("t5", lambda: C.run_train(
        torch, path, tsv, None, None, True, SEED,
        common=C._s2s_argv("sequence_generation", seq_len, batch, True)))


def kangaroo(work, cjk):
    """phase 14's Kangaroo fixture, 4 bf16 steps of 32 x 128."""
    paths, names = C._knowledge_tables(work, cjk, SEED)
    C._knowledge_tsvs(work, cjk, names, SEED)
    _, kangaroo_dir = C._make_knowledge_dirs(torch, work, SEED)
    tsv = os.path.join(work, "kangaroo_train4.tsv")
    with open(os.path.join(work, "kangaroo_train.tsv"),
              encoding="utf-8") as f:
        rows = f.readlines()[:4 * C.BATCH]
    with open(tsv, "w", encoding="utf-8") as f:
        f.writelines(rows)
    udp = ("enable_kangaroo=true entity_file=%s samples_file=%s "
           "concept_emb_file=%s %s" % (
               paths["entity_file"], paths["samples_file"],
               paths["concept_emb_file"], C.KANGAROO_UDP))
    return twice("kangaroo", lambda: C.run_train(
        torch, kangaroo_dir, tsv, None, None, True, SEED,
        common=C._knowledge_argv(True, udp)))


def main():
    wanted = sys.argv[1:] or ["mlm", "t5", "kangaroo"]
    work = tempfile.mkdtemp(prefix="diag_determinism_")
    if "t5" in wanted:
        t5(work)
    if "mlm" in wanted or "kangaroo" in wanted:
        cjk = C.make_model_dir(torch, os.path.join(work, C.MODEL_DIR), SEED)
        train = os.path.join(work, "train.tsv")
        C.make_tsv(train, cjk, SEED + 1)
        model_dir = C.make_mlm_model_dir(torch, work, SEED)
        if "kangaroo" in wanted:
            kangaroo(work, cjk)
        if "mlm" in wanted:
            mlm(work, train, model_dir)


if __name__ == "__main__":
    main()
