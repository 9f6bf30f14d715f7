#!/usr/bin/env python3
"""Training step time against the read-back interval and the prefetch
depth, text_classify and MLM on BERT-base, on one card.

    python3 chip_diag/readback.py     (from the repository root, on a card)

Builds chip_smoke.py's BERT-base directories and rows from the seed, then
runs 8 kernel steps of 32 x 128 for each of text_classify and MLM x
--logging_steps 1 and 8 x --num_host_prefetch 2 and 0, twice, the second
round in reverse order, and prints each run's median step time over steps
2-8 (CUDA events, Trainer.step_records). Lines to read start with DIAG.
"""
import os
import statistics
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402

SEED = 1234


def main():
    work = tempfile.mkdtemp(prefix="diag_readback_")
    C.phase_device(torch)
    cjk = C.make_model_dir(torch, os.path.join(work, C.MODEL_DIR), SEED)
    train = os.path.join(work, "train.tsv")
    C.make_tsv(train, cjk, SEED + 1)
    dirs = {"mlm": C.make_mlm_model_dir(torch, work, SEED),
            "classify": os.path.join(work, C.MODEL_DIR)}
    cfgs = [(app, log_steps, prefetch) for app in ("classify", "mlm")
            for log_steps in (1, 8) for prefetch in (2, 0)]
    medians = {c: [] for c in cfgs}
    for rnd in range(2):
        for cfg in (cfgs if rnd == 0 else cfgs[::-1]):
            app, log_steps, prefetch = cfg
            common = (C._mlm_argv(True, prefetch) if app == "mlm" else
                      C._common_argv(True)
                      + ["--num_host_prefetch=%d" % prefetch])
            r = C.run_train(torch, dirs[app], train, None, None, True, SEED,
                            common=common, logging_steps=log_steps)
            ms = [1e3 * x["seconds"] for x in r["records"]]
            medians[cfg].append(statistics.median(ms[1:]))
    for (app, log_steps, prefetch), v in medians.items():
        print("DIAG SUMMARY %s log%d pf%d: medians (steps 2-8) %s"
              % (app, log_steps, prefetch, [round(x, 2) for x in v]))


if __name__ == "__main__":
    main()
