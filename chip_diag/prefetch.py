#!/usr/bin/env python3
"""What the prefetcher costs and saves in the BERT-base MLM step, on one
card.

    python3 chip_diag/prefetch.py     (from the repository root, on a card)

Builds chip_smoke.py's BERT-base MLM directory and rows from the seed and
runs 8 kernel steps of 32 x 128 at --num_host_prefetch 2 and 0: with the
interpreter's default thread switch interval (5 ms) and with 0.1 ms, and
with every batch featurised before the epoch (so the producer thread only
stages and copies), each twice, the second round in reverse order. Prints
each run's median step time over steps 2-8 (CUDA events). Lines to read
start with DIAG.
"""
import os
import statistics
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402
from easynlp_tpu_torch.data import dataset as D  # noqa: E402

SEED = 1234


def main():
    work = tempfile.mkdtemp(prefix="diag_prefetch_")
    C.phase_device(torch)
    cjk = C.make_model_dir(torch, os.path.join(work, C.MODEL_DIR), SEED)
    train = os.path.join(work, "train.tsv")
    C.make_tsv(train, cjk, SEED + 1)
    mlm = C.make_mlm_model_dir(torch, work, SEED)
    real_iter = D.DataLoader.iter_from

    def featurised_first(self, start):
        return iter(list(real_iter(self, start)))

    cfgs = [("pf0", 0, 5e-3, False), ("pf2", 2, 5e-3, False),
            ("pf2-si0.1ms", 2, 1e-4, False), ("pf0-si0.1ms", 0, 1e-4, False),
            ("pf2-prefeat", 2, 5e-3, True), ("pf0-prefeat", 0, 5e-3, True)]
    medians = {}
    interval = sys.getswitchinterval()
    try:
        for rnd in range(2):
            for tag, prefetch, switch, pre in (cfgs if rnd == 0
                                               else cfgs[::-1]):
                sys.setswitchinterval(switch)
                D.DataLoader.iter_from = featurised_first if pre \
                    else real_iter
                r = C.run_train(torch, mlm, train, None, None, True, SEED,
                                common=C._mlm_argv(True, prefetch),
                                logging_steps=8)
                ms = [1e3 * x["seconds"] for x in r["records"]]
                medians.setdefault(tag, []).append(statistics.median(ms[1:]))
    finally:
        sys.setswitchinterval(interval)
        D.DataLoader.iter_from = real_iter
    for tag, v in medians.items():
        print("DIAG SUMMARY %s: medians of steps 2-8 %s"
              % (tag, [round(x, 2) for x in v]))


if __name__ == "__main__":
    main()
