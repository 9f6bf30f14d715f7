#!/usr/bin/env python3
"""Where the host spends the BERT-base training step, from a torch.profiler
trace of steps 3-6, on one card.

    python3 chip_diag/hostpath.py     (from the repository root, on a card)

Builds chip_smoke.py's BERT-base directories and rows from the seed and
traces 8 kernel steps of MLM at --num_host_prefetch 2 and 0 and of
text_classify; prints, per run, the CPU operators' time by thread, the
largest operators, and the CUDA runtime calls (counts and ms over the 4
traced steps). Lines to read start with DIAG.
"""
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402

SEED = 1234


def summarize(tag, path):
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    ops, runtime, threads = {}, {}, {}
    for e in events:
        cat = e.get("cat", "")
        table = (runtime if cat in ("cuda_runtime", "cuda_driver") else ops
                 if cat == "cpu_op" else None)
        if table is not None:
            count, ms = table.get(e["name"], (0, 0.0))
            table[e["name"]] = (count + 1, ms + e["dur"] / 1e3)
        if cat == "cpu_op":
            count, ms = threads.get(e.get("tid"), (0, 0.0))
            threads[e.get("tid")] = (count + 1, ms + e["dur"] / 1e3)
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:25]
    calls = sorted(runtime.items(), key=lambda kv: -kv[1][1])[:12]
    print("DIAG %s cpu ops by thread (count, ms): %s" % (tag, threads))
    print("DIAG %s top cpu ops (count, ms): %s" % (tag, top))
    print("DIAG %s runtime calls (count, ms): %s" % (tag, calls))


def main():
    work = tempfile.mkdtemp(prefix="diag_hostpath_")
    C.phase_device(torch)
    cjk = C.make_model_dir(torch, os.path.join(work, C.MODEL_DIR), SEED)
    train = os.path.join(work, "train.tsv")
    C.make_tsv(train, cjk, SEED + 1)
    mlm = C.make_mlm_model_dir(torch, work, SEED)
    for tag, common, model in (
            ("mlm-pf2", C._mlm_argv(True, 2), mlm),
            ("mlm-pf0", C._mlm_argv(True, 0), mlm),
            ("classify", None, os.path.join(work, C.MODEL_DIR))):
        prof = os.path.join(work, "prof_" + tag)
        r = C.run_train(torch, model, train, None, None, True, SEED,
                        profile_dir=prof, common=common, logging_steps=8)
        print("DIAG %s step ms %s"
              % (tag, [round(1e3 * x["seconds"], 2) for x in r["records"]]))
        summarize(tag, os.path.join(prof, "trace.json"))


if __name__ == "__main__":
    main()
