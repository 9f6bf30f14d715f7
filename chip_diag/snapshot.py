#!/usr/bin/env python3
"""What the Trainer's checkpoint snapshot costs on the training thread.

    python3 chip_diag/snapshot.py     (from the repository root, on a card)

Builds what a BERT-base text_classify save with --ema_decay copies to the
host (the exported weights, the EMA weights and the AdamW state: 102M f32
parameters each, 1.6 GB in ~800 tensors) on the card, then times two ways
of copying it, in turns (pageable, pinned, pinned, pageable, twice over):
`pageable`, each tensor `.to("cpu")` as the Trainer first did (every copy
waits, into freshly allocated pageable memory), and `pinned`,
modeling_utils.host_copy (copies into pinned memory enqueued without
waiting, one wait at the end; the host allocator reuses the pinned blocks
of a freed snapshot). Each time is the host clock from the start of the
copy to the finished snapshot; the snapshot is then dropped, as after a
write. Lines to read start with DIAG.
"""
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402

ROUNDS = 2


def pageable(state):
    return {name: {k: v.detach().to("cpu", copy=True).contiguous()
                   for k, v in part.items()} for name, part in state.items()}


def main():
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification)
    from easynlp_tpu_torch.modelzoo.modeling_utils import host_copy
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    config = BertConfig(**{k: v for k, v in C.BERT_BASE_CHINESE.items()
                           if k not in ("architectures", "model_type")})
    module = SequenceClassification.build_module(
        config, dtype=torch.bfloat16, device="cuda", num_labels=2)
    module.init_weights(torch.Generator(device="cuda").manual_seed(0))
    weights = module.state_dict()
    state = {"weights": weights,
             "ema": {k: v.clone() for k, v in weights.items()},
             "mu": {k: torch.zeros_like(v) for k, v in weights.items()},
             "nu": {k: torch.zeros_like(v) for k, v in weights.items()}}
    n_bytes = sum(v.numel() * v.element_size() for part in state.values()
                  for v in part.values())
    n_tensors = sum(len(part) for part in state.values())
    times = {"pageable": [], "pinned": []}
    ways = {"pageable": pageable, "pinned": host_copy}
    for _ in range(ROUNDS):
        for way in ("pageable", "pinned", "pinned", "pageable"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            snap = ways[way](state)
            times[way].append(time.perf_counter() - t0)
            assert torch.equal(snap["weights"]["classifier.weight"],
                               weights["classifier.weight"].cpu())
            del snap
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("DIAG card %s" % card.strip())
    print("DIAG snapshot of %d tensors, %.3f GB (weights, EMA, AdamW's two "
          "moments of 102M f32 parameters)" % (n_tensors, n_bytes / 1e9))
    for way, values in times.items():
        print("DIAG %-8s s per snapshot, in run order: %s; median %.4f "
              "(%.2f GB/s)" % (way, " ".join("%.4f" % t for t in values),
                               statistics.median(values),
                               n_bytes / 1e9 / statistics.median(values)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
