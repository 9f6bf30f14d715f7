#!/usr/bin/env python3
"""What one optimizer step over BERT-base's parameters costs on the card,
kernel by kernel.

    python3 chip_diag/optimizer_step.py     (from the repository root, on a card)

Builds the BERT-base text_classify module (bert-base-chinese widths, the
weights drawn from a seed; 102M f32 parameters) and one set of f32
gradients, then for AdamW, Lion and Adafactor profiles 5 steps guarded as
the Trainer takes them (apply=True) and 5 unguarded (apply=None), and
prints per step the device ms of each kernel name, the number of kernels
launched and the bytes a step must move (each parameter, gradient and
state buffer read once and each written once). Lines to read start with
DIAG.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402

STEPS = 5


def profile(fn):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.device_time_total:
            ms, n = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + e.device_time_total / 1e3 / STEPS,
                              n + e.count / STEPS)
    return kernels


def main():
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification)
    from easynlp_tpu_torch.core.optimizers import get_optimizer
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2
    config = BertConfig(**{k: v for k, v in C.BERT_BASE_CHINESE.items()
                           if k not in ("architectures", "model_type")})
    module = SequenceClassification.build_module(
        config, dtype=torch.bfloat16, device="cuda", num_labels=2)
    module.init_weights(torch.Generator(device="cuda").manual_seed(0))
    params = list(module.parameters())
    n = sum(p.numel() for p in params)
    g = torch.Generator(device="cuda").manual_seed(1)
    grads = [1e-3 * torch.randn(p.shape, generator=g, device="cuda")
             for p in params]
    flag = torch.tensor(True, device="cuda")
    print("DIAG card: %s; %d parameters in %d tensors"
          % (C.card_line(), n, len(params)), flush=True)
    # bytes a step must move: p, g read; p written; and each state buffer
    # read and written (AdamW 2 moments, Lion 1, Adafactor its factored
    # statistics, ~0 of n)
    state_bufs = {"AdamW": 2, "Lion": 1, "Adafactor": 0}
    for kind in ("AdamW", "Lion", "Adafactor"):
        opt, _, _ = get_optimizer(module.named_parameters(),
                                  optimizer_type=kind, learning_rate=1e-6,
                                  steps_per_epoch=1000, epoch_num=1,
                                  max_grad_norm=0.0)
        nbytes = 4 * n * (3 + 2 * state_bufs[kind])
        for tag, apply in (("guarded", flag), ("unguarded", None)):
            kernels = profile(lambda: opt.step(grads, apply=apply))
            total = sum(ms for ms, _ in kernels.values())
            launched = sum(c for _, c in kernels.values())
            print("DIAG %s %s: device %.3f ms per step over %d kernels; "
                  "bound %.3f ms (%.2f GB at 3.35 TB/s)"
                  % (kind, tag, total, launched, 1e3 * nbytes / 3.35e12,
                     nbytes / 1e9), flush=True)
            for name, (ms, count) in sorted(kernels.items(),
                                            key=lambda kv: -kv[1][0])[:6]:
                print("DIAG   %-70s %.3f ms, %d a step"
                      % (name[:70], ms, count), flush=True)
        del opt
    return 0


if __name__ == "__main__":
    sys.exit(main())
