#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root. It builds the port's CUDA kernels from
easynlp_tpu_torch/csrc (one nvcc per source, all at once), holds each
against its plain PyTorch version at the main paths' shapes, then drives the
port's three main paths. On a BERT-base model (bert-base-chinese widths,
random truncated-normal weights from --seed): `--mode=predict
--app_name=text_classify` over a 256-row TSV, and `--mode=train` for one
epoch of 8 steps followed by `--mode=evaluate` and `--mode=predict` on the
checkpoint it wrote. On a GPT-2 small model (HF `gpt2` widths and depth,
random weights from --seed, a synthetic 50257-token byte-level BPE vocab):
`--mode=predict --app_name=sequence_generation` over 16 prompts of 600-768
tokens, greedy for 128 new tokens, and one beam-search batch. Each path runs
with the kernels and with --use_flash_attention=false, and the two are
compared. Every phase raises on failure, so any failure exits non-zero. The
last line is {"ok": true, "device": {...}}; the line before it lists the
kernels with their launch counts, errors and times. Imports nothing of JAX.
"""

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

KERNELS = {  # name: (source, the TPU kernel it replaces)
    "short_attention_fwd": ("easynlp_tpu_torch/csrc/short_attention_fwd.cu",
                            "easynlp_tpu/ops/attention.py:519"),
    "short_attention_bwd": ("easynlp_tpu_torch/csrc/short_attention_bwd.cu",
                            "easynlp_tpu/ops/attention.py:531"),
    "flash_attention_fwd": ("easynlp_tpu_torch/csrc/flash_attention_fwd.cu",
                            "easynlp_tpu/ops/attention.py:127"),
}
# the shape each kernel's entry in the kernels line reports (bf16)
KERNEL_LINE_CASE = {"short_attention_fwd": "slice-128",
                    "short_attention_bwd": "slice-128",
                    "flash_attention_fwd": "gpt2-prefill"}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet

# Tolerances. f32: 2e-5, the bound tests/test_attention.py holds the JAX short
# kernel to against its reference. bf16: the kernel computes in f32 from the
# bf16 inputs and rounds only its output to bf16, so against the f32 plain
# version on the same bf16 inputs it is off by at most half a bf16 ulp of |o|
# (|o| < 4 here, so < 2^-7 = 7.8e-3); 1.5e-2 leaves room for f32 sum order.
ATOL_F32 = 2e-5
ATOL_BF16 = 1.5e-2
# Slice: the kernel run and the --use_flash_attention=false run are both
# bf16 end to end and differ only in attention's rounding (the plain path
# rounds max-subtracted scores and the probabilities to bf16, the kernel
# keeps both in f32). Each of 12 layers moves its output by about a bf16 ulp
# (2^-8 relative), LayerNorm keeps activations O(1), and the 0.02-std head
# maps a pooled change of ~1e-2 to a logit change of ~5e-3. Bound 5e-2 on
# logits and probabilities, about 10x that; labels must agree wherever the
# kernel run's logit margin exceeds twice the bound.
SLICE_ATOL = 5e-2
# Backward, kernel against its f32 twin on the same inputs (q, k, v, the
# forward output o, dO; bf16 ones cast to f32 for the twin). f32: 2e-5 +
# 1e-5 |g| (sums in another order; dv grows to ~40 where one key carries a
# whole row). bf16: the kernel computes in f32 and rounds dq/dk/dv once, so
# it is off by at most 2^-8 |g| (bf16 keeps 8 significant bits) plus the
# f32 sum-order error: 1e-4 + 2^-8 |g|.
BWD_ATOL_F32, BWD_RTOL_F32 = 2e-5, 1e-5
BWD_ATOL_BF16, BWD_RTOL_BF16 = 1e-4, 2 ** -8
# Training: the kernel run and the plain run draw the same dropout masks
# (same seed, and attention draws no random numbers), so their per-step
# losses differ only by attention's rounding, compounded over 8 AdamW steps.
# The predict path's largest logit gap, kernel against plain on an H100, is
# 6.7e-3; the loss is a mean over 32 rows. Bound 2e-2.
TRAIN_LOSS_ATOL = 2e-2
# Flash forward against its twin on the same inputs: O as the short kernel
# (f32 2e-5; bf16 1.5e-2, one rounding of O). LSE is f32 in both: 2e-5 +
# 1e-6 |lse| for the sum order (|lse| <= ~20; a fully masked row's -1e30
# must match too); from bf16 inputs the same scores, so 1e-4 + 1e-6 |lse|.
LSE_ATOL_F32, LSE_ATOL_BF16, LSE_RTOL = 2e-5, 1e-4, 1e-6
# Generation: the kernel run and the --use_flash_attention=false run are
# both bf16 end to end and differ only in attention's rounding (the plain
# path rounds max-subtracted scores and probabilities to bf16; the kernels
# keep both in f32), a bf16 ulp (2^-8 relative) per layer, as in BERT; with
# 0.02-std weights GPT-2's logits have std ~0.5, so 12 layers move them by
# ~1e-2. Bound 5e-2 on the prefill logits; greedy tokens must agree at every
# step where the plain run's top-2 margin exceeds twice the bound, until a
# row's first near-tie (after it the two runs continue different texts).
GEN_LOGITS_ATOL = 5e-2

SEQ_LEN = 128
BATCH = 32
N_ROWS = 256
N_DEV_ROWS = 64
N_LAYERS = 12
LEARNING_RATE = 5e-5

GPT2_SMALL = {  # HF gpt2 config.json: GPT-2 small, full width and depth
    "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
    "vocab_size": 50257, "n_positions": 1024, "n_ctx": 1024, "n_embd": 768,
    "n_layer": 12, "n_head": 12, "activation_function": "gelu_new",
    "layer_norm_epsilon": 1e-5, "initializer_range": 0.02,
    "resid_pdrop": 0.1, "embd_pdrop": 0.1, "attn_pdrop": 0.1,
    "bos_token_id": 50256, "eos_token_id": 50256,
}
GPT2_MODEL_DIR = "gpt2-small-random"
GEN_PROMPT_WIDTH = 768          # --sequence_length
GEN_NEW_TOKENS = 128            # max_decoder_length
GEN_BATCH = 8
GEN_ROWS = 16
GEN_BEAMS, GEN_BEAM_NEW_TOKENS = 4, 32
GEN_LETTERS = "etaoinshrdlucmfwypvbgkqjxz"

BERT_BASE_CHINESE = {  # bert-base-chinese config.json widths
    "architectures": ["BertForMaskedLM"], "model_type": "bert",
    "vocab_size": 21128, "hidden_size": 768, "num_hidden_layers": N_LAYERS,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 512, "type_vocab_size": 2,
    "hidden_act": "gelu", "layer_norm_eps": 1e-12,
    "initializer_range": 0.02, "hidden_dropout_prob": 0.1,
    "attention_probs_dropout_prob": 0.1, "pad_token_id": 0,
}
ENGLISH = ["the", "model", "good", "bad", "price", "service", "phone",
           "movie", "great", "not", "very", "and", "is", "it", "was", "ok"]
N_CJK_PIECES = 1000
MODEL_DIR = "bert-base-chinese-random"


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


# --------------------------------------------------------------------------
# phase 0: the device
# --------------------------------------------------------------------------

def phase_device(torch):
    log("== phase 0: device")
    log("nvidia-smi name, power.limit: %s" % card_line())
    log("torch %s, CUDA %s, device 0: %s, count %d" % (
        torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
        torch.cuda.device_count()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")


# --------------------------------------------------------------------------
# phase 1: the build
# --------------------------------------------------------------------------

def phase_build():
    from easynlp_tpu_torch import kernels
    log("== phase 1: build")
    t0 = time.perf_counter()
    kernels.load_all(list(KERNELS))
    seconds = time.perf_counter() - t0
    for name, (source, _) in KERNELS.items():
        info = kernels.build_info(name)
        log("built %s -> %s: nvcc %.3f s, cached=%s"
            % (source, info["path"], info["seconds"], info["cached"]))
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log("ptxas: " + line.strip())
    log("%d kernels built and loaded in %.3f s (nvcc runs in parallel)"
        % (len(KERNELS), seconds))
    return seconds


# --------------------------------------------------------------------------
# phase 2: kernel against plain version
# --------------------------------------------------------------------------

def _inputs(torch, rng, b, sq, skv, h, d, lengths):
    import numpy as np
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(dev) for s in (sq, skv, skv))
    mask = torch.from_numpy(
        (np.arange(skv)[None, :] < np.asarray(lengths)[:, None]).astype(
            np.int32)).to(dev)
    return q, k, v, mask


def _time_ms(torch, fn, iters=50, warmup=5):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_kernel(torch, seed):
    import numpy as np
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 2: kernels against plain versions")
    rng = np.random.RandomState(seed)
    worst_bwd = {}

    def lengths(b, skv, full_row_masked=False):
        out = rng.randint(1, skv + 1, size=b)
        out[0] = skv
        if full_row_masked:
            out[-1] = 0
        return out

    cases = [  # name, B, Sq, Skv, H, D, per-row key lengths, causal
        ("slice-128", 32, 128, 128, 12, 64, lengths(32, 128), False),
        ("slice-512", 8, 512, 512, 12, 64, lengths(8, 512), False),
        ("decode-causal", 4, 1, 24, 12, 64, lengths(4, 24), True),
        ("ragged-40-masked-row", 4, 40, 40, 12, 64, lengths(4, 40, True),
         False),
        ("causal-37x40", 4, 37, 40, 12, 64, lengths(4, 40), True),
    ]
    worst = {}
    for name, b, sq, skv, h, d, lens, causal in cases:
        q, k, v, mask = _inputs(torch, rng, b, sq, skv, h, d, lens)
        for dtype, atol in ((torch.float32, ATOL_F32),
                            (torch.bfloat16, ATOL_BF16)):
            tq, tk, tv = (t.to(dtype) for t in (q, k, v))
            want = A.short_attention_fwd_reference(
                tq.float(), tk.float(), tv.float(), mask, causal)
            for layout in ("bshd", "bhsd"):
                if layout == "bshd":
                    got = A.short_attention_fwd(tq, tk, tv, mask, causal)
                else:
                    hq, hk, hv = (t.transpose(1, 2).contiguous()
                                  for t in (tq, tk, tv))
                    got = A.attention(hq, hk, hv, kv_mask=mask,
                                      causal=causal, impl="short",
                                      layout="bhsd").transpose(1, 2)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != want.shape:
                    raise AssertionError("%s: got %s %s, want %s %s" % (
                        name, got.dtype, tuple(got.shape), dtype,
                        tuple(want.shape)))
                err = (got.float() - want).abs().max().item()
                ok = err <= atol
                log("check %-22s %-8s %-4s max_abs_err %.3e (atol %.1e) %s"
                    % (name, str(dtype).split(".")[1], layout, err, atol,
                       "ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError("kernel disagrees with its plain "
                                         "version: %s %s %s err %.3e"
                                         % (name, dtype, layout, err))
                worst[(name, dtype)] = max(worst.get((name, dtype), 0.0),
                                           err)
        _check_bwd(torch, A, rng, name, q, k, v, mask, causal, worst_bwd)

    timings = {}
    for name, b, sq, skv, h, d, lens, causal in cases[:2]:
        q, k, v, mask = _inputs(torch, rng, b, sq, skv, h, d, lens)
        for dtype in (torch.bfloat16, torch.float32):
            tq, tk, tv = (t.to(dtype) for t in (q, k, v))
            ms = _time_ms(torch, lambda: A.short_attention_fwd(
                tq, tk, tv, mask, causal))
            plain_ms = _time_ms(torch, lambda: A.short_attention_fwd_reference(
                tq, tk, tv, mask, causal))
            ref_ms = _time_ms(torch, lambda: A.attention_reference(
                tq, tk, tv, kv_mask=mask, causal=causal))
            nbytes = (2 * q.numel() + 2 * k.numel()) * tq.element_size() \
                + mask.numel() * 4
            flops = 4 * b * h * sq * skv * d
            log("time %-10s %-8s kernel %.4f ms (%.1f GB/s = %.1f%% of "
                "3.35 TB/s, %.2f TFLOP/s); plain twin %.4f ms; "
                "attention_reference %.4f ms"
                % (name, str(dtype).split(".")[1], ms, nbytes / ms / 1e6,
                   100 * nbytes / (ms * 1e-3) / PEAK_BYTES_PER_S,
                   flops / ms / 1e9, plain_ms, ref_ms))
            timings[("short_attention_fwd", name, dtype)] = (ms, plain_ms)
            timings[("short_attention_bwd", name, dtype)] = _time_bwd(
                torch, A, name, tq, tk, tv, mask, causal, rng)
    worst_flash = _check_flash(torch, A, rng, timings)
    return {"short_attention_fwd": worst,
            "short_attention_bwd": worst_bwd,
            "flash_attention_fwd": worst_flash}, timings


def _ranges_mask(torch, skv, ranges):
    """int32 [B,Skv] key mask, 1 on each row's [start, end) slots."""
    import numpy as np
    idx = np.arange(skv)[None, :]
    starts, ends = (np.asarray(x)[:, None] for x in zip(*ranges))
    return torch.from_numpy(((idx >= starts) & (idx < ends)).astype(
        np.int32)).cuda()


def _flash_flops(b, sq, skv, h, d, causal):
    """4·D FLOPs per (query, visible key) pair: QK^T and PV."""
    if not causal:
        return 4 * b * h * sq * skv * d
    seen = sum(min(skv, max(0, q + skv - sq + 1)) for q in range(sq))
    return 4 * b * h * seen * d


def flash_cases(rng):
    """The flash kernel's shapes: GPT-2 small's prefill (8 x 768, causal,
    left-padded prompts of 600..768 tokens, so the pad rows are fully
    masked) and decode (8 x 1 against 896 cache slots, the last 28 empty),
    S=2048 and S=8192 (causal, padded), causal 37 x 600 (Sq != Skv) and a
    fully masked row. Each: name, B, Sq, Skv, H, D, [(start, end) of each
    row's real keys], causal."""
    prompt = rng.randint(600, 769, size=8)
    prompt[0] = 768
    return [
        ("gpt2-prefill", 8, 768, 768, 12, 64,
         [(768 - n, 768) for n in prompt], True),
        ("gpt2-decode", 8, 1, 896, 12, 64,
         [(768 - n, 768 + 100) for n in prompt], False),
        ("S2048-causal", 1, 2048, 2048, 12, 64, [(0, 1900)], True),
        ("S8192-causal", 1, 8192, 8192, 12, 64, [(0, 8000)], True),
        ("causal-37x600", 4, 37, 600, 12, 64,
         [(0, n) for n in [600] + list(rng.randint(1, 601, size=3))], True),
        ("masked-row-700", 4, 40, 700, 12, 64,
         [(0, n) for n in [700] + list(rng.randint(1, 701, size=2)) + [0]],
         False),
    ]


def _check_flash(torch, A, rng, timings):
    """The flash forward kernel against its f32 twin (O and LSE), f32 and
    bf16, bshd and heads-major memory, at flash_cases(); then its time
    against the twin and bf16 attention_reference at each shape (f32 too at
    the prefill's)."""
    worst = {}
    for name, b, sq, skv, h, d, ranges, causal in flash_cases(rng):
        q, k, v, _ = _inputs(torch, rng, b, sq, skv, h, d, [skv] * b)
        mask = _ranges_mask(torch, skv, ranges)
        for dtype, atol, lse_atol in ((torch.float32, ATOL_F32, LSE_ATOL_F32),
                                      (torch.bfloat16, ATOL_BF16,
                                       LSE_ATOL_BF16)):
            tq, tk, tv = (t.to(dtype) for t in (q, k, v))
            want, want_lse = A.flash_attention_fwd_reference(
                tq.float(), tk.float(), tv.float(), mask, causal)
            for layout in ("bshd", "bhsd"):
                args = (tq, tk, tv)
                if layout == "bhsd":  # heads-major memory, read in place
                    args = tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                                 for t in args)
                got, lse = A.flash_attention_fwd(*args, mask, causal)
                torch.cuda.synchronize()
                if got.dtype != dtype or got.shape != want.shape \
                        or lse.shape != want_lse.shape:
                    raise AssertionError("%s: got %s %s / lse %s" % (
                        name, got.dtype, tuple(got.shape), tuple(lse.shape)))
                err = (got.float() - want).abs().max().item()
                lse_err = (lse - want_lse).abs().max().item()
                lse_excess = ((lse - want_lse).abs() - lse_atol
                              - LSE_RTOL * want_lse.abs()).max().item()
                ok = err <= atol and lse_excess <= 0
                log("check flash %-16s %-8s %-4s max_abs_err %.3e (atol %.1e);"
                    " lse max_abs_err %.3e (bound %.1e + %.0e |lse|) %s"
                    % (name, str(dtype).split(".")[1], layout, err, atol,
                       lse_err, lse_atol, LSE_RTOL, "ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError("flash kernel disagrees with its "
                                         "plain version: %s %s %s err %.3e, "
                                         "lse err %.3e"
                                         % (name, dtype, layout, err,
                                            lse_err))
                worst[(name, dtype)] = max(worst.get((name, dtype), 0.0),
                                           err)
            del want, want_lse
        dtypes = ((torch.bfloat16, torch.float32) if name == "gpt2-prefill"
                  else (torch.bfloat16,))
        iters = 10 if skv >= 2048 else 50
        for dtype in dtypes:
            tq, tk, tv = (t.to(dtype) for t in (q, k, v))
            ms = _time_ms(torch, lambda: A.flash_attention_fwd(
                tq, tk, tv, mask, causal), iters=iters)
            plain_ms = _time_ms(torch, lambda: A.flash_attention_fwd_reference(
                tq, tk, tv, mask, causal), iters=iters)
            ref_ms = _time_ms(torch, lambda: A.attention_reference(
                tq, tk, tv, kv_mask=mask, causal=causal), iters=iters)
            nbytes = (2 * q.numel() + 2 * k.numel()) * tq.element_size() \
                + mask.numel() * 4 + b * h * sq * 4
            flops = _flash_flops(b, sq, skv, h, d, causal)
            log("time flash %-16s %-8s kernel %.4f ms (%.1f GB/s = %.2f%% of "
                "3.35 TB/s, %.2f TFLOP/s on the visible keys); plain twin "
                "%.4f ms; attention_reference %.4f ms"
                % (name, str(dtype).split(".")[1], ms, nbytes / ms / 1e6,
                   100 * nbytes / (ms * 1e-3) / PEAK_BYTES_PER_S,
                   flops / ms / 1e9, plain_ms, ref_ms))
            timings[("flash_attention_fwd", name, dtype)] = (ms, plain_ms)
        del q, k, v, tq, tk, tv
        torch.cuda.empty_cache()
    return worst


def _check_bwd(torch, A, rng, name, q, k, v, mask, causal, worst):
    """The backward kernel against its f32 twin, f32 and bf16, in both
    layouts; two runs on the same inputs must give the same bits."""
    import numpy as np
    do = torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(
        np.float32)).to(q.device)
    for dtype, atol, rtol in ((torch.float32, BWD_ATOL_F32, BWD_RTOL_F32),
                              (torch.bfloat16, BWD_ATOL_BF16,
                               BWD_RTOL_BF16)):
        tq, tk, tv, tdo = (t.to(dtype) for t in (q, k, v, do))
        for layout in ("bshd", "bhsd"):
            args = (tq, tk, tv)
            o = A.short_attention_fwd(*args, mask, causal)
            g_in = tdo
            if layout == "bhsd":  # heads-major memory, read through strides
                args = tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                             for t in args)
                o = o.transpose(1, 2).contiguous().transpose(1, 2)
                g_in = tdo.transpose(1, 2).contiguous().transpose(1, 2)
            want = A.short_attention_bwd_reference(
                tq.float(), tk.float(), tv.float(), mask, o.float(),
                tdo.float(), causal)
            got = A.short_attention_bwd(*args, mask, o, g_in, causal)
            torch.cuda.synchronize()
            err, excess = 0.0, 0.0
            for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
                if g.dtype != dtype or g.shape != w.shape:
                    raise AssertionError("%s %s: got %s %s, want %s %s" % (
                        name, gname, g.dtype, tuple(g.shape), dtype,
                        tuple(w.shape)))
                diff = (g.float() - w).abs()
                err = max(err, diff.max().item())
                excess = max(excess, (diff - atol - rtol * w.abs()).max()
                             .item())
            ok = excess <= 0
            log("check bwd %-18s %-8s %-4s max_abs_err %.3e (bound %.1e + "
                "%.1e |g|) %s" % (name, str(dtype).split(".")[1], layout,
                                  err, atol, rtol, "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("backward kernel disagrees with its "
                                     "plain version: %s %s %s err %.3e"
                                     % (name, dtype, layout, err))
            again = A.short_attention_bwd(*args, mask, o, g_in, causal)
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError("%s %s %s: two backward runs differ"
                                     % (name, dtype, layout))
            worst[(name, dtype)] = max(worst.get((name, dtype), 0.0), err)
    log("check bwd %-18s two runs on the same inputs give the same bits"
        % name)


def _time_bwd(torch, A, name, tq, tk, tv, mask, causal, rng):
    """Backward kernel, its twin, and autograd through attention_reference
    (backward only, from a graph kept alive); CUDA events."""
    import numpy as np
    b, sq, h, d = tq.shape
    skv = tk.shape[1]
    do = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(
        np.float32)).to(tq.device).to(tq.dtype)
    o = A.short_attention_fwd(tq, tk, tv, mask, causal)
    ms = _time_ms(torch, lambda: A.short_attention_bwd(
        tq, tk, tv, mask, o, do, causal))
    plain_ms = _time_ms(torch, lambda: A.short_attention_bwd_reference(
        tq, tk, tv, mask, o, do, causal))
    leaves = [t.detach().clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = A.attention_reference(*leaves, kv_mask=mask, causal=causal)
    ref_ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True))
    nbytes = 8 * tq.numel() * tq.element_size() + mask.numel() * 4
    flops = 10 * b * h * sq * skv * d
    log("time bwd %-10s %-8s kernel %.4f ms (%.1f GB/s = %.1f%% of "
        "3.35 TB/s, %.2f TFLOP/s); plain twin %.4f ms; autograd through "
        "attention_reference %.4f ms"
        % (name, str(tq.dtype).split(".")[1], ms, nbytes / ms / 1e6,
           100 * nbytes / (ms * 1e-3) / PEAK_BYTES_PER_S, flops / ms / 1e9,
           plain_ms, ref_ms))
    return ms, plain_ms


# --------------------------------------------------------------------------
# phase 3: the slice
# --------------------------------------------------------------------------

def _vocab():
    tokens = ["[PAD]"] + ["[unused%d]" % i for i in range(1, 100)]
    tokens += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += [chr(c) for c in range(33, 127)]
    tokens += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    tokens += ENGLISH
    n_cjk = BERT_BASE_CHINESE["vocab_size"] - len(tokens) - N_CJK_PIECES
    cjk = [chr(0x4E00 + i) for i in range(n_cjk)]
    tokens += cjk + ["##" + c for c in cjk[:N_CJK_PIECES]]
    assert len(tokens) == BERT_BASE_CHINESE["vocab_size"]
    return tokens, cjk


def _truncated_normal(rng, shape, std):
    import numpy as np
    x = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(x) > 2
    return x * np.float32(std)


def make_model_dir(torch, path, seed):
    """bert-base-chinese widths, synthetic vocab, truncated-normal(0.02)
    weights from numpy under HF names (bert. prefix), 2-way classifier."""
    import numpy as np
    os.makedirs(path, exist_ok=True)
    c = BERT_BASE_CHINESE
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f, indent=2)
    tokens, cjk = _vocab()
    with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    with open(os.path.join(path, "label_mapping.json"), "w") as f:
        json.dump({"negative": 0, "positive": 1}, f)
    rng = np.random.default_rng(seed)
    e, inter = c["hidden_size"], c["intermediate_size"]
    std = c["initializer_range"]
    state = {}

    def dense(name, n_out, n_in):
        state[name + ".weight"] = _truncated_normal(rng, (n_out, n_in), std)
        state[name + ".bias"] = np.zeros(n_out, np.float32)

    def norm(name):
        state[name + ".weight"] = np.ones(e, np.float32)
        state[name + ".bias"] = np.zeros(e, np.float32)

    for name, rows in (("word", c["vocab_size"]),
                       ("position", c["max_position_embeddings"]),
                       ("token_type", c["type_vocab_size"])):
        state["bert.embeddings.%s_embeddings.weight" % name] = \
            _truncated_normal(rng, (rows, e), std)
    norm("bert.embeddings.LayerNorm")
    for i in range(c["num_hidden_layers"]):
        base = "bert.encoder.layer.%d." % i
        for proj in ("query", "key", "value"):
            dense(base + "attention.self." + proj, e, e)
        dense(base + "attention.output.dense", e, e)
        norm(base + "attention.output.LayerNorm")
        dense(base + "intermediate.dense", inter, e)
        dense(base + "output.dense", e, inter)
        norm(base + "output.LayerNorm")
    dense("bert.pooler.dense", e, e)
    dense("classifier", 2, e)
    torch.save({k: torch.from_numpy(v) for k, v in state.items()},
               os.path.join(path, "pytorch_model.bin"))
    return cjk


def make_tsv(path, cjk, seed, n_rows=N_ROWS):
    """n_rows generated sentences: common CJK characters with English words,
    digits and punctuation mixed in, 8..200 characters (longer ones are
    truncated to SEQ_LEN tokens, shorter ones padded)."""
    rng = random.Random(seed)
    common = cjk[:3000]
    with open(path, "w", encoding="utf-8") as f:
        for i in range(n_rows):
            parts = []
            for _ in range(rng.randint(8, 200)):
                r = rng.random()
                if r < 0.85:
                    parts.append(rng.choice(common))
                elif r < 0.93:
                    parts.append(" %s " % rng.choice(ENGLISH))
                elif r < 0.97:
                    parts.append(str(rng.randint(0, 999)))
                else:
                    parts.append(rng.choice("，。！？,.!?"))
            f.write("%d\t%s\t%s\n" % (i, "".join(parts).strip(),
                                      rng.choice(["negative", "positive"])))


def run_predict(torch, model_dir, tsv, out, use_kernel):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    argv = ["--mode=predict", "--app_name=text_classify", "--device=cuda",
            "--dtype=bfloat16", "--sequence_length=%d" % SEQ_LEN,
            "--micro_batch_size=%d" % BATCH, "--tables=" + tsv,
            "--outputs=" + out, "--checkpoint_dir=" + model_dir,
            "--input_schema=id:str:1,sentence:str:1,label:str:1",
            "--first_sequence=sentence",
            "--output_schema=predictions,probabilities,logits",
            "--append_cols=id",
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    manager = default_main_fn(initialize_easynlp(args_list=argv))
    total = time.perf_counter() - t0
    batches = manager.predictor.model_predictor.batch_seconds
    return {"rows": manager.n_rows, "run_s": manager.seconds,
            "with_load_s": total, "batch_s": list(batches),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def read_output(path):
    import numpy as np
    labels, probs, logits, ids = [], [], [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) != 4:
                raise AssertionError("output row has %d columns, want 4 "
                                     "(predictions, probabilities, logits, "
                                     "id): %r" % (len(cols), line))
            labels.append(cols[0])
            probs.append([float(x) for x in cols[1].split()])
            logits.append([float(x) for x in cols[2].split()])
            ids.append(cols[3])
    return labels, np.array(probs), np.array(logits), ids


def check_output(path, n_rows=N_ROWS):
    import numpy as np
    labels, probs, logits, ids = read_output(path)
    if len(labels) != n_rows or ids != [str(i) for i in range(n_rows)]:
        raise AssertionError("%s: %d rows, want ids 0..%d in order"
                             % (path, len(labels), n_rows - 1))
    if probs.shape != (n_rows, 2) or logits.shape != (n_rows, 2):
        raise AssertionError("probabilities %s / logits %s, want (%d, 2)"
                             % (probs.shape, logits.shape, n_rows))
    if not (np.isfinite(probs).all() and np.isfinite(logits).all()):
        raise AssertionError("non-finite probabilities or logits")
    sums = np.abs(probs.sum(axis=1) - 1.0).max()
    if sums > 1e-3:
        raise AssertionError("probabilities sum to 1 within %.2e, want 1e-3"
                             % sums)
    if set(labels) - {"negative", "positive"}:
        raise AssertionError("unknown labels %s" % (set(labels)
                                                     - {"negative",
                                                        "positive"}))
    return labels, probs, logits


def describe(tag, r):
    ms = [1e3 * s for s in r["batch_s"]]
    log("run %-7s %d rows in %.4f s = %.2f rows/s (predict loop: read, "
        "tokenise, %d batches, write; %.4f s with model load); batch "
        "latency median %.3f ms, first %.3f ms, min %.3f ms, max %.3f ms "
        "(H2D + forward + D2H, host clock); model share of the loop %.1f%%; "
        "peak device memory %.3f GiB"
        % (tag, r["rows"], r["run_s"], r["rows"] / r["run_s"], len(ms),
           r["with_load_s"], statistics.median(ms), ms[0], min(ms), max(ms),
           100 * sum(r["batch_s"]) / r["run_s"], r["peak_gib"]))


def phase_slice(torch, seed, workdir):
    import numpy as np
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 3: the slice (text_classify predict, BERT-base)")
    model_dir = os.path.join(workdir, MODEL_DIR)
    t0 = time.perf_counter()
    cjk = make_model_dir(torch, model_dir, seed)
    tsv = os.path.join(workdir, "predict.tsv")
    make_tsv(tsv, cjk, seed)
    log("model dir and %d-row TSV made from seed %d in %.3f s"
        % (N_ROWS, seed, time.perf_counter() - t0))

    out_k = os.path.join(workdir, "pred_kernel.tsv")
    out_p = os.path.join(workdir, "pred_plain.tsv")
    A.short_attention_fwd.launches = 0
    runs = {"kernel": [run_predict(torch, model_dir, tsv, out_k, True)]}
    launches = A.short_attention_fwd.launches
    want = N_LAYERS * (N_ROWS // BATCH)
    log("kernel launches in the main path's run: %d (want %d = %d layers x "
        "%d batches)" % (launches, want, N_LAYERS, N_ROWS // BATCH))
    if launches != want:
        raise AssertionError("the main path launched the kernel %d times, "
                             "want %d" % (launches, want))
    runs["plain"] = []
    # the rest in turns on the same card: K P P K K P P K, the first K above
    for use_kernel in (False, False, True, True, False, False, True):
        before = A.short_attention_fwd.launches
        r = run_predict(torch, model_dir, tsv, out_k if use_kernel else out_p,
                        use_kernel)
        runs["kernel" if use_kernel else "plain"].append(r)
        if not use_kernel and A.short_attention_fwd.launches != before:
            raise AssertionError("--use_flash_attention=false still launched "
                                 "the kernel")
    for tag in ("kernel", "plain"):
        for i, r in enumerate(runs[tag]):
            describe("%s#%d" % (tag, i + 1), r)
        rates = [r["rows"] / r["run_s"] for r in runs[tag]]
        lat = [1e3 * statistics.median(r["batch_s"]) for r in runs[tag]]
        log("runs %-6s median of %d runs: %.2f rows/s (min %.2f, max %.2f); "
            "batch latency median %.3f ms (min %.3f, max %.3f)"
            % (tag, len(rates), statistics.median(rates), min(rates),
               max(rates), statistics.median(lat), min(lat), max(lat)))

    labels_k, probs_k, logits_k = check_output(out_k)
    labels_p, probs_p, logits_p = check_output(out_p)
    d_logits = np.abs(logits_k - logits_p).max()
    d_probs = np.abs(probs_k - probs_p).max()
    margin = np.abs(logits_k[:, 0] - logits_k[:, 1])
    decided = margin > 2 * SLICE_ATOL
    flips = [i for i in np.nonzero(decided)[0] if labels_k[i] != labels_p[i]]
    log("kernel vs plain run: max |d logits| %.3e, max |d probabilities| "
        "%.3e (bound %.1e); labels agree on %d of %d rows with margin > %.1e "
        "(%d of all %d rows agree)"
        % (d_logits, d_probs, SLICE_ATOL, int(decided.sum()) - len(flips),
           int(decided.sum()), 2 * SLICE_ATOL,
           sum(a == b for a, b in zip(labels_k, labels_p)), N_ROWS))
    if d_logits > SLICE_ATOL or d_probs > SLICE_ATOL or flips:
        raise AssertionError("kernel and plain runs disagree: logits %.3e, "
                             "probabilities %.3e, label flips at rows %s"
                             % (d_logits, d_probs, flips))
    return launches, cjk


# --------------------------------------------------------------------------
# phase 4: the training slice
# --------------------------------------------------------------------------

def _common_argv(use_kernel):
    return ["--app_name=text_classify", "--device=cuda", "--dtype=bfloat16",
            "--sequence_length=%d" % SEQ_LEN,
            "--micro_batch_size=%d" % BATCH,
            "--input_schema=id:str:1,sentence:str:1,label:str:1",
            "--first_sequence=sentence", "--label_name=label",
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false")]


def run_train(torch, model_dir, train_tsv, dev_tsv, ckpt, use_kernel, seed,
              profile_dir=None):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    argv = ["--mode=train", "--tables=%s,%s" % (train_tsv, dev_tsv)
            if dev_tsv else "--tables=" + train_tsv,
            "--pretrained_model_name_or_path=" + model_dir,
            "--epoch_num=1", "--learning_rate=%g" % LEARNING_RATE,
            "--optimizer_type=AdamW", "--logging_steps=1",
            "--random_seed=%d" % seed] + _common_argv(use_kernel)
    if ckpt:
        argv.append("--checkpoint_dir=" + ckpt)
    if profile_dir:
        argv += ["--profile_dir=" + profile_dir, "--profile_steps=4"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = default_main_fn(initialize_easynlp(args_list=argv))
    torch.cuda.synchronize()
    # a summary only: dropping the trainer frees its model and optimizer
    # state before the next run, whose peak memory is then its own
    return {"records": trainer.step_records,
            "save_s": trainer.save_seconds,
            "skips": trainer.nonfinite_skips,
            "total_s": time.perf_counter() - t0,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}


def describe_train(tag, run):
    ms = [1e3 * r["seconds"] for r in run["records"]]
    log("train %-7s %d steps x %d samples: step ms median %.3f, first %.3f, "
        "min %.3f, max %.3f (host clock, each step ends in the guard's "
        "read-back); %.2f samples/s at the median step; run with load, eval "
        "and checkpoint %.3f s; checkpoint write %s s; peak device memory "
        "%.3f GiB above the run's start; losses %s"
        % (tag, len(ms), BATCH, statistics.median(ms), ms[0], min(ms),
           max(ms), 1e3 * BATCH / statistics.median(ms), run["total_s"],
           ", ".join("%.3f" % x for x in run["save_s"]), run["peak_gib"],
           " ".join("%.4f" % r["loss"] for r in run["records"])))


def device_share(trace_path, top=8):
    """(device busy share, device busy ms, [(kernel, ms), ...]) from a
    torch.profiler Chrome trace: the union of the device kernels' intervals
    over the span from the first kernel's start to the last one's end (so
    the profiler's own start-up is not counted as idle)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                     if e.get("cat") == "kernel")
    if not kernels:
        return None, None, []
    busy, end = 0.0, -1.0
    for a, b, _ in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(b for _, b, _ in kernels) - kernels[0][0]
    by_name = {}
    for a, b, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    return busy / span, busy / 1e3, sorted(by_name.items(),
                                           key=lambda kv: -kv[1])[:top]


def phase_train(torch, seed, workdir, cjk):
    import numpy as np
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 4: the training slice (text_classify train, evaluate, "
        "predict; BERT-base)")
    model_dir = os.path.join(workdir, MODEL_DIR)
    train_tsv = os.path.join(workdir, "train.tsv")
    dev_tsv = os.path.join(workdir, "dev.tsv")
    make_tsv(train_tsv, cjk, seed + 1)
    make_tsv(dev_tsv, cjk, seed + 2, n_rows=N_DEV_ROWS)
    steps = N_ROWS // BATCH
    eval_batches = -(-N_DEV_ROWS // BATCH)
    ckpt_k = os.path.join(workdir, "ckpt_kernel")
    ckpt_p = os.path.join(workdir, "ckpt_plain")

    A.short_attention_fwd.launches = 0
    A.short_attention_bwd.launches = 0
    kernel_run = run_train(torch, model_dir, train_tsv, dev_tsv, ckpt_k,
                           True, seed)
    fwd, bwd = A.short_attention_fwd.launches, A.short_attention_bwd.launches
    want_fwd = N_LAYERS * (steps + eval_batches)
    log("train path launches: short_attention_bwd %d (want %d = %d layers x "
        "%d steps), short_attention_fwd %d (want %d = %d layers x (%d steps "
        "+ %d eval batches))" % (bwd, N_LAYERS * steps, N_LAYERS, steps, fwd,
                                 want_fwd, N_LAYERS, steps, eval_batches))
    if bwd != N_LAYERS * steps or fwd != want_fwd:
        raise AssertionError("the training path launched fwd %d / bwd %d "
                             "times, want %d / %d"
                             % (fwd, bwd, want_fwd, N_LAYERS * steps))
    runs = {"kernel": [kernel_run], "plain": []}
    # the rest in turns on the same card: K P P K, the first K above
    for use_kernel in (False, False, True):
        before = (A.short_attention_fwd.launches,
                  A.short_attention_bwd.launches)
        run = run_train(torch, model_dir, train_tsv, dev_tsv,
                        ckpt_k if use_kernel else ckpt_p, use_kernel, seed)
        runs["kernel" if use_kernel else "plain"].append(run)
        if not use_kernel and (A.short_attention_fwd.launches,
                               A.short_attention_bwd.launches) != before:
            raise AssertionError("--use_flash_attention=false still "
                                 "launched a kernel")
    for tag in ("kernel", "plain"):
        for i, run in enumerate(runs[tag]):
            describe_train("%s#%d" % (tag, i + 1), run)
            recs = run["records"]
            if len(recs) != steps or run["skips"]:
                raise AssertionError("%s run: %d steps, %d non-finite skips"
                                     % (tag, len(recs), run["skips"]))
            if not all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                       for r in recs):
                raise AssertionError("%s run: non-finite loss or grad norm"
                                     % tag)
    rec_k, rec_p = kernel_run["records"], runs["plain"][0]["records"]
    d_loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(rec_k, rec_p))
    d_gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                  for a, b in zip(rec_k, rec_p))
    log("kernel vs plain training run: max |d loss| per step %.3e (bound "
        "%.1e); max relative grad-norm gap %.3e; lr %s"
        % (d_loss, TRAIN_LOSS_ATOL, d_gnorm,
           " ".join("%.3g" % r["lr"] for r in rec_k)))
    if d_loss > TRAIN_LOSS_ATOL:
        raise AssertionError("kernel and plain training runs disagree: "
                             "loss gap %.3e" % d_loss)
    medians = {tag: [statistics.median(r["seconds"] for r in run["records"])
                     for run in runs[tag]] for tag in runs}
    for tag, values in medians.items():
        log("train %-6s step ms, median per run: %s; median of runs %.3f "
            "(%.2f samples/s)" % (tag, " ".join("%.3f" % (1e3 * v)
                                                for v in values),
                                  1e3 * statistics.median(values),
                                  BATCH / statistics.median(values)))
    ms_k = statistics.median(medians["kernel"])
    ms_p = statistics.median(medians["plain"])

    # evaluate and predict on the checkpoint the kernel run wrote
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    results = default_main_fn(initialize_easynlp(args_list=[
        "--mode=evaluate", "--tables=" + dev_tsv,
        "--checkpoint_dir=" + ckpt_k] + _common_argv(True)))
    names = [m for m, _ in results]
    if names[:2] != ["accuracy", "f1"] or not np.isfinite(
            [x for _, x in results]).all():
        raise AssertionError("evaluate on the trained checkpoint: %s"
                             % results)
    final = [r for r in map(json.loads, open(os.path.join(
        ckpt_k, "events.jsonl"))) if r["kind"] == "eval"][-1]
    if abs(final["accuracy"] - dict(results)["accuracy"]) > 1e-9:
        raise AssertionError("evaluate disagrees with the trainer's final "
                             "evaluation: %s vs %s" % (results, final))
    log("evaluate on the kernel run's checkpoint: %s"
        % ", ".join("%s %.6f" % kv for kv in results))
    out = os.path.join(workdir, "pred_trained.tsv")
    default_main_fn(initialize_easynlp(args_list=[
        "--mode=predict", "--tables=" + dev_tsv, "--outputs=" + out,
        "--checkpoint_dir=" + ckpt_k,
        "--output_schema=predictions,probabilities,logits",
        "--append_cols=id"] + _common_argv(True)))
    labels, _, _ = check_output(out, N_DEV_ROWS)
    log("predict on the trained checkpoint: %d rows, labels %s"
        % (len(labels), {x: labels.count(x) for x in sorted(set(labels))}))

    # one more kernel run under torch.profiler (steps 3-6), for the device's
    # share of the step; its step times are not reported
    prof = os.path.join(workdir, "profile")
    run_train(torch, model_dir, train_tsv, None, None, True, seed,
              profile_dir=prof)
    share, busy_ms, top = device_share(os.path.join(prof, "trace.json"))
    if share is None:
        log("profile: the trace holds no device kernels (not measured)")
    else:
        log("profile, kernel run, steps 3-6 (under the profiler): device "
            "busy %.1f%% of the span of its kernels, %.3f ms busy per step; "
            "device ms by kernel over the 4 steps: %s"
            % (100 * share, busy_ms / 4, "; ".join(
                "%s %.3f" % (n[:60], t) for n, t in top)))
    return bwd, ms_k, ms_p


# --------------------------------------------------------------------------
# phase 5: GPT-2 generation
# --------------------------------------------------------------------------

def gpt2_vocab():
    """(tokens in id order, merges) of a synthetic 50257-entry byte-level
    BPE vocabulary: GPT-2's 256 byte symbols, then 50000 merged tokens grown
    from lowercase letters ("Ġ" marks a leading space), one letter per merge
    level, then <|endoftext|> at id 50256 as in GPT-2. Id 0 is "!"."""
    from easynlp_tpu_torch.modelzoo.models.gpt2.tokenization_gpt2 import (
        bytes_to_unicode)
    tokens = list(bytes_to_unicode().values())
    known = set(tokens)
    n_merges = GPT2_SMALL["vocab_size"] - 1 - len(tokens)
    merges, level = [], ["Ġ"] + list(GEN_LETTERS)
    while len(merges) < n_merges:
        grown = []
        for piece in level:
            for c in GEN_LETTERS:
                if len(merges) == n_merges:
                    break
                if piece + c not in known:
                    merges.append((piece, c))
                    known.add(piece + c)
                    tokens.append(piece + c)
                    grown.append(piece + c)
        level = grown
    tokens.append("<|endoftext|>")
    assert len(tokens) == GPT2_SMALL["vocab_size"]
    return tokens, merges


def make_gpt2_model_dir(torch, path, seed):
    """GPT-2 small widths and depth, the synthetic vocabulary, and
    truncated-normal(0.02) weights from numpy under HF names (transformer.
    prefix, Conv1D [in, out], the tied lm_head.weight), zero biases, unit
    LayerNorms."""
    import numpy as np
    os.makedirs(path, exist_ok=True)
    c = GPT2_SMALL
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f, indent=2)
    tokens, merges = gpt2_vocab()
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join("%s %s\n" % m for m in merges))
    rng = np.random.default_rng(seed)
    e, std = c["n_embd"], c["initializer_range"]
    state = {}

    def put(name, *shape, fill=None):
        arr = (np.full(shape, fill, np.float32) if fill is not None
               else _truncated_normal(rng, shape, std))
        state["transformer." + name] = torch.from_numpy(arr)

    put("wte.weight", c["vocab_size"], e)
    put("wpe.weight", c["n_positions"], e)
    for i in range(c["n_layer"]):
        for ln in ("ln_1", "ln_2"):
            put("h.%d.%s.weight" % (i, ln), e, fill=1.0)
            put("h.%d.%s.bias" % (i, ln), e, fill=0.0)
        for name, n_in, n_out in (("attn.c_attn", e, 3 * e),
                                  ("attn.c_proj", e, e),
                                  ("mlp.c_fc", e, 4 * e),
                                  ("mlp.c_proj", 4 * e, e)):
            put("h.%d.%s.weight" % (i, name), n_in, n_out)
            put("h.%d.%s.bias" % (i, name), n_out, fill=0.0)
    put("ln_f.weight", e, fill=1.0)
    put("ln_f.bias", e, fill=0.0)
    state["lm_head.weight"] = state["transformer.wte.weight"]
    torch.save(state, os.path.join(path, "pytorch_model.bin"))


def make_gen_tsv(path, tokenizer, seed, n_rows=GEN_ROWS):
    """n_rows texts of random lowercase words, each grown until it is at
    least a drawn 600..768 tokens long (the first row 768); the predictor
    truncates at GEN_PROMPT_WIDTH. Returns the drawn lengths."""
    rng = random.Random(seed)
    targets = [GEN_PROMPT_WIDTH] + [rng.randint(600, GEN_PROMPT_WIDTH)
                                    for _ in range(n_rows - 1)]
    with open(path, "w", encoding="utf-8") as f:
        for i, target in enumerate(targets):
            words, n = [], 0
            while n < target:
                word = "".join(rng.choice(GEN_LETTERS)
                               for _ in range(rng.randint(2, 9)))
                n += len(tokenizer.tokenize((" " if words else "") + word))
                words.append(word)
            f.write("%d\t%s\n" % (i, " ".join(words)))
    return targets


def run_generate(torch, model_dir, tsv, out, use_kernel, udp):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    argv = ["--mode=predict", "--app_name=sequence_generation",
            "--device=cuda", "--dtype=bfloat16",
            "--sequence_length=%d" % GEN_PROMPT_WIDTH,
            "--micro_batch_size=%d" % GEN_BATCH, "--tables=" + tsv,
            "--outputs=" + out, "--checkpoint_dir=" + model_dir,
            "--input_schema=id:str:1,text:str:1", "--first_sequence=text",
            "--output_schema=generated_ids", "--append_cols=id",
            "--user_defined_parameters=" + udp,
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false")]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    manager = default_main_fn(initialize_easynlp(args_list=argv))
    total = time.perf_counter() - t0
    import numpy as np
    ids, rows = [], []
    with open(out, encoding="utf-8") as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            ids.append([int(x) for x in cols[0].split()])
            rows.append(cols[1])
    return {"rows": manager.n_rows, "run_s": manager.seconds,
            "with_load_s": total,
            "batch_s": list(manager.predictor.batch_seconds),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "ids": np.array(ids), "row_ids": rows}


def generated_lengths(ids, width, eos):
    """Per row: the generated tokens up to and including the first EOS."""
    out = []
    for row in ids:
        gen = list(row[width:])
        out.append(gen.index(eos) + 1 if eos in gen else len(gen))
    return out


def expected_flash_launches(ids, width, n_layer, eos, batch):
    """Flash launches of a greedy run whose prompts and caches are past 512
    keys: every layer of the prefill and of each decode step. A batch
    decodes after each generated position but its last, which is the first
    position where every row has emitted EOS, or the buffer's end."""
    lens = generated_lengths(ids, width, eos)
    calls = 0
    for start in range(0, len(lens), batch):
        calls += max(lens[start:start + batch])  # 1 prefill + (last - 1)
    return n_layer * calls


def check_generation(ids, n_rows, width, new_tokens, vocab, prompt_ids):
    if ids.shape != (n_rows, width + new_tokens):
        raise AssertionError("generated_ids %s, want (%d, %d)"
                             % (ids.shape, n_rows, width + new_tokens))
    if ids.min() < 0 or ids.max() >= vocab:
        raise AssertionError("token ids outside [0, %d)" % vocab)
    if not (ids[:, :width] == prompt_ids).all():
        raise AssertionError("the prompt part of generated_ids is not the "
                             "left-padded prompt")


def describe_gen(tag, r, lens):
    ms = [1e3 * s for s in r["batch_s"]]
    n = sum(lens)
    log("gen %-7s %d rows, %d generated tokens in %.4f s = %.2f tokens/s "
        "(predict loop: read, tokenise, %d batches, write; %.4f s with model "
        "load %.4f s); batch latency median %.3f ms, min %.3f, max %.3f "
        "(host clock, tokens back on the host); peak device memory %.3f GiB"
        % (tag, r["rows"], n, r["run_s"], n / r["run_s"], len(ms),
           r["with_load_s"], r["with_load_s"] - r["run_s"],
           statistics.median(ms), min(ms), max(ms), r["peak_gib"]))


def _step_times(torch, prefill, decode, ids, mask, n_decode, runs=3):
    """(prefill ms samples, decode ms samples): host clock around each call,
    each ending in torch.cuda.synchronize()."""
    pre, dec = [], []
    with torch.inference_mode():
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(ids, mask)
            torch.cuda.synchronize()
            pre.append(1e3 * (time.perf_counter() - t0))
            token = logits.argmax(-1, keepdim=True)
            for _ in range(n_decode):
                t0 = time.perf_counter()
                logits, cache = decode(token, cache)
                torch.cuda.synchronize()
                dec.append(1e3 * (time.perf_counter() - t0))
                token = logits.argmax(-1, keepdim=True)
    return pre, dec


def phase_generation(torch, seed, workdir):
    import numpy as np
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
    from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns)
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 5: GPT-2 generation (sequence_generation predict, GPT-2 "
        "small)")
    model_dir = os.path.join(workdir, GPT2_MODEL_DIR)
    t0 = time.perf_counter()
    make_gpt2_model_dir(torch, model_dir, seed)
    tokenizer = GPT2Tokenizer.from_pretrained(model_dir)
    tsv = os.path.join(workdir, "prompts.tsv")
    make_gen_tsv(tsv, tokenizer, seed)
    with open(tsv, encoding="utf-8") as f:
        texts = [line.split("\t", 1)[1].rstrip("\n") for line in f]
    enc = tokenizer(texts, max_length=GEN_PROMPT_WIDTH)
    n_real = enc["attention_mask"].sum(axis=1)
    prompt_ids = np.zeros((GEN_ROWS, GEN_PROMPT_WIDTH), np.int64)
    for i, n in enumerate(n_real):
        prompt_ids[i, GEN_PROMPT_WIDTH - n:] = enc["input_ids"][i, :n]
    log("GPT-2 small model dir (%d-token vocab, %d merges) and %d prompts of "
        "%d..%d tokens (mean %.1f) made from seed %d in %.3f s"
        % (GPT2_SMALL["vocab_size"], GPT2_SMALL["vocab_size"] - 257,
           GEN_ROWS, n_real.min(), n_real.max(), n_real.mean(), seed,
           time.perf_counter() - t0))
    if n_real.min() < 600 or n_real.max() != GEN_PROMPT_WIDTH:
        raise AssertionError("prompt lengths %s, want 600..%d"
                             % (n_real.tolist(), GEN_PROMPT_WIDTH))
    eos, n_layer = GPT2_SMALL["eos_token_id"], GPT2_SMALL["n_layer"]
    udp = "max_decoder_length=%d" % GEN_NEW_TOKENS

    out_k = os.path.join(workdir, "gen_kernel.tsv")
    out_p = os.path.join(workdir, "gen_plain.tsv")
    A.flash_attention_fwd.launches = 0
    A.short_attention_fwd.launches = 0
    runs = {"kernel": [run_generate(torch, model_dir, tsv, out_k, True,
                                    udp)]}
    launches = A.flash_attention_fwd.launches
    first = runs["kernel"][0]
    want = expected_flash_launches(first["ids"], GEN_PROMPT_WIDTH, n_layer,
                                   eos, GEN_BATCH)
    log("flash_attention_fwd launches in the main path's run: %d (want %d = "
        "%d layers x (prefill + decode steps) over %d batches); "
        "short_attention_fwd %d" % (launches, want, n_layer,
                                    GEN_ROWS // GEN_BATCH,
                                    A.short_attention_fwd.launches))
    if launches != want or launches == 0:
        raise AssertionError("the generation path launched the flash kernel "
                             "%d times, want %d" % (launches, want))
    runs["plain"] = []
    # the rest in turns on the same card: K P P K, the first K above
    for use_kernel in (False, False, True):
        before = A.flash_attention_fwd.launches
        r = run_generate(torch, model_dir, tsv, out_k if use_kernel
                         else out_p, use_kernel, udp)
        runs["kernel" if use_kernel else "plain"].append(r)
        if not use_kernel and A.flash_attention_fwd.launches != before:
            raise AssertionError("--use_flash_attention=false still launched "
                                 "the flash kernel")
    for tag in ("kernel", "plain"):
        for i, r in enumerate(runs[tag]):
            check_generation(r["ids"], GEN_ROWS, GEN_PROMPT_WIDTH,
                             GEN_NEW_TOKENS, GPT2_SMALL["vocab_size"],
                             prompt_ids)
            if r["row_ids"] != [str(i) for i in range(GEN_ROWS)]:
                raise AssertionError("rows out of order: %s" % r["row_ids"])
            describe_gen("%s#%d" % (tag, i + 1), r, generated_lengths(
                r["ids"], GEN_PROMPT_WIDTH, eos))
        rates = [sum(generated_lengths(r["ids"], GEN_PROMPT_WIDTH, eos))
                 / r["run_s"] for r in runs[tag]]
        log("gen %-6s median of %d runs: %.2f generated tokens/s (min %.2f, "
            "max %.2f)" % (tag, len(rates), statistics.median(rates),
                           min(rates), max(rates)))
    for tag in ("kernel", "plain"):
        if any(not np.array_equal(r["ids"], runs[tag][0]["ids"])
               for r in runs[tag]):
            raise AssertionError("two %s runs generated different tokens"
                                 % tag)

    # prefill logits, kernel against plain, and the plain run's margins
    t0 = time.perf_counter()
    app = SequenceGeneration.from_pretrained(
        model_dir, dtype=torch.bfloat16, device="cuda")
    load_s = time.perf_counter() - t0
    ids_k, ids_p = runs["kernel"][0]["ids"], runs["plain"][0]["ids"]
    width = GEN_PROMPT_WIDTH
    mask_all = (np.arange(width)[None, :]
                >= width - n_real[:, None]).astype(np.int32)
    prefill, decode = make_gpt2_generation_fns(app.module,
                                               width + GEN_NEW_TOKENS)
    logits, margins = {}, []
    with torch.inference_mode():
        for use_kernel in (True, False):
            A.set_kernel_override(None if use_kernel else False)
            logits[use_kernel] = torch.cat([prefill(
                torch.from_numpy(prompt_ids[s:s + GEN_BATCH]).cuda(),
                torch.from_numpy(mask_all[s:s + GEN_BATCH]).cuda())[0]
                for s in range(0, GEN_ROWS, GEN_BATCH)])
        # the plain run's per-step top-2 margins, by teacher forcing its own
        # tokens through the plain path in one forward per batch (bf16: it
        # rounds like the run's decode steps, not bit for bit)
        for s in range(0, GEN_ROWS, GEN_BATCH):
            seq = torch.from_numpy(ids_p[s:s + GEN_BATCH]).cuda()
            mask = torch.ones_like(seq, dtype=torch.int32)
            mask[:, :width] = torch.from_numpy(mask_all[s:s + GEN_BATCH])
            out = app.module(seq, attention_mask=mask)["logits"]
            top2 = out[:, width - 1:-1].float().topk(2, dim=-1).values
            margins.append((top2[..., 0] - top2[..., 1]).cpu().numpy())
            del out
        A.set_kernel_override(None)
    margins = np.concatenate(margins)
    d_logits = (logits[True] - logits[False]).abs().max().item()
    decided, near_ties, compared = 0, 0, 0
    for row in range(GEN_ROWS):
        for j in range(GEN_NEW_TOKENS):
            a, b = ids_k[row, width + j], ids_p[row, width + j]
            if a != b:
                if margins[row, j] > 2 * GEN_LOGITS_ATOL:
                    raise AssertionError(
                        "row %d step %d: kernel token %d, plain %d, at a "
                        "top-2 margin of %.3e > %.1e" % (
                            row, j, a, b, margins[row, j],
                            2 * GEN_LOGITS_ATOL))
                near_ties += 1
                break
            compared += 1
            decided += margins[row, j] > 2 * GEN_LOGITS_ATOL
            if a == eos:
                break
    log("kernel vs plain run: prefill logits max |d| %.3e (bound %.1e); "
        "tokens agree at all %d steps compared before a row's first "
        "divergence or EOS (%d of them at a plain-run teacher-forced top-2 "
        "margin > %.1e); %d rows diverge, each at a near-tie (margin <= "
        "%.1e); %d of %d rows identical"
        % (d_logits, GEN_LOGITS_ATOL, compared, decided, 2 * GEN_LOGITS_ATOL,
           near_ties, 2 * GEN_LOGITS_ATOL,
           sum(np.array_equal(a, b) for a, b in zip(ids_k, ids_p)),
           GEN_ROWS))
    if d_logits > GEN_LOGITS_ATOL:
        raise AssertionError("kernel and plain prefill logits differ by "
                             "%.3e" % d_logits)

    # prefill and decode step times on one batch, kernel and plain in turns
    ids0 = torch.from_numpy(prompt_ids[:GEN_BATCH]).cuda()
    mask0 = torch.from_numpy(mask_all[:GEN_BATCH]).cuda()
    steps = {}
    for use_kernel in (True, False, False, True):
        A.set_kernel_override(None if use_kernel else False)
        pre, dec = _step_times(torch, prefill, decode, ids0, mask0, 32)
        steps.setdefault(use_kernel, ([], []))
        steps[use_kernel][0].extend(pre)
        steps[use_kernel][1].extend(dec)
    A.set_kernel_override(None)
    for use_kernel, (pre, dec) in steps.items():
        log("step %-6s batch %d x %d-token prompt: prefill ms median %.3f "
            "(min %.3f, max %.3f, %d runs); decode ms per token median %.3f "
            "(min %.3f, max %.3f, %d steps against %d cache slots); host "
            "clock, each call ends in a synchronize"
            % ("kernel" if use_kernel else "plain", GEN_BATCH, width,
               statistics.median(pre), min(pre), max(pre), len(pre),
               statistics.median(dec), min(dec), max(dec), len(dec),
               width + GEN_NEW_TOKENS))
    log("model load (SequenceGeneration.from_pretrained, bf16 on the card) "
        "%.3f s" % load_s)

    # where the time goes: torch.profiler over a prefill and 32 decode steps
    prof_path = os.path.join(workdir, "gen_trace.json")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _step_times(torch, prefill, decode, ids0, mask0, 32, runs=1)
    prof.export_chrome_trace(prof_path)
    share, busy_ms, top = device_share(prof_path)
    if share is None:
        log("profile: the trace holds no device kernels (not measured)")
    else:
        log("profile, kernel path, prefill + 32 decode steps (under the "
            "profiler): device busy %.1f%% of the span of its kernels, "
            "%.3f ms busy; device ms by kernel: %s"
            % (100 * share, busy_ms, "; ".join(
                "%s %.3f" % (n[:60], t) for n, t in top)))
    del app, prefill, decode, logits
    torch.cuda.empty_cache()

    # one beam-search batch with the kernels
    beam_tsv = os.path.join(workdir, "prompts_beam.tsv")
    with open(tsv, encoding="utf-8") as f, \
            open(beam_tsv, "w", encoding="utf-8") as g:
        g.writelines(f.readlines()[:GEN_BATCH])
    before = A.flash_attention_fwd.launches
    beam = run_generate(torch, model_dir, beam_tsv,
                        os.path.join(workdir, "gen_beam.tsv"), True,
                        "max_decoder_length=%d num_beams=%d"
                        % (GEN_BEAM_NEW_TOKENS, GEN_BEAMS))
    beam_launches = A.flash_attention_fwd.launches - before
    check_generation(beam["ids"], GEN_BATCH, width, GEN_BEAM_NEW_TOKENS,
                     GPT2_SMALL["vocab_size"], prompt_ids[:GEN_BATCH])
    describe_gen("beam", beam, generated_lengths(beam["ids"], width, eos))
    log("beam run: %d beams x %d rows, %d flash launches (%d layers x "
        "(prefill + decode steps))" % (GEN_BEAMS, GEN_BATCH, beam_launches,
                                       n_layer))
    if beam_launches == 0 or beam_launches % n_layer:
        raise AssertionError("the beam run launched the flash kernel %d "
                             "times" % beam_launches)
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=1234)
    seed = parser.parse_args().seed

    import torch
    # the port itself: outside a checkout this fails before anything prints
    import easynlp_tpu_torch.appzoo.api  # noqa: F401
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    phase_device(torch)
    build_s = phase_build()
    worst, timings = phase_kernel(torch, seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        launches = {}
        launches["short_attention_fwd"], cjk = phase_slice(torch, seed,
                                                           workdir)
        launches["short_attention_bwd"], ms_k, ms_p = phase_train(
            torch, seed, workdir, cjk)
        launches["flash_attention_fwd"] = phase_generation(torch, seed,
                                                           workdir)

    log("kernel build %.3f s" % build_s)
    log("training step, median of runs: %.3f ms with the kernels, %.3f ms "
        "plain" % (1e3 * ms_k, 1e3 * ms_p))
    log("card: %s" % card_line())
    entries = []
    for name, (source, replaces) in KERNELS.items():
        case = KERNEL_LINE_CASE[name]
        ms, plain_ms = timings[(name, case, torch.bfloat16)]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name][(case, torch.bfloat16)],
            "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
