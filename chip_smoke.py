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
tokens, greedy for 128 new tokens, and one beam-search batch. On a BART-base
model (HF `facebook/bart-base` widths and depth, dropout 0, random weights
from --seed, a synthetic 50265-token byte-level BPE vocab):
`--mode=train --app_name=sequence_generation` for 8 AdamW steps of 8
articles of 1024 tokens with 64-token targets, then `--mode=evaluate` on 16
rows with greedy decoding. Each path runs with the kernels and with
--use_flash_attention=false, and the two are compared. Every phase raises on
failure, so any failure exits non-zero. The last line is {"ok": true,
"device": {...}}; the line before it lists the kernels with their launches
in the BART training run, errors, times (kernel, plain twin, the PyTorch
library call) and bounds. Imports nothing of JAX or of the JAX package.
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

# csrc/<name>.cu, each built by one nvcc
KERNEL_SOURCES = ("short_attention_fwd", "short_attention_bwd",
                  "flash_attention_fwd", "flash_attention_bwd")
# one entry per TPU kernel: (the wrapper that launches it, its source, the
# TPU kernel it replaces). flash_attention_bwd.cu ports two TPU kernels.
KERNELS = {
    "short_attention_fwd": ("short_attention_fwd",
                            "easynlp_tpu_torch/csrc/short_attention_fwd.cu",
                            "easynlp_tpu/ops/attention.py:519"),
    "short_attention_bwd": ("short_attention_bwd",
                            "easynlp_tpu_torch/csrc/short_attention_bwd.cu",
                            "easynlp_tpu/ops/attention.py:531"),
    "flash_attention_fwd": ("flash_attention_fwd",
                            "easynlp_tpu_torch/csrc/flash_attention_fwd.cu",
                            "easynlp_tpu/ops/attention.py:127"),
    "flash_attention_bwd_dkdv": ("flash_attention_bwd",
                                 "easynlp_tpu_torch/csrc/flash_attention_bwd.cu",
                                 "easynlp_tpu/ops/attention.py:232"),
    "flash_attention_bwd_dq": ("flash_attention_bwd",
                               "easynlp_tpu_torch/csrc/flash_attention_bwd.cu",
                               "easynlp_tpu/ops/attention.py:286"),
}
# the shape each entry of the kernels line reports (bf16): the shapes the
# BART training path gives each kernel
KERNEL_LINE_CASE = {"short_attention_fwd": "bart-decoder",
                    "short_attention_bwd": "bart-decoder",
                    "flash_attention_fwd": "bart-encoder",
                    "flash_attention_bwd_dkdv": "bart-encoder",
                    "flash_attention_bwd_dq": "bart-encoder"}
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores, data sheet

# Tolerances. f32: 2e-5, the bound tests/test_attention.py holds the JAX short
# kernel to against its reference. Both bf16 forwards (short and flash) run
# on the tensor cores and round each unnormalised probability to bf16 before
# P V: they take the bound derived beside FLASH_FWD_RSS_BF16 below.
ATOL_F32 = 2e-5
# Slice: the kernel run and the --use_flash_attention=false run are both
# bf16 end to end and differ only in attention's rounding (the plain path
# rounds max-subtracted scores and the probabilities to bf16, the kernel
# keeps the scores in f32 and rounds each unnormalised probability once).
# Each of 12 layers moves its output by about a bf16 ulp
# (2^-8 relative), LayerNorm keeps activations O(1), and the 0.02-std head
# maps a pooled change of ~1e-2 to a logit change of ~5e-3. Bound 5e-2 on
# logits and probabilities, about 10x that; labels must agree wherever the
# kernel run's logit margin exceeds twice the bound.
SLICE_ATOL = 5e-2
# Backward, kernel against its f32 twin on the same inputs (q, k, v, the
# forward output o, dO; bf16 ones cast to f32 for the twin). f32 (the
# CUDA-core walks): 2e-5 + 1e-5 |g| (sums in another order; dv grows to ~40
# where one key carries a whole row).
BWD_ATOL_F32, BWD_RTOL_F32 = 2e-5, 1e-5
# Both backwards from bf16 inputs run on the tensor cores (the bound of one
# rounding of dq/dk/dv, 1e-4 + 2^-8 |g|, held the short one only while it
# computed in f32 on the CUDA cores), which round
# twice more: each dq/dk/dv element g = sum_j x_j y_j (x = P for dv, dS for
# dq and dk) is summed in f32 from x_j rounded to bf16, then rounded to bf16
# itself. A bf16 rounding moves a value by at most 2^-8 of itself (8
# significant bits, half an ulp), so
#   |g_kernel - g| <= 2^-8 |g| + |sum_j e_j x_j y_j|,  |e_j| <= 2^-8,
# plus f32 sum-order error. The worst case of the second term is
# 2^-8 sum_j |x_j y_j|, which random inputs never approach: the e_j are
# independent, mean 0, with rms about 0.43 x 2^-8 (uniform within half an
# ulp), so the sum has spread 0.43 x 2^-8 R, R = sqrt(sum_j (x_j y_j)^2)
# (flash_attention_bwd_rss), and its largest value over the ~2e7 elements
# of a BART-encoder backward lies near 5.6 of those spreads, 2.4 x 2^-8 R.
# Bound: 1e-5 + 2^-8 |g| + 2.5 x 2^-8 R. Autograd through bf16
# attention_reference rounds the same P and dS and also the max-subtracted
# scores (a P error of 2^-8 |s - max|, several times 2^-8 P) and dP, so it
# must exceed this bound on the same inputs; the check asserts that it does
# (tests/test_torch_flash_attention_bwd.py pins both sides on the CPU).
FLASH_BWD_ATOL_BF16, FLASH_BWD_RTOL_BF16 = 1e-5, 2 ** -8
FLASH_BWD_RSS_BF16 = 2.5 * 2 ** -8
# The flash forward from bf16 inputs runs on the tensor cores, which round
# each unnormalised probability p_k = exp(s_k - m) to bf16 before P V, as
# _fwd_kernel does (attention.py:155), while l sums the f32 p_k. So each
# element of O is
# o = sum_k P_k v_k (P = p / l) summed in f32 from terms each moved by
# e_k P_k v_k, |e_k| <= 2^-8 (half an ulp of 8 significant bits), then
# rounded to bf16 itself (at most 2^-8 |o|). As for the backward below, the
# e_k are independent with rms about 0.43 x 2^-8, so the term sum has spread
# 0.43 x 2^-8 R, R = sqrt(sum_k (P_k v_k)^2) (flash_attention_fwd_rss), and
# its largest value over the ~6e6 elements of a BART-encoder forward lies
# near 5.3 of those spreads, 2.3 x 2^-8 R. Bound: 1e-5 + 2^-8 |o| +
# 2.5 x 2^-8 R. bf16 attention_reference also rounds the max-subtracted
# scores and the normalised probabilities; its forward exceeds this bound at
# moderate sizes but not always at the small ones (it is logged;
# tests/test_torch_flash_attention.py pins both sides on the CPU). LSE: the
# same f32 sums of exact bf16 products.
FLASH_FWD_ATOL_BF16, FLASH_FWD_RTOL_BF16 = 1e-5, 2 ** -8
FLASH_FWD_RSS_BF16 = 2.5 * 2 ** -8
# Training: the kernel run and the plain run draw the same dropout masks
# (same seed, and attention draws no random numbers), so their per-step
# losses differ only by attention's rounding, compounded over 8 AdamW steps.
# The predict path's largest logit gap, kernel against plain on an H100, is
# 6.7e-3; the loss is a mean over 32 rows. Bound 2e-2.
TRAIN_LOSS_ATOL = 2e-2
# Flash forward against its twin on the same inputs: O as the short kernel
# (f32 2e-5; bf16 the bound above). LSE is f32 in both: 2e-5 +
# 1e-6 |lse| for the sum order (|lse| <= ~20; a fully masked row's -1e30
# must match too); from bf16 inputs the same scores, so 1e-4 + 1e-6 |lse|.
LSE_ATOL_F32, LSE_ATOL_BF16, LSE_RTOL = 2e-5, 1e-4, 1e-6
# Generation: the kernel run and the --use_flash_attention=false run are
# both bf16 end to end and differ only in attention's rounding (the plain
# path rounds max-subtracted scores and probabilities to bf16; the flash
# forward keeps the scores f32 and, on the tensor cores, rounds each
# probability to bf16 once), a bf16 ulp (2^-8 relative) per layer, as in
# BERT; with 0.02-std weights GPT-2's logits have std ~0.5, so 12 layers
# move them by ~1e-2. Bound 5e-2 on the prefill logits; greedy tokens must
# agree at every step where the plain run's top-2 margin exceeds twice the
# bound, until a row's first near-tie (after it the two runs continue
# different texts).
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
    kernels.load_all(list(KERNEL_SOURCES))
    seconds = time.perf_counter() - t0
    for name in KERNEL_SOURCES:
        info = kernels.build_info(name)
        log("built easynlp_tpu_torch/csrc/%s.cu -> %s: nvcc %.3f s, cached=%s"
            % (name, info["path"], info["seconds"], info["cached"]))
        for line in info["log"].splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log("ptxas: " + line.strip())
    log("%d kernel sources built and loaded in %.3f s (nvcc runs in "
        "parallel)" % (len(KERNEL_SOURCES), seconds))
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


def _bound(nbytes, flops):
    """(the least ms the card could take, what bounds it): the bytes the
    function must move over 3.35 TB/s against its operations over the bf16
    tensor cores' 989 TFLOP/s."""
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_BF16_FLOPS
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def _pairs(mask, b, sq, skv, h, causal):
    """(query, key) pairs this data needs, over all heads: each row's
    visible keys (masked or causally hidden ones excluded); a row that sees
    no key averages all Skv."""
    import numpy as np
    m = np.broadcast_to(mask.cpu().numpy().astype(bool), (b, skv))
    seen = m[:, None, :]
    if causal:
        qi = np.arange(sq)[:, None] + (skv - sq)
        seen = seen & (np.arange(skv)[None, :] <= qi)[None]
    per_row = np.broadcast_to(seen, (b, sq, skv)).sum(-1)
    return h * int(np.where(per_row == 0, skv, per_row).sum())


def _sdpa_mask(torch, mask, sq, skv, causal):
    """The boolean [B,1,Sq,Skv] mask (True = attend) of the same function
    for torch's scaled_dot_product_attention."""
    keep = mask.bool()[:, None, None, :]
    if causal:
        qi = torch.arange(sq, device=mask.device)[:, None] + (skv - sq)
        keep = keep & (torch.arange(skv, device=mask.device)[None, :] <= qi)
    return keep


def _sdpa_backend(torch, q, k, v, keep):
    """The backend scaled_dot_product_attention picks for these inputs (a
    label for the log)."""
    from torch.nn.attention import SDPBackend
    names = {int(v): n for n, v in SDPBackend.__members__.items()}
    try:
        return names.get(int(torch._fused_sdp_choice(q, k, v, keep, 0.0,
                                                     False)), "?")
    except (AttributeError, RuntimeError, TypeError) as err:
        return "unknown (%s)" % type(err).__name__


def _time_sdpa(torch, tq, tk, tv, mask, causal, do, iters):
    """PyTorch's one call for the same function, the yardstick of
    `library_ms` (a measurement only: the port never calls it):
    scaled_dot_product_attention with the same boolean mask, forward, and
    backward from a kept graph. (forward ms, backward ms, backend)."""
    F = torch.nn.functional
    keep = _sdpa_mask(torch, mask, tq.shape[1], tk.shape[1], causal)
    q, k, v = (t.transpose(1, 2) for t in (tq, tk, tv))
    backend = _sdpa_backend(torch, q, k, v, keep)
    fwd = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=keep), iters=iters)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=keep)
    g = do.transpose(1, 2)
    bwd = _time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, g, retain_graph=True), iters=iters)
    return fwd, bwd, backend


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
        # BART-base's decoder self-attention: 64-token targets, causal
        ("bart-decoder", 8, 64, 64, 12, 64, lengths(8, 64), True),
        # machine_reading_comprehension's 16 x 384 (B2 past 128 keys)
        ("mrc-384", 16, 384, 384, 12, 64, lengths(16, 384), False),
        # BART predict's decode step under 4 beams: 8 x 4 rows, one query
        # against the decoder's 64 cache slots, the written ones visible
        ("bart-beam-decode-self", 32, 1, 64, 12, 64, lengths(32, 64),
         False),
        ("decode-causal", 4, 1, 24, 12, 64, lengths(4, 24), True),
        ("ragged-40-masked-row", 4, 40, 40, 12, 64, lengths(4, 40, True),
         False),
        ("causal-37x40", 4, 37, 40, 12, 64, lengths(4, 40), True),
    ]
    # The bf16 kernel's key-tile skip, from a stream of their own (so the
    # timed inputs below do not depend on them): every row's second key
    # tile masked, which the kernel skips; and a fully masked batch row past
    # 64 keys, which walks every tile.
    skip_rng = np.random.RandomState(seed + 1)
    skip_cases = [
        ("masked-tail-128", 32, 128, 128, 12, 64,
         skip_rng.randint(1, 61, size=32), False),
        ("masked-row-200", 4, 200, 200, 12, 64,
         np.r_[200, skip_rng.randint(1, 201, size=2), 0], False),
    ]
    worst = {}
    for case_rng, group in ((rng, cases), (skip_rng, skip_cases)):
        for name, b, sq, skv, h, d, lens, causal in group:
            q, k, v, mask = _inputs(torch, case_rng, b, sq, skv, h, d, lens)
            for dtype in (torch.float32, torch.bfloat16):
                worst[(name, dtype)] = _check_short_fwd(
                    torch, A, name, q.to(dtype), k.to(dtype), v.to(dtype),
                    mask, causal)
            _check_bwd(torch, A, case_rng, name, q, k, v, mask, causal,
                       worst_bwd)

    timings = {}
    for name, b, sq, skv, h, d, lens, causal in cases[:5]:
        q, k, v, mask = _inputs(torch, rng, b, sq, skv, h, d, lens)
        for dtype in (torch.bfloat16, torch.float32):
            tq, tk, tv = (t.to(dtype) for t in (q, k, v))
            ms = _time_ms(torch, lambda: A.short_attention_fwd(
                tq, tk, tv, mask, causal))
            plain_ms = _time_ms(torch, lambda: A.short_attention_fwd_reference(
                tq, tk, tv, mask, causal))
            ref_ms = _time_ms(torch, lambda: A.attention_reference(
                tq, tk, tv, kv_mask=mask, causal=causal))
            do = torch.randn_like(tq)
            lib_fwd, lib_bwd, backend = _time_sdpa(torch, tq, tk, tv, mask,
                                                   causal, do, 50)
            # the profiler's word on the route: bf16 on the tensor cores,
            # f32 on the CUDA cores, and the kernel's device time
            want_name, refused = ((SHORT_FWD_MMA_NAME, SHORT_FWD_CUDA_CORE_NAME)
                                  if dtype == torch.bfloat16 else
                                  (SHORT_FWD_CUDA_CORE_NAME, SHORT_FWD_MMA_NAME))
            o = A.short_attention_fwd(tq, tk, tv, mask, causal)
            keep = _sdpa_mask(torch, mask, sq, skv, causal)
            sdpa_qkv = [t.transpose(1, 2) for t in (tq, tk, tv)]

            def one_of_each():
                A.short_attention_fwd(tq, tk, tv, mask, causal)
                torch.nn.functional.scaled_dot_product_attention(
                    *sdpa_qkv, attn_mask=keep)
                if dtype == torch.bfloat16:
                    A.short_attention_bwd(tq, tk, tv, mask, o, do, causal)
            # one profiler session for the forward kernel, SDPA's forward
            # (every kernel whose name is not an attention kernel's) and, in
            # bf16, the backward kernels
            times = _device_ms(torch, one_of_each, want=(want_name,) + (
                tuple(n for _, n in _short_bwd_names(torch, A, dtype, sq,
                                                     skv))))
            sdpa_dev = sum(ms for key, ms in times.items() if not any(
                n in key for n in ATTENTION_KERNEL_NAMES))
            nbytes = (2 * q.numel() + 2 * k.numel()) * tq.element_size() \
                + mask.numel() * 4
            pairs = _pairs(mask, b, sq, skv, h, causal)
            bound_ms, bound_by = _bound(nbytes, 4 * pairs * d)
            dev = _routed("the %s short forward at %s" % (dtype, name),
                          times, (("kernel", want_name),),
                          (refused,))["kernel"]
            before = ""
            if dtype == torch.bfloat16 and name in CUDA_CORE_SHORT_FWD_MS:
                was = CUDA_CORE_SHORT_FWD_MS[name]
                before = " (the CUDA-core walk before: %.4f ms, %.2fx)" % (
                    was, was / ms)
            log("profile %-12s %-8s %s %.4f ms per call (device time; no %s "
                "in the trace)" % (name, str(dtype).split(".")[1], want_name,
                                   dev, refused))
            log("time %-12s %-8s kernel %.4f ms%s, device %.4f ms (%.1f GB/s "
                "= %.1f%% of 3.35 TB/s, %.2f TFLOP/s on the visible pairs, "
                "on the device time; bound %.4f ms by %s); plain twin %.4f "
                "ms; attention_reference %.4f ms; SDPA forward %.4f ms, "
                "device %.4f ms (%s)"
                % (name, str(dtype).split(".")[1], ms, before, dev,
                   nbytes / dev / 1e6,
                   100 * nbytes / (dev * 1e-3) / PEAK_BYTES_PER_S,
                   4 * pairs * d / dev / 1e9, bound_ms, bound_by, plain_ms,
                   ref_ms, lib_fwd, sdpa_dev, backend))
            timings[("short_attention_fwd", name, dtype)] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_fwd,
                bound_ms=bound_ms, bound_by=bound_by)
            timings[("short_attention_bwd", name, dtype)] = _time_bwd(
                torch, A, name, tq, tk, tv, mask, causal, o, do, lib_bwd,
                times)
    worst_flash = _check_flash(torch, A, rng, timings)
    worst_flash_bwd = _check_flash_bwd(torch, A, rng, timings)
    return {"short_attention_fwd": worst,
            "short_attention_bwd": worst_bwd,
            "flash_attention_fwd": worst_flash,
            "flash_attention_bwd_dkdv": worst_flash_bwd,
            "flash_attention_bwd_dq": worst_flash_bwd}, timings


def _check_short_fwd(torch, A, name, tq, tk, tv, mask, causal):
    """The short forward kernel against its f32 twin on the same inputs, in
    bshd and heads-major memory: f32 (the CUDA-core walk) within 2e-5, bf16
    (the tensor cores) within the flash forward's bound. bf16 also gives the
    same bits twice and the same bits as the bf16 flash forward, which
    shares its tile step but walks every key tile: the key tiles the short
    kernel skips were exact no-ops. Returns the largest |error|."""
    dtype = tq.dtype
    twin = (tq.float(), tk.float(), tv.float(), mask, causal)
    want = A.short_attention_fwd_reference(*twin)
    rss = A.flash_attention_fwd_rss(*twin) if dtype == torch.bfloat16 \
        else None
    worst = 0.0
    for layout in ("bshd", "bhsd"):
        if layout == "bshd":
            got = A.short_attention_fwd(tq, tk, tv, mask, causal)
        else:
            hq, hk, hv = (t.transpose(1, 2).contiguous()
                          for t in (tq, tk, tv))
            got = A.attention(hq, hk, hv, kv_mask=mask, causal=causal,
                              impl="short", layout="bhsd").transpose(1, 2)
        torch.cuda.synchronize()
        if got.dtype != dtype or got.shape != want.shape:
            raise AssertionError("%s: got %s %s, want %s %s" % (
                name, got.dtype, tuple(got.shape), dtype, tuple(want.shape)))
        err = (got.float() - want).abs().max().item()
        if dtype == torch.float32:
            ok = err <= ATOL_F32
            bound = "atol %.1e" % ATOL_F32
        else:
            ratio = _flash_fwd_bf16_ratio(A, got, want, rss)
            ok = ratio <= 1
            bound = ("error / bound (%.0e + 2^-8 |o| + %.1f x 2^-8 R) %.3f"
                     % (FLASH_FWD_ATOL_BF16, FLASH_FWD_RSS_BF16 / 2 ** -8,
                        ratio))
        log("check %-22s %-8s %-4s max_abs_err %.3e (%s) %s"
            % (name, str(dtype).split(".")[1], layout, err, bound,
               "ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("kernel disagrees with its plain version: "
                                 "%s %s %s err %.3e" % (name, dtype, layout,
                                                        err))
        worst = max(worst, err)
    if dtype == torch.bfloat16:
        got = A.short_attention_fwd(tq, tk, tv, mask, causal)
        again = A.short_attention_fwd(tq, tk, tv, mask, causal)
        flash, _ = A.flash_attention_fwd(tq, tk, tv, mask, causal)
        if not (torch.equal(again, got) and torch.equal(flash, got)):
            raise AssertionError("%s: two bf16 short forward runs, or the "
                                 "short and flash forwards, differ" % name)
        log("check %-22s bfloat16 two runs and the flash forward (every key "
            "tile walked) give the same bits" % name)
    return worst


def _ranges_mask(torch, skv, ranges):
    """int32 [B,Skv] key mask, 1 on each row's [start, end) slots."""
    import numpy as np
    idx = np.arange(skv)[None, :]
    starts, ends = (np.asarray(x)[:, None] for x in zip(*ranges))
    return torch.from_numpy(((idx >= starts) & (idx < ends)).astype(
        np.int32)).cuda()


def bart_source_ranges(rng):
    """Per-row real keys of BART-base's encoder at --sequence_length=1024:
    1024, 700, 313, then random lengths."""
    lens = [1024, 700, 313] + list(rng.randint(1, 1025, size=5))
    return [(0, n) for n in lens]


def flash_cases(rng):
    """The flash forward's shapes: BART-base's encoder self-attention
    (8 x 1024, padded rows) and cross-attention (8 x 64 targets against
    1024 source keys) and the cross-attention of a decode step (8 x 1, and
    8 x 4 beams x 1);
    GPT-2 small's prefill (8 x 768, causal, left-padded prompts of 600..768
    tokens, so the pad rows are fully masked) and decode (8 x 1 against 896
    cache slots, the last 28 empty), S=2048 and S=8192 (causal, padded),
    causal 37 x 600 (Sq != Skv) and a fully masked row. Each: name, B, Sq,
    Skv, H, D, [(start, end) of each row's real keys], causal."""
    src = bart_source_ranges(rng)
    prompt = rng.randint(600, 769, size=8)
    prompt[0] = 768
    return [
        ("bart-encoder", 8, 1024, 1024, 12, 64, src, False),
        ("bart-cross", 8, 64, 1024, 12, 64, src, False),
        ("bart-decode-cross", 8, 1, 1024, 12, 64, src, False),
        # the same under 4 beams: each source row's keys for its 4 beams
        ("bart-beam-decode-cross", 32, 1, 1024, 12, 64,
         [r for r in src for _ in range(4)], False),
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


def _flash_fwd_bf16_ratio(A, got, want, rss):
    """Largest |got - want| / bound, the bf16 flash forward's bound
    1e-5 + 2^-8 |o| + 2.5 x 2^-8 R (derived beside FLASH_FWD_RSS_BF16)."""
    bound = FLASH_FWD_ATOL_BF16 + FLASH_FWD_RTOL_BF16 * want.abs() \
        + FLASH_FWD_RSS_BF16 * rss
    return ((got.float() - want).abs() / bound).max().item()


def _check_flash(torch, A, rng, timings):
    """The flash forward kernel against its f32 twin (O and LSE), f32 and
    bf16, bshd and heads-major memory, at flash_cases(): f32 within 2e-5,
    bf16 within the tensor-core bound (bf16 attention_reference's ratio to
    it logged beside). Then its time against the twin, bf16
    attention_reference and SDPA at each shape (f32 too at the prefill's),
    and the profiler's word that bf16 calls launch the tensor-core kernel
    and not the CUDA-core walk."""
    worst = {}
    for name, b, sq, skv, h, d, ranges, causal in flash_cases(rng):
        q, k, v, _ = _inputs(torch, rng, b, sq, skv, h, d, [skv] * b)
        mask = _ranges_mask(torch, skv, ranges)
        for dtype, lse_atol in ((torch.float32, LSE_ATOL_F32),
                                (torch.bfloat16, LSE_ATOL_BF16)):
            tq, tk, tv = (t.to(dtype) for t in (q, k, v))
            twin_args = (tq.float(), tk.float(), tv.float(), mask, causal)
            want, want_lse = A.flash_attention_fwd_reference(*twin_args)
            if dtype == torch.bfloat16:
                rss = A.flash_attention_fwd_rss(*twin_args)
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
                if dtype == torch.float32:
                    ok = err <= ATOL_F32 and lse_excess <= 0
                    bound = "atol %.1e" % ATOL_F32
                else:
                    ratio = _flash_fwd_bf16_ratio(A, got, want, rss)
                    ok = ratio <= 1 and lse_excess <= 0
                    bound = ("error / bound (%.0e + 2^-8 |o| + %.1f x 2^-8 "
                             "R) %.3f" % (FLASH_FWD_ATOL_BF16,
                                          FLASH_FWD_RSS_BF16 / 2 ** -8,
                                          ratio))
                log("check flash %-16s %-8s %-4s max_abs_err %.3e (%s);"
                    " lse max_abs_err %.3e (bound %.1e + %.0e |lse|) %s"
                    % (name, str(dtype).split(".")[1], layout, err, bound,
                       lse_err, lse_atol, LSE_RTOL, "ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError("flash kernel disagrees with its "
                                         "plain version: %s %s %s err %.3e, "
                                         "lse err %.3e"
                                         % (name, dtype, layout, err,
                                            lse_err))
                worst[(name, dtype)] = max(worst.get((name, dtype), 0.0),
                                           err)
            if dtype == torch.bfloat16:
                plain = A.attention_reference(tq, tk, tv, kv_mask=mask,
                                              causal=causal)
                log("check flash %-16s bfloat16 bf16 attention_reference: "
                    "error / the same bound %.3f (logged: it exceeds the "
                    "bound at moderate sizes, not always at small ones)"
                    % (name, _flash_fwd_bf16_ratio(A, plain, want, rss)))
                del plain, rss
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
            lib_ms, _, backend = _time_sdpa(torch, tq, tk, tv, mask, causal,
                                            torch.randn_like(tq), iters)
            nbytes = (2 * q.numel() + 2 * k.numel()) * tq.element_size() \
                + mask.numel() * 4 + b * h * sq * 4
            flops = 4 * _pairs(mask, b, sq, skv, h, causal) * d
            bound_ms, bound_by = _bound(nbytes, flops)
            before = ""
            if dtype == torch.bfloat16:
                if name in CUDA_CORE_FLASH_FWD_MS:
                    was = CUDA_CORE_FLASH_FWD_MS[name]
                    before = " (the CUDA-core walk before: %.4f ms, %.2fx)" % (
                        was, was / ms)
                dev = _routed("the bf16 flash forward at %s" % name,
                              _device_ms(torch, lambda: A.flash_attention_fwd(
                                  tq, tk, tv, mask, causal),
                                  want=(FLASH_FWD_MMA_NAME,)),
                              (("kernel", FLASH_FWD_MMA_NAME),),
                              (FLASH_FWD_CUDA_CORE_NAME,))
                log("profile flash %-16s bfloat16 %s %.4f ms per call "
                    "(device time; no CUDA-core walk in the trace)"
                    % (name, FLASH_FWD_MMA_NAME, dev["kernel"]))
            log("time flash %-17s %-8s kernel %.4f ms%s (%.1f GB/s = %.2f%% "
                "of 3.35 TB/s, %.2f TFLOP/s on the visible pairs; bound %.4f "
                "ms by %s); plain twin %.4f ms; attention_reference %.4f ms; "
                "SDPA forward %.4f ms (%s)"
                % (name, str(dtype).split(".")[1], ms, before,
                   nbytes / ms / 1e6,
                   100 * nbytes / (ms * 1e-3) / PEAK_BYTES_PER_S,
                   flops / ms / 1e9, bound_ms, bound_by, plain_ms, ref_ms,
                   lib_ms, backend))
            timings[("flash_attention_fwd", name, dtype)] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by)
        del q, k, v, tq, tk, tv
        torch.cuda.empty_cache()
    return worst


def flash_bwd_cases(rng):
    """The flash backward's shapes: BART-base's encoder (8 x 1024, rows of
    1024/700/313/... real keys) and cross-attention (8 x 64 x 1024), GPT-2
    small's prefill (8 x 768, causal, left-padded, so its pad rows are
    fully masked), ragged causal 37 x 600, a fully masked batch row and
    S=8192 causal. Each: name, B, Sq, Skv, H, D, ranges, causal."""
    src = bart_source_ranges(rng)
    prompt = rng.randint(600, 769, size=8)
    prompt[0] = 768
    return [
        ("bart-encoder", 8, 1024, 1024, 12, 64, src, False),
        ("bart-cross", 8, 64, 1024, 12, 64, src, False),
        ("gpt2-prefill", 8, 768, 768, 12, 64,
         [(768 - n, 768) for n in prompt], True),
        ("causal-37x600", 4, 37, 600, 12, 64,
         [(0, n) for n in [600] + list(rng.randint(1, 601, size=3))], True),
        ("masked-row-700", 4, 40, 700, 12, 64,
         [(0, n) for n in [700] + list(rng.randint(1, 701, size=2)) + [0]],
         False),
        ("S8192-causal", 1, 8192, 8192, 12, 64, [(0, 8000)], True),
    ]


# The bf16 flash backward's kernels by name: the pre-pass and the two
# tensor-core passes (csrc/attention_bwd_mma.cuh).
FLASH_BWD_KERNEL_NAMES = (("pre", "flash_attention_bwd_pre_kernel"),
                          ("dkdv", "flash_attention_bwd_dkdv_mma_kernel"),
                          ("dq", "flash_attention_bwd_dq_mma_kernel"))
# attention_bwd_tile.cuh's CUDA-core walks (f32 inputs and the short
# backward take them; bf16 flash inputs must not)
CUDA_CORE_BWD_NAMES = ("attention_bwd_dkdv_kernel", "attention_bwd_dq_kernel")
# The flash forward kernels by name: the tensor-core kernel
# (csrc/attention_fwd_mma.cuh) and the CUDA-core walk it replaced for bf16
# (csrc/flash_attention_fwd.cu), which f32 still takes.
FLASH_FWD_MMA_NAME = "flash_attention_fwd_mma_kernel"
FLASH_FWD_CUDA_CORE_NAME = "flash_attention_fwd_kernel"
# The short forward's kernels by name (csrc/short_attention_fwd.cu): bf16 on
# the tensor cores, f32 on the CUDA cores.
SHORT_FWD_MMA_NAME = "short_attention_fwd_mma_kernel"
SHORT_FWD_CUDA_CORE_NAME = "short_attention_fwd_kernel"
# The bf16 short backward's routes (csrc/short_attention_bwd.cu): one block
# per (b, h) up to 128 keys, the flash backward's passes above.
SHORT_BWD_ONE_BLOCK_NAMES = (("one-block", "short_attention_bwd_mma_kernel"),)
SHORT_BWD_FLASH_ROUTE_NAMES = (("lse", FLASH_FWD_MMA_NAME),
                               ) + FLASH_BWD_KERNEL_NAMES
SHORT_BWD_CUDA_CORE_NAMES = ("short_attention_bwd_stats_kernel",
                             ) + CUDA_CORE_BWD_NAMES
# every attention kernel by name, for the per-step profile lines
ATTENTION_KERNEL_NAMES = (
    SHORT_FWD_MMA_NAME, SHORT_FWD_CUDA_CORE_NAME, FLASH_FWD_MMA_NAME,
    FLASH_FWD_CUDA_CORE_NAME) + tuple(
        name for _, name in SHORT_BWD_ONE_BLOCK_NAMES + FLASH_BWD_KERNEL_NAMES
    ) + SHORT_BWD_CUDA_CORE_NAMES
# The bf16 flash forward and short backward on the CUDA-core walks they
# took before the tensor-core kernels (this script on an NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md's tables), printed beside this run's
CUDA_CORE_FLASH_FWD_MS = {"bart-encoder": 1.3275, "gpt2-prefill": 0.5233,
                          "S8192-causal": 5.7010, "gpt2-decode": 0.1134}
CUDA_CORE_SHORT_BWD_MS = {"slice-128": 0.3418, "slice-512": 1.2437,
                          "bart-decoder": 0.0921}
# The bf16 short forward on the CUDA-core walk it took before the tensor
# cores (this script, CUDA events; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)
CUDA_CORE_SHORT_FWD_MS = {"slice-128": 0.0879, "slice-512": 0.3285,
                          "bart-decoder": 0.1111}
# The bf16 flash backward's time at each flash_bwd_cases() shape on the
# CUDA-core walk it took before the tensor-core passes (this script on an
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md), printed beside this run's
CUDA_CORE_FLASH_BWD_MS = {"bart-encoder": 3.9733, "bart-cross": 0.3522,
                          "gpt2-prefill": 1.4527, "causal-37x600": 0.1371,
                          "masked-row-700": 0.1972, "S8192-causal": 17.5627}


PROFILE_ATTEMPTS = 4


def _device_ms(torch, fn, calls=5, want=()):
    """{kernel name: device ms per call} of `calls` calls of fn: the device
    kernels of torch.profiler's key_averages (PyTorch's operators, which
    hold their kernels' time again, left out). On an H100 a session has now
    and then recorded none or only some of the kernels that ran (the launch
    counts and CUDA-event times say they ran), so a session whose record
    lacks a kernel named in `want` runs again, up to PROFILE_ATTEMPTS
    times; _routed then judges the last record."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA \
                    and e.device_time_total:
                out[e.key] = out.get(e.key, 0.0) \
                    + e.device_time_total / 1e3 / calls
        missing = [n for n in want if not any(n in key for key in out)]
        if out and not missing:
            return out
        log("profile: session %d recorded %d kernels, lacking %s"
            % (attempt, len(out), missing or "all"))
    return out


def _routed(what, times, want, refused):
    """{part: device ms} for the kernels named in `want` ((part, name)
    pairs), from _device_ms's `times`. Raises when one of them is missing
    from the trace or a kernel named in `refused` ran."""
    parts = {part: sum(ms for key, ms in times.items() if name in key)
             for part, name in want}
    ran = sorted(key for key in times if any(name in key for name in refused))
    if ran:
        raise AssertionError("%s ran %s" % (what, ran))
    missing = [name for part, name in want if not parts[part]]
    if missing:
        raise AssertionError("the profiler trace of %s holds no device time "
                             "for %s" % (what, missing))
    return parts


def _flash_bwd_split(torch, A, args, calls=5):
    """Device ms per call of the bf16 flash backward's three kernels
    (pre-pass, tensor-core dK/dV, tensor-core dQ) from torch.profiler.
    Raises when the trace lacks one of them or holds a CUDA-core walk."""
    return _routed("the bf16 flash backward",
                   _device_ms(torch, lambda: A.flash_attention_bwd(*args),
                              calls, want=[n for _, n in
                                           FLASH_BWD_KERNEL_NAMES]),
                   FLASH_BWD_KERNEL_NAMES, CUDA_CORE_BWD_NAMES)


def _check_flash_bwd(torch, A, rng, timings):
    """The flash backward kernels against their f32 twin (dq, dk, dv from
    the same q, k, v, kernel O and LSE, dO), f32 and bf16, at
    flash_bwd_cases(); two runs must give the same bits, and the bf16 bound
    must be one that autograd through bf16 attention_reference fails on the
    same inputs. Then, bf16, the kernels' time against the earlier
    CUDA-core walk's, the twin, autograd through bf16 attention_reference (backward only) and SDPA's
    backward, and each kernel's device time from the profiler."""
    import numpy as np
    worst = {}
    for name, b, sq, skv, h, d, ranges, causal in flash_bwd_cases(rng):
        q, k, v, _ = _inputs(torch, rng, b, sq, skv, h, d, [skv] * b)
        mask = _ranges_mask(torch, skv, ranges)
        do = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(
            np.float32)).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            tq, tk, tv, tdo = (t.to(dtype) for t in (q, k, v, do))
            o, lse = A.flash_attention_fwd(tq, tk, tv, mask, causal)
            want = A.flash_attention_bwd_reference(
                tq.float(), tk.float(), tv.float(), mask, o.float(), lse,
                tdo.float(), causal)
            got = A.flash_attention_bwd(tq, tk, tv, mask, o, lse, tdo, causal)
            torch.cuda.synchronize()
            err, excess = 0.0, 0.0
            for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
                if g.dtype != dtype or g.shape != w.shape:
                    raise AssertionError("%s %s: got %s %s, want %s %s" % (
                        name, gname, g.dtype, tuple(g.shape), dtype,
                        tuple(w.shape)))
                diff = (g.float() - w).abs()
                err = max(err, diff.max().item())
                if dtype == torch.float32:
                    excess = max(excess, (diff - BWD_ATOL_F32 - BWD_RTOL_F32
                                          * w.abs()).max().item())
            if dtype == torch.float32:
                ok = excess <= 0
                log("check flash bwd %-16s float32  max_abs_err %.3e (bound "
                    "%.1e + %.1e |g|) %s" % (name, err, BWD_ATOL_F32,
                                             BWD_RTOL_F32,
                                             "ok" if ok else "FAIL"))
            else:
                ratio, plain_ratio = _bwd_bf16_ratios(
                    torch, A, (tq, tk, tv, mask, o, lse, tdo, causal), got,
                    want)
                ok = ratio <= 1 and plain_ratio >= 1
                log("check flash bwd %-16s bfloat16 max_abs_err %.3e; "
                    "largest error / bound (%.0e + 2^-8 |g| + %.1f x 2^-8 R): "
                    "kernels %.3f, autograd through bf16 attention_reference "
                    "%.3f (must be >= 1) %s"
                    % (name, err, FLASH_BWD_ATOL_BF16,
                       FLASH_BWD_RSS_BF16 / 2 ** -8, ratio, plain_ratio,
                       "ok" if ok else "FAIL"))
            del want
            if not ok:
                raise AssertionError("flash backward kernels disagree with "
                                     "their plain version, or the bf16 bound "
                                     "is looser than the plain path's error: "
                                     "%s %s err %.3e" % (name, dtype, err))
            again = A.flash_attention_bwd(tq, tk, tv, mask, o, lse, tdo,
                                          causal)
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError("%s %s: two flash backward runs differ"
                                     % (name, dtype))
            worst[(name, dtype)] = max(worst.get((name, dtype), 0.0), err)
            del got, again
            torch.cuda.empty_cache()
        # bf16 timings (the BART path's dtype)
        tq, tk, tv, tdo = (t.to(torch.bfloat16) for t in (q, k, v, do))
        o, lse = A.flash_attention_fwd(tq, tk, tv, mask, causal)
        args = (tq, tk, tv, mask, o, lse, tdo, causal)
        # the small shapes' calls are host-bound (the loop measures the
        # wrapper's enqueue), so they run longer to average the host's noise
        iters = 3 if skv >= 2048 else 100
        ms = _time_ms(torch, lambda: A.flash_attention_bwd(*args),
                      iters=iters, warmup=2)
        plain_ms = _time_ms(torch, lambda: A.flash_attention_bwd_reference(
            *args), iters=iters, warmup=1)
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (tq, tk, tv)]
        out = A.attention_reference(*leaves, kv_mask=mask, causal=causal)
        ref_ms = _time_ms(torch, lambda: torch.autograd.grad(
            out, leaves, tdo, retain_graph=True), iters=iters, warmup=1)
        del out, leaves
        lib_fwd, lib_bwd, backend = _time_sdpa(torch, tq, tk, tv, mask,
                                               causal, tdo, iters)
        pairs = _pairs(mask, b, sq, skv, h, causal)
        # read q, o, dO, k, v, the mask and LSE; write dq, dk, dv
        elem = tq.element_size()
        side = mask.numel() * 4 + lse.numel() * 4
        nbytes = (4 * tq.numel() + 4 * tk.numel()) * elem + side
        bound_ms, bound_by = _bound(nbytes, 10 * pairs * d)
        before = CUDA_CORE_FLASH_BWD_MS[name]
        log("time flash bwd %-16s bfloat16 kernels %.4f ms (earlier "
            "CUDA-core walk %.4f ms, %.2fx; %.2f TFLOP/s on 10 x pairs x D; "
            "bound %.4f ms by %s); plain twin %.4f ms; autograd through "
            "attention_reference %.4f ms; SDPA backward %.4f ms, forward + "
            "backward %.4f ms (%s)"
            % (name, ms, before, before / ms, 10 * pairs * d / ms / 1e9,
               bound_ms, bound_by, plain_ms, ref_ms, lib_bwd,
               lib_fwd + lib_bwd, backend))
        split = _flash_bwd_split(torch, A, args)
        log("profile flash bwd %-16s pre-pass %.4f ms, tensor-core dK/dV "
            "%.4f ms, tensor-core dQ %.4f ms, sum %.4f ms per call (device "
            "time; no CUDA-core walk in the trace)"
            % (name, split["pre"], split["dkdv"], split["dq"],
               sum(split.values())))
        parts = None
        if name == KERNEL_LINE_CASE["flash_attention_bwd_dkdv"]:
            parts = {"dkdv": split["pre"] + split["dkdv"], "dq": split["dq"]}
        # each entry's own work, from q, o, dO, k, v, the mask and LSE:
        # dK/dV needs Q K^T, dO V^T, P^T dO, dS^T Q and writes dk, dv; dQ
        # needs Q K^T, dO V^T, dS K and writes dq. plain_ms and library_ms
        # are the whole backward's (one call computes all three).
        for entry, part, n_mm, written in (
                ("flash_attention_bwd_dkdv", "dkdv", 4, 2 * tk.numel()),
                ("flash_attention_bwd_dq", "dq", 3, tq.numel())):
            if parts is None:
                continue
            part_bytes = (3 * tq.numel() + 2 * tk.numel() + written) * elem \
                + side
            b_ms, b_by = _bound(part_bytes, 2 * n_mm * pairs * d)
            timings[(entry, name, torch.bfloat16)] = dict(
                ms=parts[part], plain_ms=plain_ms, library_ms=lib_bwd,
                bound_ms=b_ms, bound_by=b_by)
        del q, k, v, do, tq, tk, tv, tdo, o, lse, args
        torch.cuda.empty_cache()
    return worst


def _bwd_bf16_ratios(torch, A, args, got, want):
    """(largest error over its bound, the same for autograd through bf16
    attention_reference) of a bf16 attention backward against the f32
    twin's `want`, the bound 1e-5 + 2^-8 |g| + 2.5 x 2^-8 R with R from
    flash_attention_bwd_rss given the forward twin's LSE `lse` (derived
    beside FLASH_BWD_RSS_BF16). args: (q, k, v, mask, o, lse, dO, causal)."""
    tq, tk, tv, mask, o, lse, tdo, causal = args
    rss = A.flash_attention_bwd_rss(tq.float(), tk.float(), tv.float(), mask,
                                    o.float(), lse, tdo.float(), causal)
    leaves = [t.detach().clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = A.attention_reference(*leaves, kv_mask=mask, causal=causal)
    plain = torch.autograd.grad(out, leaves, tdo)
    del out, leaves
    kernel_ratio, plain_ratio = 0.0, 0.0
    for g, a, w, r in zip(got, plain, want, rss):
        bound = FLASH_BWD_ATOL_BF16 + FLASH_BWD_RTOL_BF16 * w.abs() \
            + FLASH_BWD_RSS_BF16 * r
        kernel_ratio = max(kernel_ratio,
                           ((g.float() - w).abs() / bound).max().item())
        plain_ratio = max(plain_ratio,
                          ((a.float() - w).abs() / bound).max().item())
    return kernel_ratio, plain_ratio


def _check_bwd(torch, A, rng, name, q, k, v, mask, causal, worst):
    """The short backward kernel against its f32 twin, f32 and bf16, in both
    layouts; two runs on the same inputs must give the same bits. f32 (the
    CUDA-core walk) within 2e-5 + 1e-5 |g|; bf16 (the tensor-core routes)
    within the flash backward's bound, which autograd through bf16
    attention_reference must exceed on the same inputs."""
    import numpy as np
    do = torch.from_numpy(rng.standard_normal(tuple(q.shape)).astype(
        np.float32)).to(q.device)
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv, tdo = (t.to(dtype) for t in (q, k, v, do))
        if dtype == torch.bfloat16:
            _, lse = A.flash_attention_fwd_reference(
                tq.float(), tk.float(), tv.float(), mask, causal)
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
                excess = max(excess, (diff - BWD_ATOL_F32 - BWD_RTOL_F32
                                      * w.abs()).max().item())
            if dtype == torch.float32:
                ok = excess <= 0
                log("check bwd %-18s float32  %-4s max_abs_err %.3e (bound "
                    "%.1e + %.1e |g|) %s" % (name, layout, err, BWD_ATOL_F32,
                                             BWD_RTOL_F32,
                                             "ok" if ok else "FAIL"))
            else:
                ratio, plain_ratio = _bwd_bf16_ratios(
                    torch, A, (tq, tk, tv, mask, o, lse, tdo, causal), got,
                    want)
                ok = ratio <= 1 and plain_ratio >= 1
                log("check bwd %-18s bfloat16 %-4s max_abs_err %.3e; largest "
                    "error / bound (%.0e + 2^-8 |g| + %.1f x 2^-8 R): kernel "
                    "%.3f (route %d), autograd through bf16 "
                    "attention_reference %.3f (must be >= 1) %s"
                    % (name, layout, err, FLASH_BWD_ATOL_BF16,
                       FLASH_BWD_RSS_BF16 / 2 ** -8, ratio,
                       A._short_bwd_route(dtype, tq.shape[1], tk.shape[1]),
                       plain_ratio, "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("backward kernel disagrees with its "
                                     "plain version, or the bf16 bound is "
                                     "looser than the plain path's error: "
                                     "%s %s %s err %.3e"
                                     % (name, dtype, layout, err))
            again = A.short_attention_bwd(*args, mask, o, g_in, causal)
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                raise AssertionError("%s %s %s: two backward runs differ"
                                     % (name, dtype, layout))
            worst[(name, dtype)] = max(worst.get((name, dtype), 0.0), err)
    log("check bwd %-18s two runs on the same inputs give the same bits"
        % name)


def _short_bwd_names(torch, A, dtype, sq, skv):
    """The (part, kernel name) pairs a bf16 short backward's route launches
    (none for f32, whose backward phase 2 does not profile)."""
    if dtype != torch.bfloat16:
        return ()
    return (SHORT_BWD_ONE_BLOCK_NAMES if A._short_bwd_route(dtype, sq, skv)
            == 1 else SHORT_BWD_FLASH_ROUTE_NAMES)


def _time_bwd(torch, A, name, tq, tk, tv, mask, causal, o, do, library_ms,
              times):
    """Backward kernel, its twin, and autograd through attention_reference
    (backward only, from a graph kept alive), from the forward's o and dO;
    CUDA events. library_ms: the SDPA backward at the same shape. bf16: the
    split by kernel of the profiler session `times` (_device_ms), which must
    hold the route's tensor-core kernels and no CUDA-core walk, and the
    earlier CUDA-core walk's time beside."""
    b, sq, h, d = tq.shape
    skv = tk.shape[1]
    ms = _time_ms(torch, lambda: A.short_attention_bwd(
        tq, tk, tv, mask, o, do, causal))
    plain_ms = _time_ms(torch, lambda: A.short_attention_bwd_reference(
        tq, tk, tv, mask, o, do, causal))
    leaves = [t.detach().clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = A.attention_reference(*leaves, kv_mask=mask, causal=causal)
    ref_ms = _time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True))
    del out, leaves
    nbytes = 8 * tq.numel() * tq.element_size() + mask.numel() * 4
    flops = 10 * _pairs(mask, b, sq, skv, h, causal) * d
    bound_ms, bound_by = _bound(nbytes, flops)
    extra = ""
    if tq.dtype == torch.bfloat16:
        route = A._short_bwd_route(tq.dtype, sq, skv)
        names = _short_bwd_names(torch, A, tq.dtype, sq, skv)
        split = _routed("the bf16 short backward at %s" % name, times,
                        names, SHORT_BWD_CUDA_CORE_NAMES)
        log("profile bwd %-12s bfloat16 route %d: %s, sum %.4f ms per call "
            "(device time; no CUDA-core walk in the trace)"
            % (name, route, ", ".join("%s %.4f ms" % (part, split[part])
                                      for part, _ in names),
               sum(split.values())))
        if name in CUDA_CORE_SHORT_BWD_MS:
            before = CUDA_CORE_SHORT_BWD_MS[name]
            extra = " (the CUDA-core walk before: %.4f ms, %.2fx)" % (
                before, before / ms)
    log("time bwd %-12s %-8s kernel %.4f ms%s (%.1f GB/s = %.1f%% of "
        "3.35 TB/s, %.2f TFLOP/s on the visible pairs; bound %.4f ms by %s); "
        "plain twin %.4f ms; autograd through attention_reference %.4f ms; "
        "SDPA backward %.4f ms"
        % (name, str(tq.dtype).split(".")[1], ms, extra, nbytes / ms / 1e6,
           100 * nbytes / (ms * 1e-3) / PEAK_BYTES_PER_S, flops / ms / 1e9,
           bound_ms, bound_by, plain_ms, ref_ms, library_ms))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


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


def device_share(trace_path):
    """(device busy share, device busy ms, [(kernel, ms), ...] longest
    first) from a torch.profiler Chrome trace: the union of the device
    kernels' intervals over the span from the first kernel's start to the
    last one's end (so the profiler's own start-up is not counted as
    idle)."""
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
                                           key=lambda kv: -kv[1])


def attention_ms(by_kernel, steps):
    """'name ms; ...': the device ms per step of each attention kernel that
    ran, from device_share's list over `steps` steps."""
    return "; ".join("%s %.3f" % (name, sum(t for n, t in by_kernel
                                            if name in n) / steps)
                     for name in ATTENTION_KERNEL_NAMES
                     if any(name in n for n, _ in by_kernel))


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
            "device ms by kernel over the 4 steps: %s; attention kernels, "
            "device ms per step: %s"
            % (100 * share, busy_ms / 4, "; ".join(
                "%s %.3f" % (n[:60], t) for n, t in top[:8]),
               attention_ms(top, 4)))
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
                "%s %.3f" % (n[:60], t) for n, t in top[:8])))
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


# --------------------------------------------------------------------------
# phase 6: BART-base seq2seq fine-tuning and evaluation
# --------------------------------------------------------------------------

BART_BASE = {  # HF facebook/bart-base config.json, dropout set to 0
    "model_type": "bart", "architectures": ["BartModel"],
    "vocab_size": 50265, "d_model": 768, "encoder_layers": 6,
    "decoder_layers": 6, "encoder_attention_heads": 12,
    "decoder_attention_heads": 12, "encoder_ffn_dim": 3072,
    "decoder_ffn_dim": 3072, "max_position_embeddings": 1024,
    "activation_function": "gelu", "dropout": 0.0, "attention_dropout": 0.0,
    "activation_dropout": 0.0, "init_std": 0.02, "scale_embedding": False,
    "normalize_before": False, "add_final_layer_norm": False,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2,
    "decoder_start_token_id": 2, "forced_eos_token_id": 2,
    "is_encoder_decoder": True,
}
BART_MODEL_DIR = "bart-base-random"
BART_SEQ_LEN = 1024        # --sequence_length: sources are truncated here
BART_TARGET_TOKENS = 64    # the dataset's max_target_length (JAX default)
BART_BATCH = 8
BART_STEPS = 8
BART_DEV_ROWS = 16
BART_LR = 5e-5
# Training, kernel run against the --use_flash_attention=false run, per-step
# loss: both are bf16 end to end and differ only in attention's rounding
# (the plain path rounds max-subtracted scores and probabilities to bf16,
# the tensor-core kernels keep the scores f32 and round P and dS once),
# about a bf16 ulp (2^-8 relative) per layer
# through 12 layers, compounded over 8 AdamW steps. The loss is a mean over
# ~500 target tokens near ln(50265) = 10.8, where a 1e-2 relative logit
# change moves it by ~1e-2. Bound 5e-2.
BART_LOSS_ATOL = 5e-2


def bart_vocab():
    """(tokens in id order, merges): the synthetic GPT-2 vocabulary of
    gpt2_vocab() (<|endoftext|> at 50256, the EOS and pad token of the GPT-2
    tokenizer that BART checkpoints get), extended to BART's 50265 entries
    with BART's own specials."""
    tokens, merges = gpt2_vocab()
    tokens += ["<s>", "<pad>", "</s>", "<unk>", "<mask>", "<extra_0>",
               "<extra_1>", "<extra_2>"]
    assert len(tokens) == BART_BASE["vocab_size"]
    return tokens, merges


def make_bart_model_dir(torch, path, seed):
    """BART-base widths and depth, the synthetic vocabulary, and
    truncated-normal(0.02) weights from numpy under HF names (`model.`
    prefix, shared/embed_tokens/lm_head tied, final_logits_bias [1,V]),
    zero biases, unit LayerNorms."""
    import numpy as np
    os.makedirs(path, exist_ok=True)
    c = BART_BASE
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f, indent=2)
    tokens, merges = bart_vocab()
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join("%s %s\n" % m for m in merges))
    rng = np.random.default_rng(seed)
    e, ffn = c["d_model"], c["encoder_ffn_dim"]
    state = {}

    def put(name, *shape, fill=None):
        arr = (np.full(shape, fill, np.float32) if fill is not None
               else _truncated_normal(rng, shape, c["init_std"]))
        state[name] = torch.from_numpy(arr)

    put("model.shared.weight", c["vocab_size"], e)
    for side, n in (("encoder", c["encoder_layers"]),
                    ("decoder", c["decoder_layers"])):
        pre = "model.%s." % side
        state[pre + "embed_tokens.weight"] = state["model.shared.weight"]
        put(pre + "embed_positions.weight", c["max_position_embeddings"] + 2,
            e)
        put(pre + "layernorm_embedding.weight", e, fill=1.0)
        put(pre + "layernorm_embedding.bias", e, fill=0.0)
        attns = ("self_attn", "encoder_attn") if side == "decoder" \
            else ("self_attn",)
        for i in range(n):
            lp = pre + "layers.%d." % i
            for attn in attns:
                for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    put(lp + "%s.%s.weight" % (attn, proj), e, e)
                    put(lp + "%s.%s.bias" % (attn, proj), e, fill=0.0)
                put(lp + attn + "_layer_norm.weight", e, fill=1.0)
                put(lp + attn + "_layer_norm.bias", e, fill=0.0)
            put(lp + "fc1.weight", ffn, e)
            put(lp + "fc1.bias", ffn, fill=0.0)
            put(lp + "fc2.weight", e, ffn)
            put(lp + "fc2.bias", e, fill=0.0)
            put(lp + "final_layer_norm.weight", e, fill=1.0)
            put(lp + "final_layer_norm.bias", e, fill=0.0)
    state["lm_head.weight"] = state["model.shared.weight"]
    put("final_logits_bias", 1, c["vocab_size"], fill=0.0)
    torch.save(state, os.path.join(path, "pytorch_model.bin"))


def make_bart_tsv(path, tokenizer, seed, n_rows, article_tokens=1100,
                  summary_tokens=70):
    """n_rows of (id, article, summary): articles of random lowercase words
    past article_tokens tokens (truncated to 1024 by the dataset), summaries
    past summary_tokens (truncated to 63 + EOS). Words come from a fixed
    list of 4000, so the tokenizer's cache serves most of them."""
    rng = random.Random(seed)
    words = ["".join(rng.choice(GEN_LETTERS) for _ in range(rng.randint(2, 9)))
             for _ in range(4000)]
    cost = {w: len(tokenizer.tokenize(" " + w)) for w in words}

    def text(target):
        out, n = [], 0
        while n < target:
            w = rng.choice(words)
            out.append(w)
            n += cost[w]
        return " ".join(out)

    with open(path, "w", encoding="utf-8") as f:
        for i in range(n_rows):
            f.write("%d\t%s\t%s\n" % (i, text(article_tokens),
                                        text(summary_tokens)))


def _bart_argv(use_kernel):
    return ["--app_name=sequence_generation", "--device=cuda",
            "--dtype=bfloat16", "--sequence_length=%d" % BART_SEQ_LEN,
            "--micro_batch_size=%d" % BART_BATCH,
            "--input_schema=id:str:1,article:str:1,summary:str:1",
            "--first_sequence=article", "--second_sequence=summary",
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false")]


def run_bart_train(torch, model_dir, train_tsv, ckpt, use_kernel, seed,
                   profile_dir=None):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    argv = ["--mode=train", "--tables=" + train_tsv,
            "--pretrained_model_name_or_path=" + model_dir,
            "--epoch_num=1", "--learning_rate=%g" % BART_LR,
            "--optimizer_type=AdamW", "--logging_steps=1",
            "--random_seed=%d" % seed] + _bart_argv(use_kernel)
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
    return {"records": trainer.step_records,
            "save_s": trainer.save_seconds,
            "skips": trainer.nonfinite_skips,
            "total_s": time.perf_counter() - t0,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}


def run_bart_evaluate(torch, ckpt, dev_tsv, use_kernel):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = default_main_fn(initialize_easynlp(args_list=[
        "--mode=evaluate", "--tables=" + dev_tsv, "--checkpoint_dir=" + ckpt]
        + _bart_argv(use_kernel)))
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def phase_bart(torch, seed, workdir):
    import numpy as np
    from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 6: BART-base seq2seq fine-tuning (sequence_generation "
        "train, evaluate)")
    model_dir = os.path.join(workdir, BART_MODEL_DIR)
    t0 = time.perf_counter()
    make_bart_model_dir(torch, model_dir, seed)
    tokenizer = GPT2Tokenizer.from_pretrained(model_dir)
    train_tsv = os.path.join(workdir, "bart_train.tsv")
    dev_tsv = os.path.join(workdir, "bart_dev.tsv")
    make_bart_tsv(train_tsv, tokenizer, seed + 5, BART_BATCH * BART_STEPS)
    make_bart_tsv(dev_tsv, tokenizer, seed + 6, BART_DEV_ROWS)
    with open(train_tsv, encoding="utf-8") as f:
        first = f.readline().rstrip("\n").split("\t")
    n_src = len(tokenizer.tokenize(first[1]))
    n_tgt = len(tokenizer.tokenize(first[2]))
    log("BART-base model dir (%d-token vocab) and %d + %d article rows made "
        "from seed %d in %.3f s; row 0: %d article tokens (truncated to %d), "
        "%d summary tokens (truncated to %d with EOS)"
        % (BART_BASE["vocab_size"], BART_BATCH * BART_STEPS, BART_DEV_ROWS,
           seed, time.perf_counter() - t0, n_src, BART_SEQ_LEN, n_tgt,
           BART_TARGET_TOKENS))
    if n_src <= BART_SEQ_LEN or n_tgt < BART_TARGET_TOKENS:
        raise AssertionError("articles must pass %d tokens and summaries %d"
                             % (BART_SEQ_LEN, BART_TARGET_TOKENS))
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")

    def counts():
        return {w: getattr(A, w).launches for w in wrappers}

    ckpt = os.path.join(workdir, "bart_ckpt")

    # the main path: every count set to 0 just before, read just after
    for w in wrappers:
        getattr(A, w).launches = 0
    runs = {"kernel": [run_bart_train(torch, model_dir, train_tsv, ckpt,
                                      True, seed)]}
    launches = counts()
    layers = BART_BASE["encoder_layers"]
    want = {"flash_attention_fwd": 2 * layers * BART_STEPS,
            "flash_attention_bwd": 2 * layers * BART_STEPS,
            "short_attention_fwd": layers * BART_STEPS,
            "short_attention_bwd": layers * BART_STEPS}
    log("BART training path launches: %s (want %s: per step 12 flash "
        "forward and backward = 6 encoder self-attention + 6 cross-attention "
        "layers, 6 short forward and backward = the decoder's causal "
        "self-attention, x %d steps)" % (launches, want, BART_STEPS))
    if launches != want:
        raise AssertionError("the BART training path launched %s, want %s"
                             % (launches, want))
    runs["plain"] = []
    # the rest in turns on the same card: K P P K, the first K above
    for use_kernel in (False, False, True):
        before = counts()
        runs["kernel" if use_kernel else "plain"].append(run_bart_train(
            torch, model_dir, train_tsv, None, use_kernel, seed))
        if not use_kernel and counts() != before:
            raise AssertionError("--use_flash_attention=false still "
                                 "launched a kernel")
    for tag in ("kernel", "plain"):
        for i, run in enumerate(runs[tag]):
            recs = run["records"]
            ms = [1e3 * r["seconds"] for r in recs]
            log("bart %-7s %d steps x %d rows of %d + %d tokens: step ms "
                "median %.3f, first %.3f, min %.3f, max %.3f (host clock, "
                "each step ends in the guard's read-back); %.2f samples/s at "
                "the median; run with load and checkpoint %.3f s; peak device "
                "memory %.3f GiB above the run's start; losses %s"
                % ("%s#%d" % (tag, i + 1), len(ms), BART_BATCH, BART_SEQ_LEN,
                   BART_TARGET_TOKENS, statistics.median(ms), ms[0], min(ms),
                   max(ms), 1e3 * BART_BATCH / statistics.median(ms),
                   run["total_s"], run["peak_gib"],
                   " ".join("%.4f" % r["loss"] for r in recs)))
            if len(recs) != BART_STEPS or run["skips"]:
                raise AssertionError("%s run: %d steps, %d non-finite skips"
                                     % (tag, len(recs), run["skips"]))
            if not all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                       for r in recs):
                raise AssertionError("%s run: non-finite loss or grad norm"
                                     % tag)
    rec_k, rec_p = runs["kernel"][0]["records"], runs["plain"][0]["records"]
    d_loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(rec_k, rec_p))
    d_gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                  for a, b in zip(rec_k, rec_p))
    log("kernel vs plain BART training run: max |d loss| per step %.3e "
        "(bound %.1e); max relative grad-norm gap %.3e"
        % (d_loss, BART_LOSS_ATOL, d_gnorm))
    if d_loss > BART_LOSS_ATOL:
        raise AssertionError("kernel and plain BART training runs disagree: "
                             "loss gap %.3e" % d_loss)
    medians = {tag: [statistics.median(r["seconds"] for r in run["records"]
                                       [1:]) for run in runs[tag]]
               for tag in runs}
    for tag, values in medians.items():
        log("bart %-6s step ms (steps 2-8), median per run: %s; median of "
            "runs %.3f (%.2f samples/s); peak device memory %s GiB"
            % (tag, " ".join("%.3f" % (1e3 * v) for v in values),
               1e3 * statistics.median(values),
               BART_BATCH / statistics.median(values),
               " ".join("%.3f" % r["peak_gib"] for r in runs[tag])))

    # evaluate on the kernel run's checkpoint: greedy, 64 tokens at most
    evals = {}
    for use_kernel in (True, False):
        before = counts()
        results, seconds = run_bart_evaluate(torch, ckpt, dev_tsv, use_kernel)
        used = {w: counts()[w] - before[w] for w in wrappers}
        evals[use_kernel] = results
        scores = [x for _, x in results]
        log("bart evaluate %-6s %d rows: %s in %.3f s; launches %s"
            % ("kernel" if use_kernel else "plain", BART_DEV_ROWS,
               ", ".join("%s %.6f" % kv for kv in results), seconds, used))
        if [m for m, _ in results] != ["bleu", "rouge_l"] or not all(
                np.isfinite(x) and 0.0 <= x <= 1.0 for x in scores):
            raise AssertionError("BART evaluate: %s" % results)
        if use_kernel and not (used["flash_attention_fwd"]
                               and used["short_attention_fwd"]):
            raise AssertionError("BART evaluate did not launch the forward "
                                 "kernels: %s" % used)
        if not use_kernel and any(used.values()):
            raise AssertionError("--use_flash_attention=false evaluate "
                                 "launched a kernel: %s" % used)

    # With random weights and the head tied to the decoder's embedding, the
    # first step predicts the start token again, which is BART's EOS (2),
    # so evaluate stops after one step. Drive the decode loop through all
    # 64 positions as well: the app's greedy generate with EOS banned
    # (min_length), on the same 16 sources, kernel and plain.
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    app = SequenceGeneration.from_pretrained(ckpt, dtype=torch.bfloat16,
                                             device="cuda")
    with open(dev_tsv, encoding="utf-8") as f:
        texts = [line.split("\t")[1] for line in f]
    enc = tokenizer(texts, max_length=BART_SEQ_LEN)
    gen = {}
    for use_kernel in (True, False):
        A.set_kernel_override(None if use_kernel else False)
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen[use_kernel] = np.concatenate([app.generate(
            enc["input_ids"][s:s + BART_BATCH],
            enc["attention_mask"][s:s + BART_BATCH],
            max_length=BART_TARGET_TOKENS,
            min_length=BART_TARGET_TOKENS).cpu().numpy()
            for s in range(0, BART_DEV_ROWS, BART_BATCH)])
        seconds = time.perf_counter() - t0
        used = {w: counts()[w] - before[w] for w in wrappers}
        batches = BART_DEV_ROWS // BART_BATCH
        calls = BART_TARGET_TOKENS - 1  # the start token's, then 62 decodes
        want = {"short_attention_fwd": batches * layers * calls,
                "flash_attention_fwd": batches * layers * (1 + calls),
                "short_attention_bwd": 0, "flash_attention_bwd": 0}
        if not use_kernel:
            want = dict.fromkeys(wrappers, 0)
        log("bart generate %-6s %d rows x %d positions, greedy, EOS banned: "
            "%.3f s (%.3f ms per position of %d rows, encoder included, "
            "host clock); "
            "launches %s (want %s: per batch the encoder's 6 flash forwards, "
            "and per decoder step 6 flash cross-attention forwards over "
            "1024 keys and 6 short self-attention forwards over the %d-slot "
            "cache)" % ("kernel" if use_kernel else "plain", BART_DEV_ROWS,
                        BART_TARGET_TOKENS, seconds,
                        1e3 * seconds / (batches * calls), BART_BATCH, used,
                        want, BART_TARGET_TOKENS))
        if used != want:
            raise AssertionError("BART generate launched %s, want %s"
                                 % (used, want))
        if gen[use_kernel].shape != (BART_DEV_ROWS, BART_TARGET_TOKENS) or \
                gen[use_kernel].min() < 0 or \
                gen[use_kernel].max() >= BART_BASE["vocab_size"]:
            raise AssertionError("BART generate gave %s ids in [%d, %d]" % (
                gen[use_kernel].shape, gen[use_kernel].min(),
                gen[use_kernel].max()))
    A.set_kernel_override(None)
    same = (gen[True] == gen[False]).all(axis=1)
    first = [int(np.argmin(a == b)) if not s else BART_TARGET_TOKENS
             for a, b, s in zip(gen[True], gen[False], same)]
    log("bart generate kernel vs plain: %d of %d rows identical; first "
        "differing position per row %s (random 0.02-std weights give "
        "near-uniform logits, so near-ties split the two runs)"
        % (int(same.sum()), BART_DEV_ROWS, first))
    del app

    # one more kernel run under torch.profiler (steps 3-6), for the device's
    # share of the step; its step times are not reported
    prof = os.path.join(workdir, "bart_profile")
    run_bart_train(torch, model_dir, train_tsv, None, True, seed,
                   profile_dir=prof)
    share, busy_ms, top = device_share(os.path.join(prof, "trace.json"))
    if share is None:
        log("profile: the trace holds no device kernels (not measured)")
    else:
        log("profile, BART kernel run, steps 3-6 (under the profiler): "
            "device busy %.1f%% of the span of its kernels, %.3f ms busy per "
            "step; device ms by kernel over the 4 steps: %s; attention "
            "kernels, device ms per step: %s"
            % (100 * share, busy_ms / 4, "; ".join(
                "%s %.3f" % (n[:60], t) for n, t in top[:8]),
               attention_ms(top, 4)))
    launches["flash_attention_bwd_dkdv"] = launches["flash_attention_bwd"]
    launches["flash_attention_bwd_dq"] = launches["flash_attention_bwd"]
    return launches


# --------------------------------------------------------------------------
# phase 7: BART-base predict
# --------------------------------------------------------------------------

BART_PREDICT_UDP = {  # EOS banned so every row decodes all 63 positions
    "greedy": "max_decoder_length=%d min_decoder_length=%d"
              % (BART_TARGET_TOKENS, BART_TARGET_TOKENS),
    "beam": "max_decoder_length=%d min_decoder_length=%d num_beams=4"
            % (BART_TARGET_TOKENS, BART_TARGET_TOKENS)}


def run_bart_predict(torch, ckpt, tsv, out, use_kernel, udp):
    """--mode=predict --app_name=sequence_generation on a BART checkpoint
    through the CLI entry; (the run's summary, generated_ids [N, T])."""
    import numpy as np
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    argv = ["--mode=predict", "--tables=" + tsv, "--outputs=" + out,
            "--checkpoint_dir=" + ckpt, "--output_schema=generated_ids",
            "--append_cols=id", "--user_defined_parameters=" + udp] \
        + _bart_argv(use_kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manager = default_main_fn(initialize_easynlp(args_list=argv))
    total = time.perf_counter() - t0
    with open(out, encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    if any(len(r) != 2 for r in rows) or [r[1] for r in rows] != [
            str(i) for i in range(len(rows))]:
        raise AssertionError("%s does not parse as generated_ids, id rows"
                             % out)
    ids = np.array([[int(x) for x in r[0].split()] for r in rows])
    return {"rows": manager.n_rows, "run_s": manager.seconds,
            "with_load_s": total, "predictor": manager.predictor,
            "batch_s": list(manager.predictor.batch_seconds)}, ids


def phase_bart_predict(torch, seed, workdir):
    import numpy as np
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
        make_encoder_decoder_fns)
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 7: BART-base predict (sequence_generation predict on "
        "phase 6's checkpoint)")
    ckpt = os.path.join(workdir, "bart_ckpt")
    tsv = os.path.join(workdir, "bart_dev.tsv")
    layers, n = BART_BASE["decoder_layers"], BART_DEV_ROWS
    batches, calls = n // BART_BATCH, BART_TARGET_TOKENS - 1
    wrappers = ("short_attention_fwd", "flash_attention_fwd")

    def counts():
        return {w: getattr(A, w).launches for w in wrappers}

    runs, ids = {}, {}
    # the main path: counts set to 0 just before, read just after
    for w in wrappers:
        getattr(A, w).launches = 0
    runs[("greedy", True)], ids[("greedy", True)] = run_bart_predict(
        torch, ckpt, tsv, os.path.join(workdir, "bart_pred_k.tsv"), True,
        BART_PREDICT_UDP["greedy"])
    launches = counts()
    want = {"short_attention_fwd": batches * layers * calls,
            "flash_attention_fwd": batches * layers * (1 + calls)}
    log("BART predict path launches: %s (want %s: per batch the encoder's "
        "6 flash forwards over 1024 keys, then per decoder position 6 flash "
        "cross-attention forwards (8 x 1 x 1024) and 6 short "
        "self-attention forwards over the 64-slot cache (8 x 1 x 64), "
        "%d positions after the start token's)" % (launches, want, calls))
    if launches != want:
        raise AssertionError("the BART predict path launched %s, want %s"
                             % (launches, want))
    for key in (("greedy", False), ("beam", True), ("beam", False)):
        before = counts()
        runs[key], ids[key] = run_bart_predict(
            torch, ckpt, tsv, os.path.join(workdir, "bart_pred_%s_%d.tsv"
                                           % key), key[1],
            BART_PREDICT_UDP[key[0]])
        used = {w: counts()[w] - before[w] for w in wrappers}
        if key[1] and (not all(used.values())
                       or any(v % layers for v in used.values())):
            raise AssertionError("the beam run launched %s" % used)
        if not key[1] and any(used.values()):
            raise AssertionError("--use_flash_attention=false launched %s"
                                 % used)
        if key == ("beam", True):
            log("BART 4-beam predict launches: %s (32 rows a batch)" % used)
    for key, r in runs.items():
        got = ids[key]
        if got.shape != (n, BART_TARGET_TOKENS) or got.min() < 0 or \
                got.max() >= BART_BASE["vocab_size"] or \
                (got[:, 0] != BART_BASE["decoder_start_token_id"]).any():
            raise AssertionError("BART predict %s: generated_ids %s" % (
                key, got.shape))
        tokens = n * calls
        log("bart predict %-6s %-6s %d rows, %d generated tokens in %.4f s "
            "= %.2f tokens/s (predict loop: read, tokenise, %d batches, "
            "write; %.4f s with model load); batch latency median %.3f ms "
            "(host clock)" % (key[0], "kernel" if key[1] else "plain", n,
                              tokens, r["run_s"], tokens / r["run_s"],
                              len(r["batch_s"]), r["with_load_s"],
                              1e3 * statistics.median(r["batch_s"])))
    # the predictor's text of each row: the tokens after the start column
    # (EOS banned, so no cut), empty only where all are special tokens
    predictor = runs[("greedy", True)]["predictor"]
    specials = set(predictor.tokenizer.all_special_ids)
    texts = [predictor._text(row, 0) for row in ids[("greedy", True)]]
    for row, text in zip(ids[("greedy", True)], texts):
        if text != predictor.tokenizer.decode(row[1:]) or bool(text) != any(
                int(t) not in specials for t in row[1:]):
            raise AssertionError("BART prediction text %r of %s" % (text,
                                                                     row))
    log("bart predict text: %d of %d greedy rows hold text; %d distinct "
        "tokens generated" % (sum(map(bool, texts)), n,
                              len(set(ids[("greedy", True)][:, 1:].ravel()))))

    # the plain greedy run's top-2 margins, teacher forcing its own tokens
    # (EOS banned as in the run), then the GPT-2 phase's rule
    app = SequenceGeneration.from_pretrained(ckpt, dtype=torch.bfloat16,
                                             device="cuda")
    with open(tsv, encoding="utf-8") as f:
        articles = [line.split("\t")[1] for line in f]
    enc = runs[("greedy", True)]["predictor"].tokenizer(
        articles, max_length=BART_SEQ_LEN)
    src = torch.from_numpy(enc["input_ids"]).cuda().long()
    src_mask = torch.from_numpy(enc["attention_mask"]).cuda()
    ids_k, ids_p = ids[("greedy", True)], ids[("greedy", False)]
    eos = BART_BASE["eos_token_id"]
    margins = []
    A.set_kernel_override(False)
    with torch.inference_mode():
        for s in range(0, n, BART_BATCH):
            dec = torch.from_numpy(ids_p[s:s + BART_BATCH, :-1]).cuda()
            logits = app.module(src[s:s + BART_BATCH],
                                src_mask[s:s + BART_BATCH],
                                decoder_input_ids=dec)["logits"].float()
            logits[..., eos] = -float("inf")
            top2 = logits.topk(2, dim=-1).values
            margins.append((top2[..., 0] - top2[..., 1]).cpu().numpy())
    A.set_kernel_override(None)
    margins = np.concatenate(margins)
    decided = compared = near_ties = 0
    for row in range(n):
        for j in range(1, BART_TARGET_TOKENS):
            a, b = ids_k[row, j], ids_p[row, j]
            if a != b:
                if margins[row, j - 1] > 2 * GEN_LOGITS_ATOL:
                    raise AssertionError(
                        "BART predict row %d position %d: kernel token %d, "
                        "plain %d, at a top-2 margin of %.3e > %.1e"
                        % (row, j, a, b, margins[row, j - 1],
                           2 * GEN_LOGITS_ATOL))
                near_ties += 1
                break
            compared += 1
            decided += margins[row, j - 1] > 2 * GEN_LOGITS_ATOL
    same_beam = (ids[("beam", True)] == ids[("beam", False)]).all(axis=1)
    log("bart predict kernel vs plain, greedy: tokens agree at all %d "
        "positions compared before a row's first divergence (%d of them at "
        "a plain teacher-forced top-2 margin > %.1e); %d rows diverge, each "
        "at a near-tie; %d of %d rows identical; 4 beams: %d of %d best "
        "beams identical" % (compared, decided, 2 * GEN_LOGITS_ATOL,
                             near_ties, int((ids_k == ids_p).all(1).sum()),
                             n, int(same_beam.sum()), n))

    # the profiler's word: one batch's generate runs B3 and B1 on the
    # tensor cores, and neither CUDA-core walk
    dev = _routed("BART-base greedy generate (8 rows)", _device_ms(
        torch, lambda: app.generate(src[:BART_BATCH], src_mask[:BART_BATCH],
                                    max_length=BART_TARGET_TOKENS,
                                    min_length=BART_TARGET_TOKENS), calls=1,
        want=(FLASH_FWD_MMA_NAME, SHORT_FWD_MMA_NAME)),
        (("B3", FLASH_FWD_MMA_NAME), ("B1", SHORT_FWD_MMA_NAME)),
        (FLASH_FWD_CUDA_CORE_NAME, SHORT_FWD_CUDA_CORE_NAME))
    log("profile BART predict, one batch of 8 x 64 positions: %s %.4f ms "
        "(encoder 6 x 8 x 1024 + cross 6 x 63 x 8 x 1 x 1024), %s %.4f ms "
        "(6 x 63 x 8 x 1 x 64) of device time; no CUDA-core walk"
        % (FLASH_FWD_MMA_NAME, dev["B3"], SHORT_FWD_MMA_NAME, dev["B1"]))

    # prefill and decode step times on one batch, kernel and plain in turns
    start = torch.full((BART_BATCH, 1), BART_BASE["decoder_start_token_id"],
                       dtype=torch.long, device=src.device)
    start_mask = torch.ones((BART_BATCH, 1), dtype=torch.int32,
                            device=src.device)
    prefill, decode = make_encoder_decoder_fns(
        app.module, BART_TARGET_TOKENS, src[:BART_BATCH],
        src_mask[:BART_BATCH])
    steps = {}
    for use_kernel in (True, False, False, True):
        A.set_kernel_override(None if use_kernel else False)
        pre, dec = _step_times(torch, prefill, decode, start, start_mask,
                               BART_TARGET_TOKENS - 2)
        steps.setdefault(use_kernel, ([], []))
        steps[use_kernel][0].extend(pre)
        steps[use_kernel][1].extend(dec)
    A.set_kernel_override(None)
    for use_kernel, (pre, dec) in steps.items():
        log("bart step %-6s batch %d x %d-token sources: prefill (encoder + "
            "start token) ms median %.3f (min %.3f, max %.3f, %d runs); "
            "decode ms per position median %.3f (min %.3f, max %.3f, %d "
            "steps against %d cache slots); host clock, each call ends in a "
            "synchronize" % ("kernel" if use_kernel else "plain", BART_BATCH,
                             BART_SEQ_LEN, statistics.median(pre), min(pre),
                             max(pre), len(pre), statistics.median(dec),
                             min(dec), max(dec), len(dec),
                             BART_TARGET_TOKENS))
    del app, prefill, decode
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------------------------------------
# phase 8: the BERT encoder apps
# --------------------------------------------------------------------------

ENCODER_MODEL_DIR = "bert-base-chinese-encoder"
TAGS = ("O", "B-PER", "I-PER", "B-LOC", "I-LOC", "B-ORG", "I-ORG")
MRC_SEQ_LEN, MRC_BATCH, MRC_ROWS, MRC_DEV_ROWS = 384, 16, 128, 32
# each app: its argv, the rows it trains on (None: predict only), its dev
# rows, batch and sequence length, the predictor's output columns and the
# forward outputs held kernel against plain
ENCODER_APPS = {
    "text_match": dict(
        argv=["--app_name=text_match",
              "--input_schema=id:str:1,a:str:1,b:str:1,label:str:1",
              "--first_sequence=a", "--second_sequence=b",
              "--label_name=label"],
        data="pairs", outputs="predictions,probabilities,logits",
        compare=("logits",)),
    "text_match_two_tower": dict(
        argv=["--app_name=text_match",
              "--input_schema=id:str:1,a:str:1,b:str:1,label:str:1",
              "--first_sequence=a", "--second_sequence=b",
              "--label_name=label",
              "--user_defined_parameters=two_tower=True"],
        data="pairs", outputs="predictions,similarity",
        compare=("similarity", "embeddings", "embeddings_b")),
    "sequence_labeling": dict(
        argv=["--app_name=sequence_labeling",
              "--input_schema=id:str:1,content:str:1,tags:str:1",
              "--first_sequence=content", "--label_name=tags"],
        data="tags", outputs="predictions", compare=("logits",)),
    "machine_reading_comprehension": dict(
        argv=["--app_name=machine_reading_comprehension",
              "--input_schema=qas_id:str:1,question:str:1,context:str:1,"
              "answer:str:1", "--first_sequence=question",
              "--second_sequence=context", "--label_name=answer"],
        data="mrc", outputs="predictions,best_answer",
        compare=("start_logits", "end_logits")),
    "vectorization": dict(
        argv=["--app_name=vectorization",
              "--input_schema=id:str:1,sentence:str:1,label:str:1",
              "--first_sequence=sentence"],
        data=None, outputs="predictions", compare=("embeddings",)),
}


def _cjk_text(rng, common, lo, hi):
    return "".join(rng.choice(common) for _ in range(rng.randint(lo, hi)))


def make_encoder_tsvs(workdir, cjk, seed):
    """{kind: (train tsv, dev tsv)} of generated CJK rows: sentence pairs
    with a match/other label; per-character BIO tags (no spaces, so each
    character is a token); MRC question, context (past 384 tokens for most
    rows) and an answer cut from the context, absent for every fourth."""
    rng = random.Random(seed)
    common = cjk[:3000]
    out = {}
    for kind, n_train, n_dev in (("pairs", N_ROWS, N_DEV_ROWS),
                                 ("tags", N_ROWS, N_DEV_ROWS),
                                 ("mrc", MRC_ROWS, MRC_DEV_ROWS)):
        paths = []
        for split, n in (("train", n_train), ("dev", n_dev)):
            path = os.path.join(workdir, "%s_%s.tsv" % (kind, split))
            with open(path, "w", encoding="utf-8") as f:
                for i in range(n):
                    if kind == "pairs":
                        row = (_cjk_text(rng, common, 8, 90),
                               _cjk_text(rng, common, 8, 90),
                               rng.choice(["match", "other"]))
                    elif kind == "tags":
                        text = _cjk_text(rng, common, 16, 200)
                        tags, prev = [], "O"
                        for _ in text:
                            r = rng.random()
                            if prev != "O" and r < 0.5:
                                tag = "I-" + prev[2:]
                            elif r < 0.75:
                                tag = "O"
                            else:
                                tag = rng.choice(TAGS[1::2])
                            tags.append(tag)
                            prev = tag
                        row = (text, " ".join(tags))
                    else:
                        context = _cjk_text(rng, common, 150, 600)
                        at = rng.randint(0, min(len(context), 330) - 8)
                        answer = context[at:at + rng.randint(2, 8)]
                        if i % 4 == 3:
                            answer = _cjk_text(rng, common, 2, 8)
                        row = (_cjk_text(rng, common, 4, 16), context,
                               answer)
                    f.write("%s%d\t%s\n" % ("q" if kind == "mrc" else "", i,
                                            "\t".join(row)))
            paths.append(path)
        out[kind] = tuple(paths)
    return out


def make_encoder_model_dir(torch, workdir):
    """phase 3's BERT-base directory without its 2-way classifier head (a
    pretrained backbone, as the apps start from)."""
    import shutil
    src = os.path.join(workdir, MODEL_DIR)
    dst = os.path.join(workdir, ENCODER_MODEL_DIR)
    os.makedirs(dst, exist_ok=True)
    for name in ("config.json", "vocab.txt"):
        shutil.copy(os.path.join(src, name), dst)
    state = torch.load(os.path.join(src, "pytorch_model.bin"),
                       weights_only=True)
    torch.save({k: v for k, v in state.items()
                if not k.startswith("classifier.")},
               os.path.join(dst, "pytorch_model.bin"))
    return dst


def _encoder_argv(name, use_kernel):
    mrc = name == "machine_reading_comprehension"
    return ENCODER_APPS[name]["argv"] + [
        "--device=cuda", "--dtype=bfloat16",
        "--sequence_length=%d" % (MRC_SEQ_LEN if mrc else SEQ_LEN),
        "--micro_batch_size=%d" % (MRC_BATCH if mrc else BATCH),
        "--use_flash_attention=%s" % ("auto" if use_kernel else "false")]


def _cli(torch, argv):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = default_main_fn(initialize_easynlp(args_list=argv))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _forward_outputs(torch, name, ckpt, tsv, keys):
    """({True: kernel outputs, False: plain outputs}, inputs): the app's
    forward outputs `keys` over every row of tsv after its predictor's
    preprocessing, in bf16 on the card, with the kernels and with
    attention_reference; and the predictor's preprocessed inputs."""
    import numpy as np
    from types import SimpleNamespace
    from easynlp_tpu_torch.appzoo import api
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.utils import parse_row_by_schema
    argv = dict(a.split("=", 1) for a in _encoder_argv(name, True))
    udp = dict(kv.split("=", 1) for kv in argv.get(
        "--user_defined_parameters", "").split() if kv)
    labels = os.path.join(ckpt, "label_mapping.json")
    n_labels = 2
    if os.path.exists(labels):
        with open(labels) as f:
            n_labels = max(len(json.load(f)), 2)
    app = api._resolve(api.MODEL_REGISTRY, argv["--app_name"], udp) \
        .from_pretrained(ckpt, args=SimpleNamespace(
            user_defined_parameters_dict=udp), dtype=torch.bfloat16,
            device="cuda", num_labels=n_labels)
    predictor = api._resolve(api.PREDICTOR_REGISTRY, argv["--app_name"],
                             udp)(
        model_dir=ckpt, app=app, first_sequence=argv["--first_sequence"],
        second_sequence=argv.get("--second_sequence"),
        sequence_length=int(argv["--sequence_length"]),
        batch_size=int(argv["--micro_batch_size"]))
    with open(tsv, encoding="utf-8") as f:
        rows = [parse_row_by_schema(line, argv["--input_schema"])
                for line in f if line.strip()]
    inputs = predictor.preprocess({k: [r[k] for r in rows] for k in rows[0]})
    bs = int(argv["--micro_batch_size"])
    outs = {}
    with torch.inference_mode():
        for use_kernel in (True, False):
            A.set_kernel_override(None if use_kernel else False)
            parts = []
            for s in range(0, len(rows), bs):
                batch = {k: torch.from_numpy(np.asarray(
                    inputs[k][s:s + bs], np.int32)).to(app.device)
                    for k in app.model_input_keys if k in inputs}
                res = app.forward(batch)
                parts.append({k: res[k].float().cpu().numpy() for k in keys})
            outs[use_kernel] = {k: np.concatenate([p[k] for p in parts])
                                for k in keys}
    A.set_kernel_override(None)
    del app
    return outs, inputs


def _span_margin(start, end, context, max_len=30):
    """(best span, its score's lead over the next span's) of the MRC
    predictor's search."""
    import numpy as np
    s_log = np.where(context, start, -1e30)
    e_log = np.where(context, end, -1e30)
    scores = sorted(((s_log[s] + e_log[e], (int(s), e))
                     for s in np.argsort(s_log)[-20:]
                     for e in range(s, min(s + max_len, len(e_log)))),
                    reverse=True)
    return scores[0][1], scores[0][0] - scores[1][0]


def _decided(name, plain, inputs):
    """Per output row, None where the plain run's margin does not decide
    the prediction (at most 2 x SLICE_ATOL), else the positions whose
    predicted labels it decides (sequence labeling) or True."""
    import numpy as np
    out = []
    for i in range(len(next(iter(plain.values())))):
        if name == "text_match":
            lg = plain["logits"][i]
            out.append(True if abs(lg[0] - lg[1]) > 2 * SLICE_ATOL else None)
        elif name == "text_match_two_tower":
            out.append(True if abs(plain["similarity"][i] - 0.5)
                       > 2 * SLICE_ATOL else None)
        elif name == "sequence_labeling":
            top2 = np.sort(plain["logits"][i], axis=-1)[:, -2:]
            firsts = inputs["_first_positions"][i]
            out.append([j for j, pos in enumerate(firsts)
                        if top2[pos, 1] - top2[pos, 0] > 2 * SLICE_ATOL])
        elif name == "machine_reading_comprehension":
            _, lead = _span_margin(plain["start_logits"][i],
                                   plain["end_logits"][i],
                                   inputs["token_type_ids"][i] == 1)
            out.append(True if lead > 4 * SLICE_ATOL else None)
        else:
            out.append(None)
    return out


def phase_encoder_apps(torch, seed, workdir, cjk):
    import numpy as np
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 8: the encoder apps (text_match, sequence_labeling, "
        "machine_reading_comprehension, vectorization; BERT-base)")
    t0 = time.perf_counter()
    model_dir = make_encoder_model_dir(torch, workdir)
    tsvs = make_encoder_tsvs(workdir, cjk, seed + 11)
    tsvs[None] = (None, os.path.join(workdir, "predict.tsv"))
    log("BERT-base backbone directory and app TSVs made in %.3f s"
        % (time.perf_counter() - t0))
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")

    def counts():
        return {w: getattr(A, w).launches for w in wrappers}

    all_launches = {}
    for name, spec in ENCODER_APPS.items():
        t_app = time.perf_counter()
        train_tsv, dev_tsv = tsvs[spec["data"]]
        mrc = name == "machine_reading_comprehension"
        towers = 2 if name == "text_match_two_tower" else 1
        ckpt = model_dir
        steps = eval_batches = 0
        if train_tsv:
            steps = (MRC_ROWS // MRC_BATCH) if mrc else N_ROWS // BATCH
            eval_batches = -(-(MRC_DEV_ROWS if mrc else N_DEV_ROWS)
                             // (MRC_BATCH if mrc else BATCH))
            ckpt = os.path.join(workdir, "ckpt_" + name)
            trained = {}
            for use_kernel in (True, False):
                # the main path: counts set to 0 just before, read after
                for w in wrappers:
                    getattr(A, w).launches = 0
                argv = ["--mode=train", "--tables=%s,%s" % (train_tsv,
                                                            dev_tsv),
                        "--pretrained_model_name_or_path=" + model_dir,
                        "--epoch_num=1", "--learning_rate=%g" % LEARNING_RATE,
                        "--optimizer_type=AdamW", "--logging_steps=1",
                        "--random_seed=%d" % seed] \
                    + (["--checkpoint_dir=" + ckpt] if use_kernel else []) \
                    + _encoder_argv(name, use_kernel)
                trainer, secs = _cli(torch, argv)
                trained[use_kernel] = trainer.step_records
                used = counts()
                if len(trainer.step_records) != steps \
                        or trainer.nonfinite_skips:
                    raise AssertionError("%s: %d steps, %d skips" % (
                        name, len(trainer.step_records),
                        trainer.nonfinite_skips))
                ms = [1e3 * r["seconds"] for r in trainer.step_records]
                log("%s train %-6s %d steps: step ms median %.3f (min %.3f, "
                    "max %.3f; host clock); run with load, evaluation and "
                    "checkpoint %.3f s; losses %s; launches %s"
                    % (name, "kernel" if use_kernel else "plain", len(ms),
                       statistics.median(ms), min(ms), max(ms), secs,
                       " ".join("%.4f" % r["loss"]
                                for r in trainer.step_records), used))
                want = {"short_attention_fwd": N_LAYERS * towers
                        * (steps + eval_batches),
                        "short_attention_bwd": N_LAYERS * towers * steps,
                        "flash_attention_fwd": 0, "flash_attention_bwd": 0}
                if not use_kernel:
                    want = dict.fromkeys(wrappers, 0)
                if used != want:
                    raise AssertionError("%s training launched %s, want %s"
                                         % (name, used, want))
                if use_kernel:
                    all_launches[name] = used
                del trainer
            d_loss = max(abs(a["loss"] - b["loss"])
                         for a, b in zip(trained[True], trained[False]))
            log("%s kernel vs plain training: max |d loss| per step %.3e "
                "(bound %.1e)" % (name, d_loss, TRAIN_LOSS_ATOL))
            if not d_loss <= TRAIN_LOSS_ATOL:
                raise AssertionError("%s: loss gap %.3e" % (name, d_loss))
            for use_kernel in (True, False):
                before = counts()
                results, secs = _cli(torch, [
                    "--mode=evaluate", "--tables=" + dev_tsv,
                    "--checkpoint_dir=" + ckpt]
                    + _encoder_argv(name, use_kernel))
                used = counts()["short_attention_fwd"] \
                    - before["short_attention_fwd"]
                log("%s evaluate %-6s %s in %.3f s; short forward launches "
                    "%d" % (name, "kernel" if use_kernel else "plain",
                            ", ".join("%s %.6f" % kv for kv in results),
                            secs, used))
                if not all(np.isfinite(x) and -1 <= x <= 1  # MCC < 0 too
                           for _, x in results) or \
                        bool(used) != use_kernel:
                    raise AssertionError("%s evaluate: %s, %d launches"
                                         % (name, results, used))
        # predict through the CLI, kernel and plain, on the same checkpoint
        preds = {}
        for use_kernel in (True, False):
            out = os.path.join(workdir, "pred_%s_%d.tsv" % (name,
                                                            use_kernel))
            if not train_tsv:
                for w in wrappers:
                    getattr(A, w).launches = 0
            before = counts()
            manager, secs = _cli(torch, [
                "--mode=predict", "--tables=" + dev_tsv, "--outputs=" + out,
                "--checkpoint_dir=" + ckpt, "--output_schema="
                + spec["outputs"]] + _encoder_argv(name, use_kernel))
            used = {w: counts()[w] - before[w] for w in wrappers}
            if not train_tsv and use_kernel:
                all_launches[name] = used
            n_batches = len(manager.predictor.model_predictor.batch_seconds)
            want_fwd = N_LAYERS * towers * n_batches if use_kernel else 0
            log("%s predict %-6s %d rows in %.4f s (%.2f rows/s; %.3f s with "
                "model load); launches %s" % (name, "kernel" if use_kernel
                                               else "plain", manager.n_rows,
                                               manager.seconds,
                                               manager.n_rows
                                               / manager.seconds, secs, used))
            if used["short_attention_fwd"] != want_fwd:
                raise AssertionError("%s predict launched %s, want %d short "
                                     "forwards" % (name, used, want_fwd))
            with open(out, encoding="utf-8") as f:
                preds[use_kernel] = [line.rstrip("\n").split("\t")
                                     for line in f]
            if len(preds[use_kernel]) != manager.n_rows or any(
                    len(r) != len(spec["outputs"].split(","))
                    for r in preds[use_kernel]):
                raise AssertionError("%s: %s does not parse" % (name, out))
        # the forward outputs, kernel against plain, and the decided rows
        got, inputs = _forward_outputs(torch, name, ckpt, dev_tsv,
                                       spec["compare"])
        gaps = {k: float(np.abs(got[True][k] - got[False][k]).max())
                for k in spec["compare"]}
        decided = _decided(name, got[False], inputs)
        checked = flips = 0
        for i, d in enumerate(decided):
            if d is None:
                continue
            k_row, p_row = preds[True][i], preds[False][i]
            if name == "sequence_labeling":
                kt, pt = k_row[0].split(), p_row[0].split()
                bad = [j for j in d if kt[j] != pt[j]]
                checked += len(d)
            else:
                bad = k_row[0] != p_row[0]
                checked += 1
            flips += bool(bad)
        log("%s kernel vs plain forward: max |d| %s (bound %.1e); "
            "predictions agree at all %d decisions the plain margin decides "
            "(> %s); %d of %d rows identical; phase seconds %.3f"
            % (name, ", ".join("%s %.3e" % kv for kv in gaps.items()),
               SLICE_ATOL, checked, "4 x bound on the span score" if mrc
               else "2 x bound", sum(a == b for a, b in zip(preds[True],
                                                            preds[False])),
               len(preds[True]), time.perf_counter() - t_app))
        if max(gaps.values()) > SLICE_ATOL or flips:
            raise AssertionError("%s: kernel and plain outputs differ by %s, "
                                 "%d decided predictions differ"
                                 % (name, gaps, flips))

    # the profiler's word on the training routes: B1 and B2 at 32 x 128
    # (one block per (b, h)); at MRC's 16 x 384 B2's LSE pass and the
    # flash backward's passes (B4/B5)
    for name, want_names in (
            ("sequence_labeling",
             (("B1", SHORT_FWD_MMA_NAME),) + SHORT_BWD_ONE_BLOCK_NAMES),
            ("machine_reading_comprehension",
             (("B1", SHORT_FWD_MMA_NAME),) + SHORT_BWD_FLASH_ROUTE_NAMES)):
        train_tsv, _ = tsvs[ENCODER_APPS[name]["data"]]
        prof = os.path.join(workdir, "profile_" + name)
        for attempt in range(1, PROFILE_ATTEMPTS + 1):  # see _device_ms
            _cli(torch, ["--mode=train", "--tables=" + train_tsv,
                         "--pretrained_model_name_or_path=" + model_dir,
                         "--epoch_num=1", "--optimizer_type=AdamW",
                         "--random_seed=%d" % seed, "--profile_dir=" + prof,
                         "--profile_steps=4"] + _encoder_argv(name, True))
            share, busy_ms, top = device_share(os.path.join(prof,
                                                            "trace.json"))
            times = dict(top)
            missing = [n for _, n in want_names
                       if not any(n in key for key in times)]
            if not missing:
                break
            log("profile: %s run %d recorded %d kernels, lacking %s"
                % (name, attempt, len(times), missing))
        parts = _routed("the %s training steps" % name, times, want_names,
                        (SHORT_FWD_CUDA_CORE_NAME,)
                        + SHORT_BWD_CUDA_CORE_NAMES)
        log("profile, %s kernel run, steps 3-6 (under the profiler): device "
            "busy %.1f%% of the span of its kernels, %.3f ms busy per step; "
            "attention device ms per step: %s; top kernels: %s"
            % (name, 100 * share, busy_ms / 4,
               ", ".join("%s %.3f" % (p, parts[p] / 4) for p, _ in
                         want_names),
               "; ".join("%s %.3f" % (n[:50], t / 4) for n, t in top[:6])))
    return all_launches


def _dtype_key(key):
    """A (..., dtype) key as text ("...|bfloat16") and back."""
    import torch
    if isinstance(key, str):
        *rest, dtype = key.split("|")
        return tuple(rest) + (getattr(torch, dtype),)
    return "|".join(key[:-1] + (str(key[-1]).split(".")[1],))


def phase_kernel_in_child(seed):
    """Phase 2 in a process of its own, which writes (worst, timings) as
    JSON: its ~26 profiler sessions then leave this process's profiler
    fresh for the phases after it (on an H100 the 36th profiler session of
    one process has recorded no device kernel)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kernels_") as d:
        path = os.path.join(d, "kernels.json")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--seed",
                        str(seed), "--kernels-json", path], check=True,
                       timeout=900)
        with open(path) as f:
            data = json.load(f)
    worst = {name: {_dtype_key(k): v for k, v in cases.items()}
             for name, cases in data["worst"].items()}
    return worst, {_dtype_key(k): v for k, v in data["timings"].items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--kernels-json", help=argparse.SUPPRESS)
    cli = parser.parse_args()
    seed = cli.seed

    import torch
    # the port itself: outside a checkout this fails before anything prints
    import easynlp_tpu_torch.appzoo.api  # noqa: F401
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    phase_device(torch)
    if cli.kernels_json:  # phase 2 alone, for phase_kernel_in_child
        worst, timings = phase_kernel(torch, seed)
        with open(cli.kernels_json, "w") as f:
            json.dump({"worst": {name: {_dtype_key(k): v
                                        for k, v in cases.items()}
                                 for name, cases in worst.items()},
                       "timings": {_dtype_key(k): v
                                   for k, v in timings.items()}}, f)
        return 0
    build_s = phase_build()
    worst, timings = phase_kernel_in_child(seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        seconds = {}
        t0 = time.perf_counter()
        _, cjk = phase_slice(torch, seed, workdir)
        seconds["3 text_classify predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, ms_k, ms_p = phase_train(torch, seed, workdir, cjk)
        seconds["4 text_classify train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_generation(torch, seed, workdir)
        seconds["5 GPT-2 generation"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches = phase_bart(torch, seed, workdir)
        seconds["6 BART train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_bart_predict(torch, seed, workdir)
        seconds["7 BART predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_encoder_apps(torch, seed, workdir, cjk)
        seconds["8 encoder apps"] = time.perf_counter() - t0
    log("phase seconds: %s" % ", ".join("%s %.1f" % kv
                                        for kv in seconds.items()))

    log("kernel build %.3f s" % build_s)
    log("BERT training step, median of runs: %.3f ms with the kernels, %.3f "
        "ms plain" % (1e3 * ms_k, 1e3 * ms_p))
    log("card: %s" % card_line())
    entries = []
    for name, (_, source, replaces) in KERNELS.items():
        case = KERNEL_LINE_CASE[name]
        t = timings[(name, case, torch.bfloat16)]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name][(case, torch.bfloat16)],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
