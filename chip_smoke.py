#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root. It builds the port's CUDA kernels from
easynlp_tpu_torch/csrc (one nvcc per source, all at once), holds each
against its plain PyTorch version at the main paths' shapes, then drives the
port's two main paths on a BERT-base model (bert-base-chinese widths, random
truncated-normal weights from --seed): `--mode=predict
--app_name=text_classify` over a 256-row TSV, and `--mode=train` for one
epoch of 8 steps followed by `--mode=evaluate` and `--mode=predict` on the
checkpoint it wrote. Each path runs with the kernels and with
--use_flash_attention=false, and the two are compared. Every phase raises on
failure, so any failure exits non-zero. The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels with
their launch counts, errors and times. Imports nothing of JAX.
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
}
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

SEQ_LEN = 128
BATCH = 32
N_ROWS = 256
N_DEV_ROWS = 64
N_LAYERS = 12
LEARNING_RATE = 5e-5

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
    log("both kernels built and loaded in %.3f s (nvcc runs in parallel)"
        % seconds)
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
    return {"short_attention_fwd": worst,
            "short_attention_bwd": worst_bwd}, timings


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

    log("kernel build %.3f s" % build_s)
    log("training step, median of runs: %.3f ms with the kernels, %.3f ms "
        "plain" % (1e3 * ms_k, 1e3 * ms_p))
    log("card: %s" % card_line())
    entries = []
    for name, (source, replaces) in KERNELS.items():
        ms, plain_ms = timings[(name, "slice-128", torch.bfloat16)]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name][("slice-128", torch.bfloat16)],
            "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
