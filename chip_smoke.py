#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root. It builds the port's CUDA kernel from
easynlp_tpu_torch/csrc, holds it against its plain PyTorch version at the
main path's shapes, then drives the port's main path, `--mode=predict
--app_name=text_classify`, on a BERT-base model (bert-base-chinese widths,
random truncated-normal weights from --seed) over a 256-row TSV, once with
the kernel and once with --use_flash_attention=false, and compares the two.
Every phase raises on failure, so any failure exits non-zero. The last line
is {"ok": true, "device": {...}}; the line before it lists the kernels with
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

KERNEL_SOURCE = "easynlp_tpu_torch/csrc/short_attention_fwd.cu"
REPLACES = "easynlp_tpu/ops/attention.py:519"  # _short_fwd_kernel
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

SEQ_LEN = 128
BATCH = 32
N_ROWS = 256
N_LAYERS = 12

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
    kernels.load("short_attention_fwd")
    seconds = time.perf_counter() - t0
    info = kernels.build_info("short_attention_fwd")
    log("built %s -> %s: nvcc %.3f s, load %.3f s, cached=%s"
        % (KERNEL_SOURCE, info["path"], info["seconds"], seconds,
           info["cached"]))
    for line in info["log"].splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            log("ptxas: " + line.strip())
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
    log("== phase 2: kernel against plain version")
    rng = np.random.RandomState(seed)

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
            timings[(name, dtype)] = (ms, plain_ms)
    return worst, timings


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


def make_tsv(path, cjk, seed):
    """N_ROWS generated sentences: common CJK characters with English words,
    digits and punctuation mixed in, 8..200 characters (longer ones are
    truncated to SEQ_LEN tokens, shorter ones padded)."""
    rng = random.Random(seed)
    common = cjk[:3000]
    with open(path, "w", encoding="utf-8") as f:
        for i in range(N_ROWS):
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


def check_output(path):
    import numpy as np
    labels, probs, logits, ids = read_output(path)
    if len(labels) != N_ROWS or ids != [str(i) for i in range(N_ROWS)]:
        raise AssertionError("%s: %d rows, want ids 0..%d in order"
                             % (path, len(labels), N_ROWS - 1))
    if probs.shape != (N_ROWS, 2) or logits.shape != (N_ROWS, 2):
        raise AssertionError("probabilities %s / logits %s, want (%d, 2)"
                             % (probs.shape, logits.shape, N_ROWS))
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
    model_dir = os.path.join(workdir, "bert-base-chinese-random")
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
        launches = phase_slice(torch, seed, workdir)

    ms, plain_ms = timings[("slice-128", torch.bfloat16)]
    log("kernel build %.3f s" % build_s)
    log("card: %s" % card_line())
    print(json.dumps({"kernels": [{
        "name": "short_attention_fwd", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": worst[("slice-128", torch.bfloat16)],
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
