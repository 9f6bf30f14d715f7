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
`--mode=predict --app_name=sequence_generation` over 8 prompts of 600-768
tokens, greedy for 96 new tokens, and one beam-search batch. On a BART-base
model (HF `facebook/bart-base` widths and depth, dropout 0, random weights
from --seed, a synthetic 50265-token byte-level BPE vocab):
`--mode=train --app_name=sequence_generation` for 8 AdamW steps of 8
articles of 1024 tokens with 64-token targets, then `--mode=evaluate` on 8
rows with greedy decoding. Then `--mode=serve`: GPT-2 small behind
`/generate` (serve_continuous=true, 8 slots, a 1024-slot window) to 20
requests from 16 client threads, and phase 4's checkpoint behind
`/predict` to 256 rows in 64 concurrent requests. Then MLM pretraining
(`--mode=train --app_name=language_modeling`): BERT-base for 8 AdamW steps
of 32 x 128 with whole-word masking and `--mode=evaluate`, at
--num_host_prefetch 2 and 0 (the same losses, bit for bit), and
RoBERTa-base (HF `roberta-base` widths and depth, a synthetic 50265-token
byte-level BPE vocab) for 4 steps of 8 x 512; and `--mode=predict
--app_name=data_augmentation` on the BERT checkpoint. Then, on the BERT-base
backbone, multi-label text_classify (8 labels), information_extraction
(CLUENER2020's 10 entity types, 0.75 of an epoch, so the Trainer stops
with prefetched batches staged) and geep_classify (predict at exit
thresholds 0.9, 0.55 and 0.5, the early-exit forward held to the
all-layers one bit for bit) train, evaluate and predict at 32 x 128, and
Lion and Adafactor take 4 steps each on one repeated batch, with one
guarded step of each optimizer timed. Each path runs with
the kernels and with --use_flash_attention=false, and the two are compared
(`/predict` against --mode=predict). Then phase 13, on the BERT-base
directory and phase 4's tables: text_classify for 8 steps at
--remat=none, full, selective and names (the same losses bit for bit, the
step ms and peak memory of each; `full` launches the short forward twice
a layer), BART-base at --remat=full against phase 6's first kernel run
(the same 8 losses, less peak memory); --ema_decay=0.999 with
--save_checkpoint_steps=4, once with --async_save and once with
synchronous saves (the EMA artifact and count, the same files bit for
bit, the save time on the training thread of each); KD (the student
trained on the logits --mode=predict gives on phase 4's checkpoint,
then evaluated and predicting); PET trained, evaluated and predicting on
phase 11's masked LM, and 8 CPTClassification steps; MetaKD's teacher
(MetaTeacherTrainer, 4 steps) and a half-depth student through
MetaDistillationTrainer's two stages, 4 steps each, whose BERTs return
their attention scores and so compute attention on the explicit
einsum-and-softmax path: no kernel launches there, and the phase checks
that none does; and LoRA (the base bit for bit after training, the
adapters moved, the merged checkpoint's logits the live model's bit for
bit). Then phase 14, the knowledge models: DKPLM (TransE entity and
relation tables), CKBERT (contrast_learning_flag) and Kangaroo (an entity
CSV, contrastive samples and Poincaré concepts; ent_num 3, sample_num 4,
entity_gap 5, concept_size 100) pretraining through `--mode=train
--app_name=language_modeling`, 8 AdamW steps of 32 x 128 on
bert-base-chinese widths, then `--mode=evaluate`, with and without the
kernels (every step's loss and gradient norm held to the plain run's),
all tables and rows written from --seed; MegatronBERT at HF's default
widths (megatron-bert-cased-345m: 1024 wide, 16 heads; its first 4 of 24
layers) loaded
through AutoModel.from_pretrained from an HF-named pytorch_model.bin, a
bf16 forward and backward at 8 x 512 with and without the kernels (the
loss, the pooler output, the last hidden state and every gradient held
to the plain pass's); and K-BERT at bert-base widths with a visible
matrix, which launches no kernel (an additive bias takes attention's
plain path). Then phase 15, slice 10's paths, each with the kernels and
with --use_flash_attention=false, all weights the port's own init from
--seed and every tokenizer synthetic (SentencePiece models written by
sp_model_bytes, the CJK WordPiece vocab, ParlAI BPE codecs): T5-base (HF
`t5-base` widths, dropout 0) 4 bf16 AdamW steps of 8 x 512 sources with
64-token targets, `--mode=evaluate` and f32 `--mode=predict` of 16 rows
greedy and with 4 beams; mT5-base f32 predict of 8 rows; Pegasus-large 4
steps of 4 x 1024 and f32 predict of 8 rows with 4 beams; Randeng (its
238M widths) f32 predict of 8 CJK rows; GPT-2 small `--mode=evaluate` in
f32 on phase 4's dev table; open_domain_dialogue on the `transformer`
family's default widths, 4 steps of 16 x 128 and f32 predict. Training
holds every step's loss and gradient norm to the plain run's, f32
generation token for token, and each path's launches are counted from 0;
it also times the SentencePiece encoder native against Python. Phase 2
adds these paths' attention shapes: T5's unscaled cross-attention, head
dim 32 and Pegasus-large's 16 heads. Then phase 16, slice 11's paths,
with the kernels and with --use_flash_attention=false: on phase 5's GPT-2
small and prompts, f32 `--mode=predict` greedy, with
speculative_decoding=prompt_lookup (token for token with greedy, the
accepted tokens per verify forward and ms per output token) and with
kv_cache_dtype=int8 (token match and mean logit KL against the f32
cache); DeviceContinuousDecoder(speculative=(2, 8)) over 12 requests
against speculative=None and standalone greedy decoding; `/generate` with
serve_quantize=int8 against f32 and bf16 weights (token match, KL,
quantization_report's bytes, ms per output token); pipeline(quantize=
"int8") on phase 4's checkpoint against f32 weights; BART-base f32
speculative predict of 8 rows against greedy; and GLM at glm-large widths
(the port's init from --seed, a synthetic SentencePiece model of 50040
pieces and GLM's 8 command tokens): `--app_name=sequence_generation
enable_glm=true` 8 bf16 AdamW steps of 8 x 512 with 64-token targets,
`--mode=evaluate`, f32 predict of 16 rows greedy, with 4 beams and
speculative; `--app_name=language_modeling enable_glm=true` 4 steps of 8
x 512 and `--mode=evaluate`. Phase 2 adds their attention shapes: a
verify chunk of 9 queries at offset 247, GLM's decode step and verify
chunk over 512 keys at 16 heads. Then phase 17, slice 12's paths at
Chinese-CLIP ViT-B/16 widths (224 px in 16 x 16 patches: 197 keys, a
12-layer 768-wide quick_gelu ViT; the text tower at bert-base-chinese
widths; projection 512), weights the port's init from --seed, images
smooth random PNGs from the seed decoded through PIL: `--app_name=clip`
4 bf16 AdamW steps of 32 x (224 x 224, 32 tokens) with and without the
kernels (every step's loss and grad norm held to the plain run's), f32
`--mode=evaluate` (recall@1/5/10) and `--mode=predict` (embeddings held
to plain's); `wukong_clip` predict from those weights under the
Wukong/OpenAI names (clip's rows, equal); `text2video_retrieval` f32
evaluate and predict on 8 videos of 8-12 frames; `image2text_generation`
(that ViT with GPT-2 small's widths over the same 21128-token
vocabulary) 4 bf16 steps of 16 x (197 + 32) and f32 predict greedy and
with 4 beams, token for token with plain, and pipeline() on its
checkpoint; `video2text_generation` f32 predict on 3 frames. Phase 2
adds their shapes: ViT-B/16's 32 x 197 and ViT-B/32's 32 x 50, the
captioner's causal 16 x 229, CLIP4Clip's 96 x 197. Then phase 18,
latent diffusion at Stable Diffusion v1's widths (CompVis's
v1-inference.yaml: a 320-channel UNet over 4 levels with attention at 3
and 8 heads, so head dims 40, 80 and 160; the 128-channel KL VAE;
PAI-Diffusion's bert-base-chinese text tower; 1.04 B parameters, the
port's init from --seed written once as a 4.2 GB f32 checkpoint): f32
`--mode=predict --app_name=latent_diffusion` of 2 prompts, 8 DDIM steps
at guidance 7.5 with and without the kernels (the PNGs, and through the
app the final latents of DDIM, PLMS and DPM-Solver++, held to plain), the
B1 launches at head dim 160 counted; pipeline("chinese-ldm-general")
byte for byte with the CLI; f32 `--mode=evaluate`; 3 bf16 AdamW steps of
2 x 512² (every loss and grad norm held to plain's, no checkpoint); then
at 256²: ESRGAN 4x of a 128² image, a fresh ControlNet's sampler (the
base's images bit for bit) and 2 ControlNet training steps (the base bit
for bit), an OLSS fit and sample, edit and a 2-frame stylize_video. Phase
2 adds the UNet's shapes: level 0's 2 x 4096 self-attention at head dim
40 and its 4096 x 32 cross-attention, level 1's 2 x 1024 at 80, level
2's 2 x 256 and the middle block's 2 x 64 at 160. Then phase 19,
ARTIST-base (GPT-2 small's widths over bert-base-chinese's 21128 ids and
16384 image codes, taming-transformers' f16/16384 VQGAN; 184.4 M
parameters, the port's init from --seed written once) on 256² PNG rows:
`--app_name=text2image_generation` 4 bf16 AdamW steps of 8 x (32 + 256)
with and without the kernels (the kernel run writes the phase's one
checkpoint), f32 `--mode=evaluate`, f32 greedy image codes through the
app on the random init held code for code to plain's, top-k sampled PNGs
through the CLI and pipeline() byte for byte; `image2text_generation`
with enable_vqgan 3 bf16 steps and f32 greedy captions, kernel against
plain; TextCNN at its default widths and bloom-560m from AutoModel, the
card's f32 forward against the CPU's. Phase 2 adds ARTIST's shapes: the 8 x 288 training
sequence with padding inside its text, a decode step over 288 slots and
the 8 x 257 VQGAN prefill. Phases 14 and 15 also train Kangaroo and
T5-base a second time with the kernels and hold the two runs to each
other bit for bit (ROADMAP C28, C29). Then phase 20, the device-parallel layer
(torch.distributed): BERT-base text_classify through the CLI with
`--mesh=dp=1` (an NCCL group of one rank) and without, 3 bf16 steps,
losses and weights bit for bit; FSDP2's fully_shard over BERT-base at
world 1 (loss and gradients equal); then two `gloo` ranks on cuda:0
(gloo's send/recv staged through pinned host memory, the bytes printed):
BERT-base data=2 3 f32 AdamW steps against one rank with the global batch,
BERT-base tensor=2 logits, the ring over sequence=2 at 8 x 512 in f32 and
bf16, forward and backward (B3 and B4/B5 launched once a hop a rank, a
fully masked row the mean of V), GPT-2-small-width Switch-MoE (8 experts,
top-1, capacity 1.25, 2 layers) over expert=2 and glm-large at 2 of 24
layers over tensor=2, each against one rank. Then phase 21, GPT-2 small
(all 12 layers, f32, weights from --seed) on two `gloo` ranks on cuda:0
at tensor=2 (`parallelize`, 6 heads a rank, a vocab-parallel head):
generate() greedy and 4-beam over 8 prompts of 64-256 tokens, speculative
greedy (K 8, n-gram 2) on repeating prompts, DeviceContinuousDecoder over
12 requests in 8 slots of the 1024-slot window, and `/generate` on rank 0
over the tensor group's ContinuousBatcher (rank 1 replays its plans), 4
greedy and 4 seeded sampled requests; each against the same weights in one
process, token for token (a row may depart only where the departing
step's top-2 margin is below the runs' largest logit difference); the
B1 and B3 launches of each rank, ms per output token and the bytes staged
through host memory printed. Phase 2 adds its per-rank shapes (8 x 256
causal, 8 x 1 x 1024). Phase 22, on two more gloo ranks started beside
phase 21's, holds every other family the JAX package annotates under
tensor=2 to one process at published widths (depth cut, f32): BART-base
CLI training at --mesh=tp=2 and 4-beam generate, T5-base, bloom-560m
(the ALiBi slopes of each rank's heads), Chinese-CLIP ViT-B/16 with its
text tower, ARTIST-base (the codebook split over codes: the image codes
and greedy codes equal), and the SD v1 UNet's make_train_loss steps
through the Trainer at data=2; phase 20's ranks add BERT-base's
--remat=full + Adafactor at dp=2 and tp=2 and LoRA at tp=2 with a save
and a resume (its (f)). Phase 2 adds phase 22's per-rank shapes (8 x
1024 and 16 x 197 at 6 heads). Every phase raises on
failure, so any failure exits non-zero. `--only 2`, `--only 19`,
`--only 20`, `--only 21` or `--only 22` runs the build and that phase
alone. The last line is {"ok": true, "device": {...}}; the
line before it lists the kernels with their launches in the BART
training run and phase 11's to 22's runs, errors, times (kernel, plain
twin, the PyTorch library call) and bounds. Imports nothing of JAX or of
the JAX package.
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
GEN_NEW_TOKENS = 96             # max_decoder_length (128 until slice 15)
GEN_BATCH = 8
GEN_ROWS = 8                    # 16 until slice 14
GEN_BEAMS, GEN_BEAM_NEW_TOKENS = 4, 32
GEN_LETTERS = "etaoinshrdlucmfwypvbgkqjxz"
# phase 9: --mode=serve with serve_continuous=true on GPT-2 small
SERVE_SLOTS, SERVE_CHUNK = 8, 16
SERVE_WINDOW = 1024                  # --sequence_length: the KV window
SERVE_BUCKET = SERVE_WINDOW // 4     # the default prompt bucket
SERVE_PREFIX = 64                    # phase 2's shared-prefix admit
SERVE_REQUESTS, SERVE_STREAMS, SERVE_SAMPLED = 16, 4, 4  # 32 until slice 15
SERVE_CLIENTS = 16
# f32 serving against f32 standalone greedy decoding: the same kernels at
# the same shapes, row by row, so the tokens should agree exactly; a
# divergence is accepted only where the standalone run's top-2 logit
# margin is below this (sums in another order could break an exact tie)
SERVE_F32_TIE = 1e-3
# phase 10: the pipeline() PredictionServer on phase 4's checkpoint
PREDICT_SERVE_REQUESTS = 64
# Its rows against --mode=predict's, logits written as %.6f text: both bf16
# on the same weights, each row computed alone at any batch size (two
# readings on an H100 gave 1.0e-06, one step of the text, with served
# batches of 12-32 rows against predict's 32). 1e-4 is 100x that and below
# the gap between the logits of nearly every two rows, so a row answered
# to the wrong request fails it; the labels decide little, as the 8-step
# classifier's margins sit near 0.
PREDICT_SERVE_ATOL = 1e-4

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


_T_START = time.perf_counter()


def log(msg):
    if msg.startswith("== phase"):
        # each phase's header: what this process has written so far, and
        # its seconds since it started
        written = _written_gib()
        msg += " [%s%.1f s in]" % (
            "" if written is None else "written so far %.2f GiB, " % written,
            time.perf_counter() - _T_START)
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
    """q, k, v [B, S, H, D] f32 normals and the int32 key mask: each row's
    first lengths[i] keys, or `lengths` itself where it is a [B, Skv]
    mask."""
    import numpy as np
    dev = torch.device("cuda")
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(dev) for s in (sq, skv, skv))
    lengths = np.asarray(lengths)
    keep = lengths.astype(bool) if lengths.ndim == 2 else (
        np.arange(skv)[None, :] < lengths[:, None])
    mask = torch.from_numpy(keep.astype(np.int32)).to(dev)
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


def _seen(mask, b, sq, skv, causal):
    """bool [B,Sq,Skv]: the keys each query sees (masked or causally hidden
    ones excluded)."""
    import numpy as np
    m = np.broadcast_to(mask.cpu().numpy().astype(bool), (b, skv))
    seen = m[:, None, :]
    if causal:
        qi = np.arange(sq)[:, None] + (skv - sq)
        seen = seen & (np.arange(skv)[None, :] <= qi)[None]
    return np.broadcast_to(seen, (b, sq, skv))


def _pairs(mask, b, sq, skv, h, causal):
    """(query, key) pairs this data needs, over all heads: each row's
    visible keys (masked or causally hidden ones excluded); a row that sees
    no key averages all Skv."""
    import numpy as np
    per_row = _seen(mask, b, sq, skv, causal).sum(-1)
    return h * int(np.where(per_row == 0, skv, per_row).sum())


def _attention_bytes(mask, b, sq, skv, h, d, causal, elem, backward=False,
                     written=("dq", "dk", "dv")):
    """Bytes an attention call must move for this data, each input read
    once and each output written once, LSE left out: the int32 mask; q
    (and, backward, o) of the queries that see a key; k and v of the keys
    some query of the batch row sees. Forward: a row holding a query that
    sees no key reads every v (that query's output is the mean of V), and
    o is written in full. Backward: dO of every query (a query that sees no
    key still gives dv its mean), and the `written` gradients in full."""
    import numpy as np
    seen = _seen(mask, b, sq, skv, causal)
    live_q = seen.any(-1)   # [B, Sq]
    live_k = seen.any(1)    # [B, Skv]
    n_q, n_k = int(live_q.sum()), int(live_k.sum())
    if backward:
        tokens = 2 * n_q + b * sq + 2 * n_k + sum(
            b * (sq if g == "dq" else skv) for g in written)
    else:
        n_v = int(np.where(live_q.all(-1), live_k.sum(-1), skv).sum())
        tokens = n_q + n_k + n_v + b * sq
    return tokens * h * d * elem + mask.numel() * 4


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


def _time_sdpa(torch, tq, tk, tv, mask, causal, do, iters, scale=None):
    """PyTorch's one call for the same function, the yardstick of
    `library_ms` (a measurement only: the port never calls it):
    scaled_dot_product_attention with the same boolean mask and scale,
    forward, and backward from a kept graph. (forward ms, backward ms,
    backend)."""
    F = torch.nn.functional
    keep = _sdpa_mask(torch, mask, tq.shape[1], tk.shape[1], causal)
    q, k, v = (t.transpose(1, 2) for t in (tq, tk, tv))
    backend = _sdpa_backend(torch, q, k, v, keep)
    fwd = _time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=keep, scale=scale), iters=iters)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=keep,
                                         scale=scale)
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
    # RoBERTa-base MLM pretraining's 8 x 512, rows of 256-512 real tokens
    # (B1; B2's route past 128 keys: an LSE pass, then B4/B5's passes),
    # from a stream of its own
    mlm_rng = np.random.RandomState(seed + 3)
    mlm_cases = [("mlm-512", 8, 512, 512, 12, 64,
                  np.r_[512, mlm_rng.randint(256, 513, size=7)], False)]
    # information_extraction's 32 x 128, rows of 22-62 real tokens (20-60
    # characters with [CLS] and [SEP]): B1 skips the key tiles the padding
    # hides; B2's one-block route. From a stream of its own.
    ie_rng = np.random.RandomState(seed + 4)
    ie_cases = [("ie-128", 32, 128, 128, 12, 64,
                 np.r_[62, 22, ie_rng.randint(22, 63, size=30)], False)]
    # phase 14's shapes, from a stream of their own: Kangaroo's sample
    # encoding, 32 rows x 3 entity slots x 4 samples of 128 slots, sentences
    # of 3-30 characters (with [CLS] and [SEP]: 5-32 keys) and about a
    # third of the slots empty (their 4 rows fully masked); MegatronBERT-
    # 345M's 8 x 512 over 16 heads, rows of 256-512 tokens (B2's route 2)
    kg_rng = np.random.RandomState(seed + 5)
    slots = kg_rng.rand(96) < 0.65
    kg_cases = [
        ("kangaroo-samples", 384, 128, 128, 12, 64,
         np.where(np.repeat(slots, 4), kg_rng.randint(5, 33, 384), 0),
         False),
        ("megatron-512", 8, 512, 512, 16, 64,
         np.r_[512, kg_rng.randint(256, 513, size=7)], False)]
    # phase 17's shapes, from a stream of their own: the ViT-B/16 tower's
    # 32 x 197 patches and CLS (unmasked; B2's route 2) and ViT-B/32's 32 x
    # 50 (B2's one-block route), the captioner's GPT-2 over its visual
    # prefix, 16 x (197 + 32), causal, rows of 200-229 (caption padding),
    # and CLIP4Clip's 8 videos x 12 frames through the ViT, 96 x 197
    mm_rng = np.random.RandomState(seed + 8)
    mm_cases = [
        ("vit-b16", 32, 197, 197, 12, 64, np.full(32, 197), False),
        ("vit-b32", 32, 50, 50, 12, 64, np.full(32, 50), False),
        ("i2t-prefix", 16, 229, 229, 12, 64,
         np.r_[229, mm_rng.randint(200, 230, size=15)], True),
        ("clip4clip", 96, 197, 197, 12, 64, np.full(96, 197), False)]
    worst = {}
    seconds = {}
    t0 = time.perf_counter()
    for case_rng, group in ((rng, cases), (skip_rng, skip_cases),
                            (mlm_rng, mlm_cases), (ie_rng, ie_cases),
                            (kg_rng, kg_cases), (mm_rng, mm_cases)):
        for name, b, sq, skv, h, d, lens, causal in group:
            q, k, v, mask = _inputs(torch, case_rng, b, sq, skv, h, d, lens)
            for dtype in (torch.float32, torch.bfloat16):
                worst[(name, dtype)] = _check_short_fwd(
                    torch, A, name, q.to(dtype), k.to(dtype), v.to(dtype),
                    mask, causal)
            _check_bwd(torch, A, case_rng, name, q, k, v, mask, causal,
                       worst_bwd)
    seconds["short checks"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    timings = {}
    for case_rng, (name, b, sq, skv, h, d, lens, causal) in (
            [(rng, c) for c in cases[:5]] + [(mlm_rng, c) for c in mlm_cases]
            + [(ie_rng, c) for c in ie_cases]
            + [(kg_rng, c) for c in kg_cases]
            + [(mm_rng, c) for c in mm_cases]):
        q, k, v, mask = _inputs(torch, case_rng, b, sq, skv, h, d, lens)
        # in bf16 only, the dtype the training runs take (the f32 walks are
        # checked above; the first five shapes were timed in f32 too until
        # slice 14): the process's profiler sessions are few
        # (phase_kernel_in_child)
        for dtype in (torch.bfloat16,):
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
            nbytes = _attention_bytes(mask, b, sq, skv, h, d, causal,
                                      tq.element_size())
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
    seconds["short times"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    worst_flash = _check_flash(torch, A, rng, timings)
    seconds["flash forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    worst_flash_bwd = _check_flash_bwd(torch, A, rng, timings)
    seconds["flash backward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the serving shapes, from a stream of their own
    _check_serving_shapes(torch, A, np.random.RandomState(seed + 2), worst,
                          worst_flash, timings)
    seconds["serving"] = time.perf_counter() - t0
    out = {"short_attention_fwd": worst,
           "short_attention_bwd": worst_bwd,
           "flash_attention_fwd": worst_flash,
           "flash_attention_bwd_dkdv": worst_flash_bwd,
           "flash_attention_bwd_dq": dict(worst_flash_bwd)}
    t0 = time.perf_counter()
    # phase 15's shapes: T5's unscaled cross-attention, head dim 32,
    # Pegasus-large's 16 heads
    _check_seq2seq_cases(torch, A, seed, out, timings)
    seconds["seq2seq, slice 11, ring hop, tensor=2"] = \
        time.perf_counter() - t0
    t0 = time.perf_counter()
    # phase 18's: the SD v1 UNet's head dims 40, 80 and 160; phase 19's:
    # ARTIST-base's training sequence, decode step and VQGAN prefill
    _check_diffusion_cases(torch, A, seed, out, timings)
    seconds["diffusion, ARTIST"] = time.perf_counter() - t0
    log("phase 2 seconds by part: %s" % ", ".join(
        "%s %.1f" % kv for kv in seconds.items()))
    return out, timings


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


def seq2seq_cases(rng):
    """Phase 15's attention shapes, from a stream of their own. Each: name,
    path ('short' or 'flash'), B, Sq, Skv, H, D, each row's real keys,
    causal, scale (None: 1/sqrt(D)), and whether its backward runs. T5's
    cross-attention is unscaled (scale 1.0) over ragged 512-token sources:
    training's 8 x 64 targets and the 4-beam decode step's 16 rows x 4
    beams x 1 query; the dialogue transformer's head dim 32 (16 heads over
    512): its encoder's 16 x 128 and its decoder's causal 16 x 64;
    Pegasus-large's 16 heads: the decoder's causal 4 x 64, the encoder's 4
    x 1024, the cross-attention's 4 x 64 x 1024 and the 4-beam decode's 32
    x 1 x 1024."""
    import numpy as np
    t5_src = np.r_[512, rng.randint(200, 513, size=7)]
    peg_src = [1024, 800] + list(rng.randint(300, 1025, size=2))
    return [
        ("t5-cross-512", "short", 8, 64, 512, 12, 64, t5_src, False, 1.0,
         True),
        ("t5-decode-cross", "short", 64, 1, 512, 12, 64,
         np.repeat(np.r_[t5_src, rng.randint(200, 513, size=8)], 4), False,
         1.0, False),
        ("dialogue-d32", "short", 16, 128, 128, 16, 32,
         np.r_[128, rng.randint(20, 129, size=15)], False, None, True),
        ("dialogue-d32-causal", "short", 16, 64, 64, 16, 32,
         np.r_[64, rng.randint(5, 65, size=15)], True, None, True),
        ("pegasus-decoder", "short", 4, 64, 64, 16, 64,
         np.r_[64, rng.randint(5, 65, size=3)], True, None, True),
        ("pegasus-encoder", "flash", 4, 1024, 1024, 16, 64, peg_src, False,
         None, True),
        ("pegasus-cross", "flash", 4, 64, 1024, 16, 64, peg_src, False, None,
         True),
        ("pegasus-decode-cross", "flash", 32, 1, 1024, 16, 64,
         np.repeat(peg_src * 2, 4), False, None, False),
    ]


def slice11_cases(rng):
    """Phase 16's attention shapes (as seq2seq_cases), forward only: a
    shared-index speculative verify chunk of K+1 = 9 queries causal at
    offset 247 over 256 keys (GPT-2 small's 12 heads); GLM-large's decode
    step over a 512-slot cache (16 heads, rows of 200-512 written slots)
    and its verify chunk, 9 queries causal over 512 keys."""
    import numpy as np
    return [
        ("spec-verify", "short", 16, 9, 256, 12, 64, np.full(16, 256), True,
         None, False),
        ("glm-decode", "short", 16, 1, 512, 16, 64,
         np.r_[512, rng.randint(200, 513, size=15)], False, None, False),
        ("glm-verify", "short", 16, 9, 512, 16, 64, np.full(16, 512), True,
         None, False),
    ]


def parallel_cases(rng):
    """Phase 20's ring hop (as seq2seq_cases), forward and backward:
    BERT-base's 8 x 512 over sequence=2, so each hop is 8 x 256 queries
    against one 256-key chunk, 12 heads, D 64, non-causal, rows holding
    1-256 of the chunk's keys (B3, then B4/B5 with the global LSE)."""
    import numpy as np
    return [("ring-hop", "flash", 8, 256, 256, 12, 64,
             np.r_[256, rng.randint(1, 257, size=7)], False, None, True)]


def tp_cases(rng):
    """Phase 21's attention shapes (as seq2seq_cases), forward only, at
    GPT-2 small over tensor=2 (6 of 12 heads a rank, D 64): the prefill
    bucket, 8 prompts of 64-256 tokens left-padded to 256, causal (B1); a
    decode step, 8 slots of 1 query over the 1024-slot window, rows holding
    65-1024 written slots (B3)."""
    import numpy as np
    lens = rng.randint(64, 257, size=8)
    left = np.arange(256)[None, :] >= (256 - lens)[:, None]
    return [
        ("tp-prefill", "short", 8, 256, 256, 6, 64, left, True, None, False),
        ("tp-decode", "flash", 8, 1, 1024, 6, 64,
         np.r_[1024, rng.randint(65, 1025, size=7)], False, None, False),
    ]


def p22_cases(rng):
    """Phase 22's per-rank shapes (as seq2seq_cases) at 6 of 12 heads, D
    64, forward and backward: BART-base's encoder over tensor=2, 8 x 1024
    with half the rows padded to 512 (B3, B4/B5); the CLIP ViT-B/16 tower
    over tensor=2, 16 x 197 unmasked (B1, B2)."""
    import numpy as np
    return [
        ("p22-bart-encoder", "flash", 8, 1024, 1024, 6, 64,
         np.r_[1024, 512, rng.randint(600, 1025, size=6)], False, None,
         True),
        ("p22-vit", "short", 16, 197, 197, 6, 64, np.full(16, 197), False,
         None, True),
    ]


def diffusion_cases(rng):
    """Phase 18's attention shapes (as seq2seq_cases), at Stable Diffusion
    v1's UNet on 512-pixel images (64 x 64 latents) over 8 heads, batch 2,
    unmasked: level 0's self-attention, 4096 x 4096 at head dim 40 (B3,
    B4/B5), and its cross-attention to a 32-token prompt (B1, B2's route
    2); level 1's self-attention, 1024 x 1024 at head dim 80 (B3, B4/B5);
    level 2's, 256 x 256 at head dim 160 (B1, B2's route 2); the middle
    block's, 64 x 64 at head dim 160 (B1, B2's one-block route)."""
    import numpy as np
    full = np.full(2, 4096)
    return [
        ("sd-l0-self", "flash", 2, 4096, 4096, 8, 40, full, False, None,
         True),
        ("sd-l1-self", "flash", 2, 1024, 1024, 8, 80, full // 4, False, None,
         True),
        ("sd-l0-cross", "short", 2, 4096, 32, 8, 40, np.full(2, 32), False,
         None, True),
        ("sd-l2-self", "short", 2, 256, 256, 8, 160, np.full(2, 256), False,
         None, True),
        ("sd-mid", "short", 2, 64, 64, 8, 160, np.full(2, 64), False, None,
         True),
    ]


def artist_mask(rng, b, text=None, codes=None):
    """[B, text + codes] bool: each row's 8-32 real text tokens (a caption
    right-padded to ARTIST's 32), its padding, then every image code."""
    import numpy as np
    text = ARTIST_TEXT_LEN if text is None else text
    codes = ARTIST_BASE["image_token_length"] if codes is None else codes
    mask = np.ones((b, text + codes), bool)
    for i, n in enumerate(rng.randint(8, text + 1, b)):
        mask[i, n:text] = False
    return mask


def artist_cases(rng):
    """Phase 19's attention shapes (as seq2seq_cases) at ARTIST-base's GPT
    (GPT-2 small: 12 heads of 64), batch 8: the training sequence, 32 text
    slots (8-32 real tokens, padding inside) and 256 codes, 288 x 288
    causal (B1; B2's route 2); a decode step, 1 query over the 288-slot
    cache with those holes (B1); enable_vqgan's prefill, 256 codes and BOS,
    257 x 257 causal (B1)."""
    import numpy as np
    s = ARTIST_TEXT_LEN + ARTIST_BASE["image_token_length"]
    holes = artist_mask(rng, 8)
    return [
        ("artist-train", "short", 8, s, s, 12, 64, holes, True, None, True),
        ("artist-decode", "short", 8, 1, s, 12, 64, holes, False, None,
         False),
        ("i2t-vqgan-prefill", "short", 8, s - ARTIST_TEXT_LEN + 1,
         s - ARTIST_TEXT_LEN + 1, 12, 64, np.full(8, s - ARTIST_TEXT_LEN + 1),
         True, None, False),
    ]


def _check_diffusion_cases(torch, A, seed, worst, timings):
    """diffusion_cases (stream seed + 9) and artist_cases (seed + 10)
    through _check_profiled_cases."""
    import numpy as np
    for offset, cases_of, tag in ((9, diffusion_cases, "sd"),
                                  (10, artist_cases, "artist")):
        case_rng = np.random.RandomState(seed + offset)
        _check_profiled_cases(torch, A, case_rng, cases_of(case_rng), worst,
                              timings, tag)


def _check_profiled_cases(torch, A, case_rng, cases, worst, timings, tag):
    """`cases` through _check_attention_cases (checks, bf16 times by CUDA
    events, bounds, SDPA), then one profiler session per shape for the
    bf16 kernels' device time: the route's tensor-core kernels, forward
    and, where the case has one, backward, and no CUDA-core walk."""
    _check_attention_cases(torch, A, case_rng, cases, worst, timings, tag)
    for name, path, b, sq, skv, h, d, lens, causal, _, backward in cases:
        q, k, v, mask = _inputs(torch, case_rng, b, sq, skv, h, d, lens)
        tq, tk, tv = (t.to(torch.bfloat16) for t in (q, k, v))
        do = torch.randn_like(tq)
        if path == "short":
            o = A.short_attention_fwd(tq, tk, tv, mask, causal)
            names = (("fwd", SHORT_FWD_MMA_NAME),) + (_short_bwd_names(
                torch, A, torch.bfloat16, sq, skv) if backward else ())

            def both():
                A.short_attention_fwd(tq, tk, tv, mask, causal)
                if backward:
                    A.short_attention_bwd(tq, tk, tv, mask, o, do, causal)
            refused = (SHORT_FWD_CUDA_CORE_NAME,) + SHORT_BWD_CUDA_CORE_NAMES
            kernels = ("short_attention_fwd",) + (
                ("short_attention_bwd",) if backward else ())
        else:
            o, lse = A.flash_attention_fwd(tq, tk, tv, mask, causal)
            names = (("fwd", FLASH_FWD_MMA_NAME),) + FLASH_BWD_KERNEL_NAMES

            def both():
                A.flash_attention_fwd(tq, tk, tv, mask, causal)
                A.flash_attention_bwd(tq, tk, tv, mask, o, lse, do, causal)
            refused = (FLASH_FWD_CUDA_CORE_NAME,) + CUDA_CORE_BWD_NAMES
            kernels = ("flash_attention_fwd", "flash_attention_bwd_dkdv",
                       "flash_attention_bwd_dq")
        times = _device_ms(torch, both, want=tuple(n for _, n in names))
        split = _routed("bf16 %s at %s" % (path, name), times, names,
                        refused)
        bwd_dev = sum(ms for part, ms in split.items() if part != "fwd")
        log("profile %s %-12s bf16 %s: forward %.4f ms, backward %.4f ms "
            "(%s) per call (device time; no CUDA-core walk in the trace)"
            % (tag, name, path, split["fwd"], bwd_dev, ", ".join(
                "%s %.4f" % kv for kv in split.items() if kv[0] != "fwd")))
        timings[(kernels[0], name, torch.bfloat16)]["dev_ms"] = split["fwd"]
        for kernel in kernels[1:]:
            timings[(kernel, name, torch.bfloat16)]["dev_ms"] = bwd_dev
        del q, k, v, tq, tk, tv, do, o
        torch.cuda.empty_cache()


def _check_seq2seq_cases(torch, A, seed, worst, timings):
    """Phase 15's shapes (seq2seq_cases), phase 16's (slice11_cases),
    phase 20's ring hop (parallel_cases) and phases 21's and 22's per-rank
    shapes (tp_cases, p22_cases), each from a stream of its own, through
    _check_attention_cases."""
    import numpy as np
    case_rng = np.random.RandomState(seed + 6)
    _check_attention_cases(torch, A, case_rng, seq2seq_cases(case_rng),
                           worst, timings, "s2s")
    case_rng = np.random.RandomState(seed + 7)
    _check_attention_cases(torch, A, case_rng, slice11_cases(case_rng),
                           worst, timings, "s11")
    case_rng = np.random.RandomState(seed + 8)
    _check_attention_cases(torch, A, case_rng, parallel_cases(case_rng),
                           worst, timings, "p20")
    case_rng = np.random.RandomState(seed + 11)
    _check_attention_cases(torch, A, case_rng, tp_cases(case_rng), worst,
                           timings, "p21")
    case_rng = np.random.RandomState(seed + 12)
    _check_attention_cases(torch, A, case_rng, p22_cases(case_rng), worst,
                           timings, "p22")


def _check_attention_cases(torch, A, case_rng, cases, worst, timings, tag):
    """Each case's kernel against its f32 twin at the case's scale, f32
    within 2e-5 (the backward 2e-5 + 1e-5 |g|), bf16 within the
    tensor-core bounds with R re-derived at that scale by
    flash_attention_{fwd,bwd}_rss (bf16 attention_reference's ratio to the
    same bound logged beside); then bf16 times by CUDA events against the
    twin and SDPA (given the same scale), and each bound. No profiler
    session: the child's are spent on the shapes above."""
    import numpy as np
    for (name, path, b, sq, skv, h, d, lens, causal, scale,
         backward) in cases:
        q, k, v, mask = _inputs(torch, case_rng, b, sq, skv, h, d, lens)
        if scale == 1.0:  # T5's q projection keeps unscaled scores O(1)
            q = q * d ** -0.5
        do = torch.from_numpy(case_rng.standard_normal(
            (b, sq, h, d)).astype(np.float32)).cuda()
        if path == "short":
            def fwd(*t):
                return A.short_attention_fwd(*t, mask, causal, scale), None

            def bwd(t, o, lse, g):
                return A.short_attention_bwd(*t, mask, o, g, causal, scale)

            def bwd_twin(t, o, lse, g):
                return A.short_attention_bwd_reference(*t, mask, o, g,
                                                       causal, scale)
        else:
            def fwd(*t):
                return A.flash_attention_fwd(*t, mask, causal, scale)

            def bwd(t, o, lse, g):
                return A.flash_attention_bwd(*t, mask, o, lse, g, causal,
                                             scale)

            def bwd_twin(t, o, lse, g):
                return A.flash_attention_bwd_reference(*t, mask, o, lse, g,
                                                       causal, scale)
        kernels = {"fwd": ("%s_attention_fwd" % path,),
                   "bwd": (("short_attention_bwd",) if path == "short" else
                           ("flash_attention_bwd_dkdv",
                            "flash_attention_bwd_dq"))}
        for dtype in (torch.float32, torch.bfloat16):
            tq, tk, tv, tdo = (t.to(dtype) for t in (q, k, v, do))
            # the twin on the same (rounded) inputs, in f32
            f32 = (tq.float(), tk.float(), tv.float())
            want, lse = A.flash_attention_fwd_reference(*f32, mask, causal,
                                                        scale)
            got, got_lse = fwd(tq, tk, tv)
            err = (got.float() - want).abs().max().item()
            if dtype == torch.float32:
                ok, note = err <= ATOL_F32, "atol %.1e" % ATOL_F32
            else:
                rss = A.flash_attention_fwd_rss(*f32, mask, causal, scale)
                ratio = _flash_fwd_bf16_ratio(A, got, want, rss)
                ref = A.attention_reference(tq, tk, tv, kv_mask=mask,
                                            causal=causal, scale=scale)
                ok = ratio <= 1
                note = ("error / bound %.3f; bf16 attention_reference's "
                        "%.3f" % (ratio, _flash_fwd_bf16_ratio(A, ref, want,
                                                               rss)))
            log("check %s %-20s %-8s %s forward, scale %.4g: max_abs_err "
                "%.3e (%s) %s" % (tag, name, str(dtype).split(".")[1], path,
                                  scale or d ** -0.5, err, note,
                                  "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("%s forward disagrees with its plain "
                                     "version at %s %s: %.3e" % (
                                         path, name, dtype, err))
            for kernel in kernels["fwd"]:
                worst[kernel][(name, dtype)] = err
            if not backward:
                continue
            o32 = got.float()
            want_grads = bwd_twin(f32, o32, lse, tdo.float())
            grads = bwd((tq, tk, tv), got, got_lse, tdo)
            gerr = max((g.float() - w).abs().max().item()
                       for g, w in zip(grads, want_grads))
            if dtype == torch.float32:
                ok = all(((g - w).abs() - BWD_ATOL_F32 - BWD_RTOL_F32
                          * w.abs()).max().item() <= 0
                         for g, w in zip(grads, want_grads))
                note = "bound %.1e + %.1e |g|" % (BWD_ATOL_F32, BWD_RTOL_F32)
            else:
                rss = A.flash_attention_bwd_rss(*f32, mask, o32, lse,
                                                tdo.float(), causal, scale)
                ratio = 0.0
                for g, w, r in zip(grads, want_grads, rss):
                    bound = FLASH_BWD_ATOL_BF16 + FLASH_BWD_RTOL_BF16 \
                        * w.abs() + FLASH_BWD_RSS_BF16 * r
                    ratio = max(ratio, ((g.float() - w).abs()
                                        / bound).max().item())
                ok = ratio <= 1
                note = "error / bound %.3f" % ratio
            log("check %s %-20s %-8s %s backward: max_abs_err %.3e (%s) %s"
                % (tag, name, str(dtype).split(".")[1], path, gerr, note,
                   "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("%s backward disagrees with its plain "
                                     "version at %s %s: %.3e" % (
                                         path, name, dtype, gerr))
            for kernel in kernels["bwd"]:
                worst[kernel][(name, dtype)] = gerr
        # bf16 times, bounds and SDPA at the same scale
        tq, tk, tv, tdo = (t.to(torch.bfloat16) for t in (q, k, v, do))
        o, o_lse = fwd(tq, tk, tv)
        ms = _time_ms(torch, lambda: fwd(tq, tk, tv))
        plain_ms = _time_ms(torch, lambda: A.flash_attention_fwd_reference(
            tq, tk, tv, mask, causal, scale) if path == "flash" else
            A.short_attention_fwd_reference(tq, tk, tv, mask, causal, scale))
        lib_fwd, lib_bwd, backend = _time_sdpa(torch, tq, tk, tv, mask,
                                               causal, tdo, 50, scale=scale)
        pairs = _pairs(mask, b, sq, skv, h, causal)
        nbytes = _attention_bytes(mask, b, sq, skv, h, d, causal, 2) + (
            b * h * sq * 4 if path == "flash" else 0)
        bound_ms, bound_by = _bound(nbytes, 4 * pairs * d)
        for kernel in kernels["fwd"]:
            timings[(kernel, name, torch.bfloat16)] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_fwd,
                bound_ms=bound_ms, bound_by=bound_by)
        line = ("time %s %-20s bf16 %s forward %.4f ms (bound %.4f ms by "
                "%s), plain twin %.4f ms, SDPA %.4f ms (%s)"
                % (tag, name, path, ms, bound_ms, bound_by, plain_ms, lib_fwd,
                   backend))
        if backward:
            _, lse = A.flash_attention_fwd_reference(tq, tk, tv, mask,
                                                     causal, scale)
            bms = _time_ms(torch, lambda: bwd((tq, tk, tv), o, o_lse, tdo))
            bplain = _time_ms(torch, lambda: bwd_twin((tq, tk, tv), o, lse,
                                                      tdo))
            bbytes = _attention_bytes(mask, b, sq, skv, h, d, causal, 2,
                                      backward=True)
            bbound, bby = _bound(bbytes, 10 * pairs * d)
            for kernel in kernels["bwd"]:
                timings[(kernel, name, torch.bfloat16)] = dict(
                    ms=bms, plain_ms=bplain, library_ms=lib_bwd,
                    bound_ms=bbound, bound_by=bby)
            line += ("; backward %.4f ms (bound %.4f ms by %s), plain twin "
                     "%.4f ms, SDPA backward %.4f ms"
                     % (bms, bbound, bby, bplain, lib_bwd))
        log(line)
        del q, k, v, do, tq, tk, tv, tdo, o
        torch.cuda.empty_cache()


def serving_cases(rng):
    """The attention shapes of phase 9's serving path (GPT-2 small: H=12,
    D=64; 8 slots, a 1024-slot window, the default 256-token prompt
    bucket): B3 at one query a slot against the whole window, each slot's
    keys its left-padded prompt of 64..256 tokens and the 0..128 tokens it
    generated (ragged); B1 over the admit's left-padded, causal 8 x 256
    bucket (pad queries see no key); B1 over a shared-prefix admit, 8 x 256
    queries at offset 64 against the 64 prefix keys and the bucket (causal,
    q_offset 64). Each: name, kernel, B, Sq, Skv, [row's [(start, end),
    ...] of real keys], causal."""
    b, t, p, p0 = SERVE_SLOTS, SERVE_WINDOW, SERVE_BUCKET, SERVE_PREFIX
    prompt = rng.randint(64, p + 1, size=b)
    prompt[0] = p
    gen = rng.randint(0, 129, size=b)
    return [
        ("serve-decode", "flash", b, 1, t,
         [[(p - n, p + g)] for n, g in zip(prompt, gen)], False),
        ("serve-prefill", "short", b, p, p, [[(p - n, p)] for n in prompt],
         True),
        ("serve-prefix-admit", "short", b, p, p0 + p,
         [[(0, p0), (p0 + p - n, p0 + p)] for n in prompt], True),
    ]


def _rows_mask(torch, skv, rows):
    """int32 [B,Skv] key mask, 1 on each of a row's [start, end) ranges."""
    import numpy as np
    mask = np.zeros((len(rows), skv), np.int32)
    for i, ranges in enumerate(rows):
        for start, end in ranges:
            mask[i, start:end] = 1
    return torch.from_numpy(mask).cuda()


def _check_serving_shapes(torch, A, rng, worst_short, worst_flash, timings):
    """serving_cases() against the kernels' f32 twins (f32 within 2e-5,
    bf16 within the tensor-core bound; B1 also the same bits as B3), then,
    bf16, each kernel's time against its twin's and SDPA's forward, its
    device time from the profiler (which must show the tensor-core kernel
    and no CUDA-core walk) and its bound."""
    for name, kernel, b, sq, skv, rows, causal in serving_cases(rng):
        q, k, v, _ = _inputs(torch, rng, b, sq, skv, 12, 64, [skv] * b)
        mask = _rows_mask(torch, skv, rows)
        for dtype in (torch.float32, torch.bfloat16):
            tq, tk, tv = (t.to(dtype) for t in (q, k, v))
            if kernel == "short":
                worst_short[(name, dtype)] = _check_short_fwd(
                    torch, A, name, tq, tk, tv, mask, causal)
                continue
            twin = (tq.float(), tk.float(), tv.float(), mask, causal)
            want, _ = A.flash_attention_fwd_reference(*twin)
            got, _ = A.flash_attention_fwd(tq, tk, tv, mask, causal)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            if dtype == torch.float32:
                ok, bound = err <= ATOL_F32, "atol %.1e" % ATOL_F32
            else:
                ratio = _flash_fwd_bf16_ratio(
                    A, got, want, A.flash_attention_fwd_rss(*twin))
                ok, bound = ratio <= 1, "error / bound %.3f" % ratio
            log("check flash %-16s %-8s max_abs_err %.3e (%s) %s"
                % (name, str(dtype).split(".")[1], err, bound,
                   "ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("flash kernel disagrees with its plain "
                                     "version: %s %s err %.3e"
                                     % (name, dtype, err))
            worst_flash[(name, dtype)] = err
        tq, tk, tv = (t.to(torch.bfloat16) for t in (q, k, v))
        if kernel == "short":
            wrapper, twin_fn = A.short_attention_fwd, \
                A.short_attention_fwd_reference
            want_name, refused = SHORT_FWD_MMA_NAME, SHORT_FWD_CUDA_CORE_NAME
            lse_bytes = 0
        else:
            wrapper, twin_fn = A.flash_attention_fwd, \
                A.flash_attention_fwd_reference
            want_name, refused = FLASH_FWD_MMA_NAME, FLASH_FWD_CUDA_CORE_NAME
            lse_bytes = b * 12 * sq * 4
        ms = _time_ms(torch, lambda: wrapper(tq, tk, tv, mask, causal))
        plain_ms = _time_ms(torch, lambda: twin_fn(tq, tk, tv, mask, causal))
        lib_ms, _, backend = _time_sdpa(torch, tq, tk, tv, mask, causal,
                                        torch.randn_like(tq), 50)
        dev = _routed("the bf16 %s at %s" % (wrapper.__name__, name),
                      _device_ms(torch, lambda: wrapper(tq, tk, tv, mask,
                                                        causal),
                                 want=(want_name,)),
                      (("kernel", want_name),), (refused,))["kernel"]
        nbytes = _attention_bytes(mask, b, sq, skv, 12, 64, causal, 2) \
            + lse_bytes
        flops = 4 * _pairs(mask, b, sq, skv, 12, causal) * 64
        bound_ms, bound_by = _bound(nbytes, flops)
        log("time %-19s bfloat16 %s %.4f ms, device %.4f ms (%s; no %s in "
            "the trace), bound %.4f ms by %s; plain twin %.4f ms; SDPA "
            "forward %.4f ms (%s)" % (name, wrapper.__name__, ms, dev,
                                      want_name, refused, bound_ms, bound_by,
                                      plain_ms, lib_ms, backend))
        timings[(wrapper.__name__, name, torch.bfloat16)] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
            bound_by=bound_by, device_ms=dev)
        del q, k, v, tq, tk, tv
        torch.cuda.empty_cache()


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
            nbytes = _attention_bytes(mask, b, sq, skv, h, d, causal,
                                      tq.element_size()) + b * h * sq * 4
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


PROFILE_ATTEMPTS = 6
PROFILE_PAD_S = 0.05   # a retried session's idle margin, doubled each time
PROFILE_LOST_RC = 75   # phase 2's child: the profiler recorded no kernel


class ProfilerLost(AssertionError):
    """Every profiler session of a check recorded no device kernel at all
    (the profiler's fault, not a route's: a wrong route shows as other
    kernels in the record)."""


def _device_ms(torch, fn, calls=5, want=()):
    """{kernel name: device ms per call} of `calls` calls of fn: the device
    kernels of torch.profiler's key_averages (PyTorch's operators, which
    hold their kernels' time again, left out). On an H100 a short session
    of small kernels has now and then recorded none of the kernels that ran
    (the launch counts and CUDA-event times say they ran; Kineto keeps only
    device records whose timestamps, moved onto the host's clock, fall
    inside the session). So a session whose record lacks a kernel named in
    `want` runs again, up to PROFILE_ATTEMPTS times, each retry inside a
    wider idle margin (PROFILE_PAD_S, doubled each time) before its calls
    and after its synchronize; _routed then judges the last record."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        pad = 0.0 if attempt == 1 else PROFILE_PAD_S * 2 ** (attempt - 2)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
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
    if not times:
        raise ProfilerLost("every profiler session of %s recorded no device "
                           "kernel (wanted %s)" % (what, missing))
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
        nbytes = _attention_bytes(mask, b, sq, skv, h, d, causal,
                                  tq.element_size(), backward=True) \
            + lse.numel() * 4
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
                ("flash_attention_bwd_dkdv", "dkdv", 4, ("dk", "dv")),
                ("flash_attention_bwd_dq", "dq", 3, ("dq",))):
            if parts is None:
                continue
            part_bytes = _attention_bytes(
                mask, b, sq, skv, h, d, causal, tq.element_size(),
                backward=True, written=written) + lse.numel() * 4
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
    nbytes = _attention_bytes(mask, b, sq, skv, h, d, causal,
                              tq.element_size(), backward=True)
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
    # the rest in turns on the same card: K P P K, the first K above (K P P
    # K K P P K until slice 14)
    for use_kernel in (False, False, True):
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
              profile_dir=None, common=None, logging_steps=1,
              keep_trainer=False):
    """One --mode=train run; `common` replaces text_classify's flags
    (_common_argv); keep_trainer keeps the trainer (its model and
    optimizer) in the summary."""
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    argv = ["--mode=train", "--tables=%s,%s" % (train_tsv, dev_tsv)
            if dev_tsv else "--tables=" + train_tsv,
            "--pretrained_model_name_or_path=" + model_dir,
            "--epoch_num=1", "--learning_rate=%g" % LEARNING_RATE,
            "--optimizer_type=AdamW", "--logging_steps=%d" % logging_steps,
            "--random_seed=%d" % seed] + (
                _common_argv(use_kernel) if common is None else common)
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
            "trainer": trainer if keep_trainer else None,
            "save_s": trainer.save_seconds,
            "skips": trainer.nonfinite_skips,
            "total_s": time.perf_counter() - t0,
            "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}


def describe_train(tag, run, batch=BATCH):
    ms = [1e3 * r["seconds"] for r in run["records"]]
    log("train %-7s %d steps x %d samples: step ms median %.3f, first %.3f, "
        "min %.3f, max %.3f (CUDA events: the end of the step before, or the "
        "fetch of the first batch, to the end of this step's update); %.2f "
        "samples/s at the median step; run with load, eval "
        "and checkpoint %.3f s; checkpoint write %s s; peak device memory "
        "%.3f GiB above the run's start; losses %s"
        % (tag, len(ms), batch, statistics.median(ms), ms[0], min(ms),
           max(ms), 1e3 * batch / statistics.median(ms), run["total_s"],
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
    # then a plain run (K P P K until slice 14), the K above; it writes no
    # checkpoint (the card's machine caps a run's disk writes)
    for use_kernel in (False,):
        before = (A.short_attention_fwd.launches,
                  A.short_attention_bwd.launches)
        run = run_train(torch, model_dir, train_tsv, dev_tsv, None,
                        use_kernel, seed)
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


def run_generate(torch, model_dir, tsv, out, use_kernel, udp,
                 dtype="bfloat16"):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    argv = ["--mode=predict", "--app_name=sequence_generation",
            "--device=cuda", "--dtype=" + dtype,
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
    # then a plain run (K P P K until slice 14), the K above
    for use_kernel in (False,):
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
    for use_kernel in (True, False):  # K P P K until slice 14
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
BART_DEV_ROWS = 8               # 16 until slice 14
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
                   profile_dir=None, extra=()):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    argv = ["--mode=train", "--tables=" + train_tsv,
            "--pretrained_model_name_or_path=" + model_dir,
            "--epoch_num=1", "--learning_rate=%g" % BART_LR,
            "--optimizer_type=AdamW", "--logging_steps=1",
            "--random_seed=%d" % seed] + _bart_argv(use_kernel) + list(extra)
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
    # then a plain run (K P P K until slice 14), the K above
    for use_kernel in (False,):
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
    return launches, runs["kernel"][0]


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
    for use_kernel in (True, False):  # K P P K until slice 14
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


# --------------------------------------------------------------------------
# phase 9: GPT-2 /generate (--mode=serve, serve_continuous=true)
# --------------------------------------------------------------------------

def serve_workload(seed):
    """SERVE_REQUESTS + SERVE_STREAMS (prompt ids, max_new_tokens): prompts
    of 64..256 tokens (the first 256) drawn from the merged tokens of the
    synthetic vocabulary, 16..128 new tokens each, so slots retire and
    refill mid-flight."""
    rng = random.Random(seed)
    out = []
    for i in range(SERVE_REQUESTS + SERVE_STREAMS):
        n = SERVE_BUCKET if i == 0 else rng.randint(64, SERVE_BUCKET)
        out.append(([rng.randrange(256, GPT2_SMALL["vocab_size"] - 1)
                     for _ in range(n)], rng.randint(16, 128)))
    return out


def _post_generate(port, payload):
    """One POST /generate from a client on 127.0.0.1: {'status', 'ids',
    'seconds', 'ttft'} (host clock; 'ttft' the first NDJSON event of a
    stream, else None)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", "/generate", body=json.dumps(payload),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200 or not payload.get("stream"):
            body = json.loads(resp.read())
            return {"status": resp.status, "body": body,
                    "ids": body.get("output_ids"), "ttft": None,
                    "seconds": time.perf_counter() - t0}
        events, ttft = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            if ttft is None:
                ttft = time.perf_counter() - t0
            events.append(json.loads(line))
        done = events[-1]
        if not done.get("done") or [e["token"] for e in events[:-1]] != \
                done["output_ids"]:
            raise AssertionError("stream events disagree with their done "
                                 "event: %s" % events[-2:])
        return {"status": 200, "body": done, "ids": done["output_ids"],
                "ttft": ttft, "seconds": time.perf_counter() - t0}
    finally:
        conn.close()


def _drive(port, payloads, clients):
    """Every payload POSTed from a pool of `clients` threads at once: (the
    results in order, wall seconds). Any status but 200 fails."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(clients) as pool:
        results = list(pool.map(lambda p: _post_generate(port, p), payloads))
    wall = time.perf_counter() - t0
    bad = [r for r in results if r["status"] != 200]
    if bad:
        raise AssertionError("/generate answered %d: %s"
                             % (bad[0]["status"], bad[0]["body"]))
    return results, wall


def start_generation_server(torch, model_dir, dtype, use_kernel, extra=""):
    """`--mode=serve` with serve_continuous=true on the card, not blocking
    (`extra`: more user_defined_parameters): (the GenerationServer, seconds
    to start it: model load, kernel build or load, batcher)."""
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    udp = ("serve_continuous=true serve_blocking=False serve_port=0 "
           "serve_slots=%d serve_chunk_size=%d %s"
           % (SERVE_SLOTS, SERVE_CHUNK, extra)).strip()
    argv = ["--mode=serve", "--checkpoint_dir=" + model_dir,
            "--device=cuda", "--dtype=" + dtype,
            "--sequence_length=%d" % SERVE_WINDOW,
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false"),
            "--user_defined_parameters=" + udp]
    t0 = time.perf_counter()
    srv = default_main_fn(initialize_easynlp(args_list=argv))
    return srv, time.perf_counter() - t0


def _pct(values, q):
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def describe_serving(tag, results, wall, timings):
    """Log tokens/s, TTFT and ms per output token of one load; returns
    tokens/s. `timings`: the server's (first-token s, last-token s,
    tokens) per request, host clock from submit."""
    n = sum(len(r["ids"]) for r in results)
    ttft = [1e3 * a for a, _, _ in timings]
    tpot = [1e3 * (b - a) / (k - 1) for a, b, k in timings if k > 1]
    lat = [1e3 * r["seconds"] for r in results]
    client = [1e3 * r["ttft"] for r in results if r["ttft"] is not None]
    log("serve %-7s %d requests (%d streamed) from %d clients: %d generated "
        "tokens in %.4f s = %.2f tokens/s; TTFT p50 %.3f ms, p95 %.3f "
        "(server, submit to first token; streamed, client-side: %s ms); ms "
        "per output token p50 %.3f, p95 %.3f; request latency p50 %.3f ms, "
        "p95 %.3f (host clock)"
        % (tag, len(results), len(client), SERVE_CLIENTS, n, wall, n / wall,
           _pct(ttft, 50), _pct(ttft, 95),
           " ".join("%.3f" % x for x in client), _pct(tpot, 50),
           _pct(tpot, 95), _pct(lat, 50), _pct(lat, 95)))
    return n / wall


def _greedy_reference(torch, model, work, pad, dtype_tag):
    """Standalone greedy decoding of each (prompt, n) in `work`, 8 rows a
    batch, left-padded to the bucket as the batcher pads, over a
    SERVE_WINDOW-slot cache (the batcher's decode shape): (tokens per
    request, cut after the first EOS; the top-2 logit margin at each
    step)."""
    import numpy as np
    from easynlp_tpu_torch.modelzoo.generation_utils import left_pad
    from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns)
    eos = GPT2_SMALL["eos_token_id"]
    prefill, decode = make_gpt2_generation_fns(model, SERVE_WINDOW)
    tokens, margins = [], []
    with torch.inference_mode():
        for s in range(0, len(work), SERVE_SLOTS):
            group = work[s:s + SERVE_SLOTS]
            ids, mask = left_pad([p for p, _ in group], pad,
                                 length=SERVE_BUCKET)
            logits, cache = prefill(torch.from_numpy(ids).cuda().long(),
                                    torch.from_numpy(mask).cuda())
            steps, gaps = [], []
            n_max = max(n for _, n in group)
            for j in range(n_max):
                top2 = logits.topk(2, dim=-1).values
                gaps.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
                tok = logits.argmax(-1)
                steps.append(tok.cpu().numpy())
                if j + 1 < n_max:
                    logits, cache = decode(tok[:, None], cache)
            steps, gaps = np.stack(steps, 1), np.stack(gaps, 1)
            for row, (_, n) in enumerate(group):
                seq = steps[row, :n].tolist()
                if eos in seq:
                    seq = seq[:seq.index(eos) + 1]
                tokens.append(seq)
                margins.append(gaps[row, :n])
    log("standalone %s greedy decoding of %d requests (8 a batch, %d-slot "
        "cache) done" % (dtype_tag, len(work), SERVE_WINDOW))
    return tokens, margins


def _teacher_forced_logits(torch, model, prompts, outs, pad):
    """f32 logits [n, V] at each generated position of each request (the
    prompt left-padded to the bucket, then its generated tokens), one
    forward per 8 requests, through whatever attention path is set."""
    import numpy as np
    from easynlp_tpu_torch.modelzoo.generation_utils import left_pad
    logits = []
    with torch.inference_mode():
        for s in range(0, len(prompts), SERVE_SLOTS):
            ids, mask = left_pad(prompts[s:s + SERVE_SLOTS], pad,
                                 length=SERVE_BUCKET)
            n_max = max(len(o) for o in outs[s:s + SERVE_SLOTS])
            gen = np.full((len(ids), n_max), pad, np.int64)
            gmask = np.zeros((len(ids), n_max), np.int32)
            for row, o in enumerate(outs[s:s + SERVE_SLOTS]):
                gen[row, :len(o)] = o
                gmask[row, :len(o)] = 1
            seq = torch.from_numpy(np.concatenate([ids, gen], 1)).cuda()
            m = torch.from_numpy(np.concatenate([mask, gmask], 1)).cuda()
            out = model(seq, attention_mask=m)["logits"]
            for row, o in enumerate(outs[s:s + SERVE_SLOTS]):
                logits.append(out[row, SERVE_BUCKET - 1:SERVE_BUCKET - 1
                                  + len(o)].float())
            del out
    return logits


def _first_divergence(a, b):
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def phase_serving(torch, seed, workdir):
    import numpy as np
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    from easynlp_tpu_torch.modelzoo.quantization import cast_params
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 9: GPT-2 /generate (--mode=serve, serve_continuous=true; "
        "GPT-2 small, %d slots, chunk %d, %d-slot window, bucket %d)"
        % (SERVE_SLOTS, SERVE_CHUNK, SERVE_WINDOW, SERVE_BUCKET))
    model_dir = os.path.join(workdir, GPT2_MODEL_DIR)  # phase 5's
    eos = GPT2_SMALL["eos_token_id"]
    work = serve_workload(seed)
    prompts = [p for p, _ in work]
    load = [{"prompt_ids": p, "max_new_tokens": n} for p, n in work]
    for payload in load[SERVE_REQUESTS:]:
        payload["stream"] = True
    log("workload: %d requests of %d..%d prompt tokens (mean %.1f), "
        "%d..%d new tokens (sum %d), the last %d streamed"
        % (len(work), min(map(len, prompts)), max(map(len, prompts)),
           np.mean([len(p) for p in prompts]), min(n for _, n in work),
           max(n for _, n in work), sum(n for _, n in work), SERVE_STREAMS))
    sampled = [dict(load[i], max_new_tokens=48, do_sample=True,
                    temperature=0.9, top_k=50, top_p=0.95, seed=seed + i,
                    stream=False) for i in range(SERVE_SAMPLED)]
    wrappers = ("short_attention_fwd", "flash_attention_fwd")
    real_reference = A.attention_reference
    reference_calls = [0]

    def counted_reference(*args, **kwargs):
        reference_calls[0] += 1
        return real_reference(*args, **kwargs)
    A.attention_reference = counted_reference
    try:
        # the main path: bf16 with the kernels; two warm-up requests, then
        # every count set to 0 just before the load and read just after
        srv, start_s = start_generation_server(torch, model_dir, "bfloat16",
                                               True)
        pad = srv.batcher.pad
        _drive(srv.port, load[:2], 2)
        for w in wrappers:
            getattr(A, w).launches = 0
        reference_calls[0] = 0
        srv.timings.clear()
        results, wall = _drive(srv.port, load, SERVE_CLIENTS)
        launches = {w: getattr(A, w).launches for w in wrappers}
        refs = reference_calls[0]
        timings = list(srv.timings)
        log("server up in %.3f s (model load, kernels, batcher); main run's "
            "launches: short_attention_fwd (B1, the admits) %d, "
            "flash_attention_fwd (B3, the decode steps) %d; "
            "attention_reference calls %d"
            % (start_s, launches["short_attention_fwd"],
               launches["flash_attention_fwd"], refs))
        n_layer = GPT2_SMALL["n_layer"]
        if refs or any(n == 0 or n % n_layer for n in launches.values()):
            raise AssertionError("the serving path launched %s and called "
                                 "attention_reference %d times" % (launches,
                                                                   refs))
        rate = describe_serving("kernel", results, wall, timings)
        main_ids = [r["ids"] for r in results]
        for r, (p, n) in zip(results, work):
            if not 1 <= len(r["ids"]) <= n or any(
                    not 0 <= t < GPT2_SMALL["vocab_size"] for t in r["ids"]) \
                    or (len(r["ids"]) < n and r["ids"][-1] != eos):
                raise AssertionError("a request for %d tokens got %s"
                                     % (n, r["ids"]))

        # 4 sampled requests twice, beside other co-tenants in other order
        first, _ = _drive(srv.port, sampled + load[4:8], 8)
        second, _ = _drive(srv.port, sampled[::-1] + load[8:16], 12)
        pairs = [(a["ids"], b["ids"]) for a, b in
                 zip(first[:SERVE_SAMPLED], second[SERVE_SAMPLED - 1::-1])]
        if any(a != b for a, b in pairs):
            raise AssertionError("a sampled request gave other tokens beside "
                                 "other co-tenants: %s" % pairs)
        log("sampled requests (temperature 0.9, top-k 50, top-p 0.95): %d "
            "of %d identical across two co-tenancies (%s tokens)"
            % (len(pairs), SERVE_SAMPLED, [len(a) for a, _ in pairs]))

        # the profiler's word on 4 greedy requests: B3 and B1 on the
        # tensor cores, no CUDA-core walk, no softmax (attention_reference)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof_path = os.path.join(workdir, "serve_trace.json")
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            with torch.profiler.profile(activities=acts) as prof:
                _drive(srv.port, load[16:20], 4)
                torch.cuda.synchronize()
            times = {}
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA \
                        and e.device_time_total:
                    times[e.key] = times.get(e.key, 0.0) \
                        + e.device_time_total / 1e3
            if all(any(n in k for k in times)
                   for n in (FLASH_FWD_MMA_NAME, SHORT_FWD_MMA_NAME)):
                break
            log("profile: session %d lacks a serving kernel" % attempt)
        prof.export_chrome_trace(prof_path)
        parts = _routed("the serving path", times,
                        (("B3", FLASH_FWD_MMA_NAME),
                         ("B1", SHORT_FWD_MMA_NAME)),
                        (FLASH_FWD_CUDA_CORE_NAME, SHORT_FWD_CUDA_CORE_NAME))
        soft = sorted(k for k in times if "softmax" in k.lower())
        if soft:
            raise AssertionError("the greedy serving path ran %s "
                                 "(attention_reference)" % soft)
        share, busy_ms, top = device_share(prof_path)
        log("profile, 4 greedy requests (under the profiler): B3 %.3f ms, B1 "
            "%.3f ms of device time; no CUDA-core walk, no softmax; device "
            "busy %s of the span of its kernels, %.3f ms; top kernels: %s"
            % (parts["B3"], parts["B1"],
               "not measured" if share is None else "%.1f%%" % (100 * share),
               busy_ms or 0.0, "; ".join("%s %.3f" % (n[:50], t)
                                         for n, t in top[:6])))
        srv.stop()

        # the same load with --use_flash_attention=false, then in f32
        srv_p, _ = start_generation_server(torch, model_dir, "bfloat16",
                                           False)
        before = {w: getattr(A, w).launches for w in wrappers}
        plain, wall_p = _drive(srv_p.port, load, SERVE_CLIENTS)
        if {w: getattr(A, w).launches for w in wrappers} != before:
            raise AssertionError("--use_flash_attention=false still launched "
                                 "a kernel")
        rate_p = describe_serving("plain", plain, wall_p, list(srv_p.timings))
        srv_p.stop()
        srv_f, _ = start_generation_server(torch, model_dir, "float32", True)
        f32, wall_f = _drive(srv_f.port, load, SERVE_CLIENTS)
        describe_serving("f32", f32, wall_f, list(srv_f.timings))
        srv_f.stop()
    finally:
        A.attention_reference = real_reference
    log("tokens/s kernel %.2f against plain %.2f (one load each)"
        % (rate, rate_p))

    # f32 serving against standalone f32 greedy decoding: token-exact
    app32 = SequenceGeneration.from_pretrained(model_dir, dtype=torch.float32,
                                               device="cuda")
    want, gaps = _greedy_reference(torch, app32.module, work, pad, "f32")
    exact, ties = 0, 0
    for i, (r, w, g) in enumerate(zip(f32, want, gaps)):
        j = _first_divergence(r["ids"], w)
        if j is None:
            exact += 1
            continue
        if j >= len(g) or g[j] > SERVE_F32_TIE:
            raise AssertionError(
                "request %d: f32 serving diverges from standalone greedy at "
                "step %d (top-2 margin %s > %.0e): %s vs %s"
                % (i, j, g[j] if j < len(g) else "past the end",
                   SERVE_F32_TIE, r["ids"][:j + 2], w[:j + 2]))
        ties += 1
    log("f32 serving vs standalone f32 greedy: %d of %d requests identical, "
        "%d diverge at a near-tie (top-2 margin <= %.0e)"
        % (exact, len(work), ties, SERVE_F32_TIE))

    # kernel vs plain bf16 serving, where the plain run's margin decides
    app16 = SequenceGeneration.from_pretrained(model_dir,
                                               dtype=torch.bfloat16,
                                               device="cuda")
    cast_params(app16.module, torch.bfloat16)  # as the server casts
    plain_ids = [r["ids"] for r in plain]
    A.set_kernel_override(False)
    plain_logits = _teacher_forced_logits(torch, app16.module, prompts,
                                          plain_ids, pad)
    A.set_kernel_override(None)
    decided = compared = near = identical = 0
    for i, (a, b, lg) in enumerate(zip(main_ids, plain_ids, plain_logits)):
        top2 = lg.topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        j = _first_divergence(a, b)
        upto = len(b) if j is None else j
        compared += upto
        decided += int((margin[:upto] > 2 * GEN_LOGITS_ATOL).sum())
        if j is None:
            identical += 1
        elif j < len(margin) and margin[j] > 2 * GEN_LOGITS_ATOL:
            raise AssertionError(
                "request %d: kernel token %s, plain %s at step %d, at a "
                "top-2 margin of %.3e > %.1e" % (
                    i, a[j:j + 1], b[j:j + 1], j, margin[j],
                    2 * GEN_LOGITS_ATOL))
        else:
            near += 1
    log("kernel vs plain bf16 serving: %d of %d requests identical; %d "
        "steps compared before a divergence (%d at a plain teacher-forced "
        "top-2 margin > %.1e); %d diverge at a near-tie"
        % (identical, len(work), compared, decided, 2 * GEN_LOGITS_ATOL,
           near))

    # bf16 serving weights against f32 on the same prompts (ROADMAP C5):
    # token match, and the mean KL of the bf16 model's next-token
    # distribution from the f32 model's along the f32 run's tokens
    f32_ids = [r["ids"] for r in f32]
    match = [(_first_divergence(a, b) if _first_divergence(a, b) is not None
              else len(b)) / len(b) for a, b in zip(main_ids, f32_ids)]
    same = sum(x == y for a, b in zip(main_ids, f32_ids)
               for x, y in zip(a, b))
    total = sum(min(len(a), len(b)) for a, b in zip(main_ids, f32_ids))
    lg32 = _teacher_forced_logits(torch, app32.module, prompts, f32_ids, pad)
    lg16 = _teacher_forced_logits(torch, app16.module, prompts, f32_ids, pad)
    kl = torch.cat([_kl(torch, a, b) for a, b in zip(lg32, lg16)])
    log("bf16 serving weights vs f32 (C5; printed, not gated): token-match "
        "rate %.4f (mean share of each f32 output before the first "
        "divergence), %.4f of aligned positions equal (%d of %d); mean KL(f32 "
        "|| bf16) of the next-token distribution %.6e nats over %d positions "
        "(max %.6e)" % (float(np.mean(match)), same / max(total, 1), same,
                        total, kl.mean().item(), kl.numel(), kl.max().item()))
    del app32, app16, lg32, lg16, plain_logits
    torch.cuda.empty_cache()
    return rate


# --------------------------------------------------------------------------
# phase 10: the pipeline() PredictionServer
# --------------------------------------------------------------------------

def phase_prediction_server(torch, workdir):
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 10: the pipeline() PredictionServer (--mode=serve on "
        "phase 4's text_classify checkpoint)")
    ckpt = os.path.join(workdir, "ckpt_kernel")
    tsv = os.path.join(workdir, "train.tsv")
    with open(tsv, encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    texts = [r[1] for r in rows]
    srv, start_s = _cli(torch, [
        "--mode=serve", "--checkpoint_dir=" + ckpt,
        "--first_sequence=sentence", "--sequence_length=%d" % SEQ_LEN,
        "--micro_batch_size=%d" % BATCH, "--device=cuda", "--dtype=bfloat16",
        "--user_defined_parameters=serve_blocking=False serve_port=0 "
        "serve_max_delay_ms=5"])
    sizes = []
    pipe = srv.pipeline

    def recorded(inputs):
        sizes.append(len(inputs))
        return pipe(inputs)
    srv.pipeline = recorded
    per = len(texts) // PREDICT_SERVE_REQUESTS
    chunks = [texts[i:i + per] for i in range(0, len(texts), per)]

    def post(inputs):
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=600)
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/predict",
                         body=json.dumps({"inputs": inputs}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
        finally:
            conn.close()
        if resp.status != 200:
            raise AssertionError("/predict answered %d: %s"
                                 % (resp.status, body))
        return body["outputs"], time.perf_counter() - t0
    # one warm-up request, then the counts set to 0 just before the load
    post(chunks[0][:1])
    sizes.clear()
    A.short_attention_fwd.launches = 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(chunks)) as pool:
        answers = list(pool.map(post, chunks))
    wall = time.perf_counter() - t0
    launches = A.short_attention_fwd.launches
    srv.stop()
    got = [row for outs, _ in answers for row in outs]
    lat = [1e3 * s for _, s in answers]
    log("served %d rows in %d requests from %d clients in %.4f s = %.2f "
        "rows/s (server up in %.3f s); request latency p50 %.3f ms, p95 "
        "%.3f; %d pipeline batches, sizes %s; short_attention_fwd launches "
        "%d" % (len(got), len(chunks), len(chunks), wall, len(got) / wall,
                start_s, _pct(lat, 50), _pct(lat, 95), len(sizes),
                sorted(sizes, reverse=True), launches))
    if len(got) != len(texts) or sum(sizes) != len(texts) \
            or max(sizes) > BATCH or launches != N_LAYERS * len(sizes):
        raise AssertionError("%d rows back for %d, batches %s, %d launches"
                             % (len(got), len(texts), sizes, launches))
    # --mode=predict over the same rows: logits within PREDICT_SERVE_ATOL,
    # labels equal where its margin decides
    out = os.path.join(workdir, "pred_served_rows.tsv")
    _cli(torch, ["--mode=predict", "--tables=" + tsv, "--outputs=" + out,
                 "--checkpoint_dir=" + ckpt,
                 "--output_schema=predictions,probabilities,logits",
                 "--append_cols=id"] + _common_argv(True))
    labels, _, logits = check_output(out, len(texts))
    served = np.array([[float(x) for x in r["logits"].split()] for r in got])
    d = np.abs(served - logits).max()
    margin = np.abs(logits[:, 0] - logits[:, 1])
    decided = margin > 2 * PREDICT_SERVE_ATOL
    wrong = [i for i in np.nonzero(decided)[0]
             if got[i]["predictions"] != labels[i]]
    same = sum(g["predictions"] == x for g, x in zip(got, labels))
    # rows whose logits lie over 2 x the bound from every row of the other
    # requests: a mix-up between requests that hands one of them on fails
    request = np.arange(len(got)) // per
    gaps = np.abs(logits[:, None, :] - logits[None, :, :]).max(-1)
    apart = int(((gaps > 2 * PREDICT_SERVE_ATOL)
                 | (request[:, None] == request[None, :])).all(1).sum())
    log("served vs --mode=predict: logits max |d| %.3e (bound %.1e); %d of "
        "%d rows lie over 2 x the bound from every row of the other requests; "
        "labels agree on %d of %d rows, on all %d the predict margin decides "
        "(> 2 x the bound)" % (d, PREDICT_SERVE_ATOL, apart, len(got), same,
                              len(got), int(decided.sum())))
    if d > PREDICT_SERVE_ATOL or wrong:
        raise AssertionError("served rows disagree with --mode=predict: "
                             "logit gap %.3e, rows %s" % (d, wrong))


# --------------------------------------------------------------------------
# phase 11: MLM pretraining (language_modeling) and data_augmentation
# --------------------------------------------------------------------------

ROBERTA_BASE = {  # HF roberta-base config.json
    "model_type": "roberta", "architectures": ["RobertaForMaskedLM"],
    "vocab_size": 50265, "hidden_size": 768, "num_hidden_layers": 12,
    "num_attention_heads": 12, "intermediate_size": 3072,
    "max_position_embeddings": 514, "type_vocab_size": 1,
    "hidden_act": "gelu", "layer_norm_eps": 1e-5, "initializer_range": 0.02,
    "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
    "pad_token_id": 1, "bos_token_id": 0, "eos_token_id": 2,
}
MLM_MODEL_DIR = "bert-base-chinese-mlm"
ROBERTA_MODEL_DIR = "roberta-base-random"
ROBERTA_SEQ_LEN = 512
ROBERTA_BATCH = 8
ROBERTA_STEPS = 4
AUG_COUNT = 2
# MLM, the kernel run against the --use_flash_attention=false run: both bf16,
# the same weights, batches, masks and dropout draws, differing only in
# attention's rounding, about a bf16 ulp (2^-8 relative) per layer. A
# token's cross-entropy, logsumexp minus the gold logit, moves by at most
# twice the largest logit change; 12 layers move the logits by ~1e-2 (phase
# 3 measured 6.7e-3 on its classifier, and phase 5 bounds GPT-2's at 5e-2).
# Bound 5e-2 on the step-1 loss, a mean over the masked tokens, and on the
# log of the evaluated perplexity (exp of such a mean, after 8 steps in
# which the two runs' weights drift apart by less than the learning rate's
# 5e-5 x 8). Accuracy changes only where the argmax flips at a top-2 margin
# below that change: at most 1e-2 of the masked tokens.
MLM_LOSS_ATOL = 5e-2
MLM_ACCURACY_ATOL = 1e-2


def make_mlm_model_dir(torch, workdir, seed):
    """phase 3's BERT-base directory as a masked LM: its backbone (pooler
    included, which the MLM app drops) and an MLM head under HF names,
    `cls.predictions.transform.dense` truncated-normal(0.02) from the seed,
    a unit LayerNorm, zero biases; the decoder is the word embeddings."""
    import shutil

    import numpy as np
    src = os.path.join(workdir, MODEL_DIR)
    dst = os.path.join(workdir, MLM_MODEL_DIR)
    os.makedirs(dst, exist_ok=True)
    for name in ("config.json", "vocab.txt"):
        shutil.copy(os.path.join(src, name), dst)
    state = {k: v for k, v in torch.load(
        os.path.join(src, "pytorch_model.bin"), weights_only=True).items()
        if not k.startswith("classifier.")}
    e, v = BERT_BASE_CHINESE["hidden_size"], BERT_BASE_CHINESE["vocab_size"]
    rng = np.random.default_rng(seed + 11)
    head = "cls.predictions."
    state[head + "transform.dense.weight"] = torch.from_numpy(
        _truncated_normal(rng, (e, e), BERT_BASE_CHINESE["initializer_range"]))
    state[head + "transform.dense.bias"] = torch.zeros(e)
    state[head + "transform.LayerNorm.weight"] = torch.ones(e)
    state[head + "transform.LayerNorm.bias"] = torch.zeros(e)
    state[head + "bias"] = torch.zeros(v)
    torch.save(state, os.path.join(dst, "pytorch_model.bin"))
    return dst


def roberta_vocab():
    """(tokens in id order, merges): roberta-base's specials where it has
    them (<s> 0, <pad> 1, </s> 2, <unk> 3, <mask> last), around
    gpt2_vocab()'s synthetic byte-level BPE tokens."""
    tokens, merges = gpt2_vocab()
    tokens = (["<s>", "<pad>", "</s>", "<unk>"] + tokens
              + ["<extra_%d>" % i for i in range(3)] + ["<mask>"])
    assert len(tokens) == ROBERTA_BASE["vocab_size"]
    return tokens, merges


def make_roberta_model_dir(torch, path, seed):
    """roberta-base widths and depth, the synthetic vocabulary, and
    truncated-normal(0.02) weights from numpy under HF names (`roberta.*`,
    `lm_head.*`, the decoder tied to the word embeddings), zero biases,
    unit LayerNorms."""
    import numpy as np
    os.makedirs(path, exist_ok=True)
    c = ROBERTA_BASE
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f, indent=2)
    tokens, merges = roberta_vocab()
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join("%s %s\n" % m for m in merges))
    rng = np.random.default_rng(seed + 12)
    e, inter = c["hidden_size"], c["intermediate_size"]
    state = {}

    def put(name, *shape, fill=None):
        arr = (np.full(shape, fill, np.float32) if fill is not None
               else _truncated_normal(rng, shape, c["initializer_range"]))
        state[name] = torch.from_numpy(arr)

    def dense(name, n_out, n_in):
        put(name + ".weight", n_out, n_in)
        put(name + ".bias", n_out, fill=0.0)

    def norm(name):
        put(name + ".weight", e, fill=1.0)
        put(name + ".bias", e, fill=0.0)

    emb = "roberta.embeddings."
    put(emb + "word_embeddings.weight", c["vocab_size"], e)
    put(emb + "position_embeddings.weight", c["max_position_embeddings"], e)
    put(emb + "token_type_embeddings.weight", c["type_vocab_size"], e)
    norm(emb + "LayerNorm")
    for i in range(c["num_hidden_layers"]):
        base = "roberta.encoder.layer.%d." % i
        for proj in ("query", "key", "value"):
            dense(base + "attention.self." + proj, e, e)
        dense(base + "attention.output.dense", e, e)
        norm(base + "attention.output.LayerNorm")
        dense(base + "intermediate.dense", inter, e)
        dense(base + "output.dense", e, inter)
        norm(base + "output.LayerNorm")
    dense("lm_head.dense", e, e)
    norm("lm_head.layer_norm")
    put("lm_head.bias", c["vocab_size"], fill=0.0)
    state["lm_head.decoder.weight"] = state[emb + "word_embeddings.weight"]
    torch.save(state, os.path.join(path, "pytorch_model.bin"))


def make_roberta_tsv(path, tokenizer, seed, n_rows):
    """n_rows texts of random lowercase words, each grown until it is at
    least a drawn 254..600 tokens long (the first row 600): truncated to
    510 + <s> and </s>, the rows hold 256..512 real tokens."""
    rng = random.Random(seed)
    targets = [600] + [rng.randint(254, 600) for _ in range(n_rows - 1)]
    with open(path, "w", encoding="utf-8") as f:
        for i, target in enumerate(targets):
            words, n = [], 0
            while n < target:
                word = "".join(rng.choice(GEN_LETTERS)
                               for _ in range(rng.randint(2, 9)))
                n += len(tokenizer.tokenize((" " if words else "") + word))
                words.append(word)
            f.write("%d\t%s\n" % (i, " ".join(words)))


def _mlm_argv(use_kernel, prefetch, roberta=False):
    if roberta:
        shape = ["--sequence_length=%d" % ROBERTA_SEQ_LEN,
                 "--micro_batch_size=%d" % ROBERTA_BATCH,
                 "--input_schema=id:str:1,text:str:1",
                 "--first_sequence=text"]
    else:  # phase 4's TSVs
        shape = ["--sequence_length=%d" % SEQ_LEN,
                 "--micro_batch_size=%d" % BATCH,
                 "--input_schema=id:str:1,sentence:str:1,label:str:1",
                 "--first_sequence=sentence"]
    return ["--app_name=language_modeling", "--device=cuda",
            "--dtype=bfloat16", "--num_host_prefetch=%d" % prefetch,
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false")
            ] + shape


def _check_train_run(tag, run, steps):
    import numpy as np
    recs = run["records"]
    if len(recs) != steps or run["skips"]:
        raise AssertionError("%s run: %d steps, %d non-finite skips"
                             % (tag, len(recs), run["skips"]))
    if not np.isfinite([[r["loss"], r["grad_norm"]] for r in recs]).all():
        raise AssertionError("%s run: non-finite loss or grad norm" % tag)


def depth_cut(torch, src, dst, layers, key):
    """dst: model directory src cut to its first `layers` layers at full
    width: every file but the weights and optimizer state copied,
    config.json's `key` set to `layers`, and pytorch_model.bin without the
    parameters of layer `layers` on (`.layers.{i}.`, BERT's `.layer.{i}.`)."""
    import re
    import shutil
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        if name not in ("pytorch_model.bin", "optimizer.pt") and \
                os.path.isfile(os.path.join(src, name)):
            shutil.copy(os.path.join(src, name), dst)
    with open(os.path.join(src, "config.json")) as f:
        config = json.load(f)
    config[key] = layers
    with open(os.path.join(dst, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    state = torch.load(os.path.join(src, "pytorch_model.bin"),
                       weights_only=True)
    deep = re.compile(r"\.layers?\.(\d+)\.")
    torch.save({k: v for k, v in state.items()
                if not deep.search(k) or int(deep.search(k).group(1))
                < layers}, os.path.join(dst, "pytorch_model.bin"))


def check_repeat(tag, first, again):
    """Two kernel runs of one training give the same loss and gradient norm
    at every step, bit for bit (ROADMAP C28, C29: T5's and Kangaroo's did
    not before their one-hot row lookups)."""
    a = [(r["loss"], r["grad_norm"]) for r in first["records"]]
    b = [(r["loss"], r["grad_norm"]) for r in again["records"]]
    log("%s training repeated with the kernels: %d steps, every loss and "
        "grad norm %s" % (tag, len(a), "bit-identical" if a == b else
                          "DIFFERENT: %s against %s" % (b, a)))
    if a != b:
        raise AssertionError("%s: two runs of one training differ" % tag)


def _profiled_share(torch, run, prof, want):
    """(device busy share, busy ms per step, top kernels) of `run(prof)`
    (a training run writing a trace of steps 3-6 into prof), run again
    while the trace lacks a kernel named in `want` (see _device_ms)."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        run(prof)
        share, busy_ms, top = device_share(os.path.join(prof, "trace.json"))
        missing = [n for n in want if not any(n in k for k, _ in top)]
        if share is not None and not missing:
            return share, busy_ms / 4, top
        log("profile: run %d recorded %d kernels, lacking %s"
            % (attempt, len(top), missing or "all"))
    raise AssertionError("no profiler trace of %s holds %s" % (prof, want))


def _augment_decided(torch, ckpt, dev_tsv, texts):
    """Phase 11's data_augmentation check in-process on the checkpoint:
    the predictor's masks over the dev rows (the CLI's, which preprocesses
    the whole table in one slice), its refilled ids with the kernels and
    without, and the plain logits' top-2 margins at the masked positions.
    Returns (kernel texts, decided [copies, S], kernel ids, plain ids,
    chosen)."""
    import numpy as np
    from easynlp_tpu_torch.appzoo.data_augmentation.predictor import (
        DataAugmentationPredictor)
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        LanguageModeling)
    from easynlp_tpu_torch.ops import attention as A
    app = LanguageModeling.from_pretrained(ckpt, dtype=torch.bfloat16,
                                           device="cuda")
    predictor = DataAugmentationPredictor(
        ckpt, app, first_sequence="sentence", sequence_length=SEQ_LEN,
        batch_size=BATCH, augment_count=AUG_COUNT)
    pre = predictor.preprocess({"sentence": texts})
    keys = ("input_ids", "attention_mask", "token_type_ids")
    ids, margin = {}, None
    try:
        for use_kernel in (True, False):
            A.set_kernel_override(None if use_kernel else False)
            out, gaps = [], []
            with torch.inference_mode():
                for start in range(0, len(pre["input_ids"]), BATCH):
                    batch = {k: torch.from_numpy(
                        pre[k][start:start + BATCH]).cuda() for k in keys}
                    logits = app.forward(batch)["logits"]
                    out.append(logits.argmax(-1).cpu().numpy())
                    top2 = logits.float().topk(2, dim=-1).values
                    gaps.append((top2[..., 0] - top2[..., 1]).cpu().numpy())
            ids[use_kernel] = np.concatenate(out)
            if not use_kernel:
                margin = np.concatenate(gaps)
    finally:
        A.set_kernel_override(None)
    chosen = pre["_chosen"]
    texts_k = predictor.postprocess({"predicted_ids": ids[True],
                                     "_chosen": chosen,
                                     "_orig_ids": pre["_orig_ids"]})
    decided = chosen & (margin > 2 * SLICE_ATOL)
    return texts_k["augmented"], decided, ids[True], ids[False], chosen


def phase_mlm(torch, seed, workdir):
    """Phase 11. Returns the launches of each counted wrapper in the main
    path's runs (BERT-base and RoBERTa-base training with the kernels, and
    data_augmentation predict), each counted from 0."""
    import numpy as np
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.modelzoo.models.bert import RobertaTokenizer
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    log("== phase 11: MLM pretraining (language_modeling on BERT-base and "
        "RoBERTa-base) and data_augmentation predict")
    t0 = time.perf_counter()
    model_dir = make_mlm_model_dir(torch, workdir, seed)
    train_tsv = os.path.join(workdir, "train.tsv")  # phase 4's rows
    dev_tsv = os.path.join(workdir, "dev.tsv")
    steps, eval_batches = N_ROWS // BATCH, -(-N_DEV_ROWS // BATCH)
    counted = ("short_attention_fwd", "short_attention_bwd")
    launches = dict.fromkeys(counted, 0)

    def main_path(what, fn, want):
        """fn() with the counts set to 0 just before and read just after;
        raises unless they are `want`."""
        for w in counted:
            getattr(A, w).launches = 0
        out = fn()
        used = {w: getattr(A, w).launches for w in counted}
        log("%s launches: %s (want %s)" % (what, used, want))
        if used != want:
            raise AssertionError("%s launched %s, want %s"
                                 % (what, used, want))
        for w in counted:
            launches[w] += used[w]
        return out

    def no_launch(what, fn):
        before = {w: getattr(A, w).launches for w in counted}
        out = fn()
        if {w: getattr(A, w).launches for w in counted} != before:
            raise AssertionError("%s (--use_flash_attention=false) launched "
                                 "a kernel" % what)
        return out

    def bert(use_kernel, prefetch, ckpt=None, profile_dir=None):
        return run_train(torch, model_dir, train_tsv,
                         dev_tsv if ckpt else None, ckpt, use_kernel, seed,
                         profile_dir=profile_dir,
                         common=_mlm_argv(use_kernel, prefetch),
                         logging_steps=steps)

    log("BERT-base MLM directory made from seed %d in %.3f s"
        % (seed, time.perf_counter() - t0))
    ckpt_k = os.path.join(workdir, "mlm_ckpt_kernel")
    ckpt_p = os.path.join(workdir, "mlm_ckpt_plain")
    runs = {"kernel": main_path(
        "BERT-base MLM training (8 steps + evaluation)",
        lambda: bert(True, 2, ckpt_k),
        {"short_attention_fwd": N_LAYERS * (steps + eval_batches),
         "short_attention_bwd": N_LAYERS * steps})}
    runs["plain"] = no_launch("BERT-base MLM training",
                              lambda: bert(False, 2, ckpt_p))
    # prefetch off and on in turns after the counted run: 0, 0, 2
    for tag, prefetch in (("pf0#1", 0), ("pf0#2", 0), ("pf2#2", 2)):
        runs[tag] = bert(True, prefetch)
    for tag, run in runs.items():
        _check_train_run(tag, run, steps)
        describe_train(tag, run)
    k1, p1 = runs["kernel"]["records"][0], runs["plain"]["records"][0]
    log("BERT-base MLM step 1, kernel vs plain: loss %.6f vs %.6f, |d| %.3e "
        "(bound %.1e)" % (k1["loss"], p1["loss"], abs(k1["loss"]
                                                      - p1["loss"]),
                          MLM_LOSS_ATOL))
    if abs(k1["loss"] - p1["loss"]) > MLM_LOSS_ATOL:
        raise AssertionError("kernel and plain MLM runs disagree at step 1")
    trajectories = {tag: [(r["loss"], r["grad_norm"])
                          for r in runs[tag]["records"]]
                    for tag in ("kernel", "pf0#1", "pf0#2", "pf2#2")}
    same = all(t == trajectories["kernel"] for t in trajectories.values())
    log("prefetch 2 (two runs) vs 0 (two runs): (loss, grad norm) per step "
        "identical in all four: %s" % same)
    if not same:
        raise AssertionError("the kernel runs at --num_host_prefetch=2 and "
                             "=0 trained differently: %s" % trajectories)

    results = {}
    for tag, ckpt, use_kernel in (("kernel", ckpt_k, True),
                                  ("plain", ckpt_p, False)):
        results[tag] = dict(default_main_fn(initialize_easynlp(args_list=[
            "--mode=evaluate", "--tables=" + dev_tsv,
            "--checkpoint_dir=" + ckpt] + _mlm_argv(use_kernel, 2))))
    final = [r for r in map(json.loads, open(os.path.join(
        ckpt_k, "events.jsonl"))) if r["kind"] == "eval"][-1]
    for metric in ("accuracy", "perplexity"):
        if abs(final[metric] - results["kernel"][metric]) \
                > 1e-9 * abs(final[metric]):
            raise AssertionError("evaluate disagrees with the trainer's "
                                 "final evaluation: %s vs %s"
                                 % (results["kernel"], final))
    k, p = results["kernel"], results["plain"]
    d_acc = abs(k["accuracy"] - p["accuracy"])
    d_ppl = abs(np.log(k["perplexity"] / p["perplexity"]))
    log("BERT-base MLM evaluate (%d dev rows), kernel vs plain checkpoint: "
        "accuracy %.6f vs %.6f (|d| %.3e, bound %.1e), perplexity %.4f vs "
        "%.4f (|d log| %.3e, bound %.1e; reported negated)"
        % (N_DEV_ROWS, k["accuracy"], p["accuracy"], d_acc,
           MLM_ACCURACY_ATOL, -k["perplexity"], -p["perplexity"], d_ppl,
           MLM_LOSS_ATOL))
    if not (k["perplexity"] < 0 and np.isfinite(list(k.values())).all()) \
            or d_acc > MLM_ACCURACY_ATOL or d_ppl > MLM_LOSS_ATOL:
        raise AssertionError("MLM evaluation: %s vs %s" % (k, p))

    # the device's share of the steps, prefetch on and off, under the
    # profiler (steps 3-6 of a kernel run each)
    shares, busy = {}, {}
    for prefetch in (2, 0):
        share, busy_ms, top = _profiled_share(
            torch, lambda prof: bert(True, prefetch, profile_dir=prof),
            os.path.join(workdir, "mlm_profile_%d" % prefetch),
            (SHORT_FWD_MMA_NAME, SHORT_BWD_ONE_BLOCK_NAMES[0][1]))
        shares[prefetch], busy[prefetch] = share, busy_ms
        log("profile, BERT-base MLM kernel run, prefetch %d, steps 3-6: "
            "device busy %.1f%% of the span of its kernels, %.3f ms busy "
            "per step; device ms by kernel over the 4 steps: %s; attention "
            "kernels, device ms per step: %s"
            % (prefetch, 100 * share, busy_ms, "; ".join(
                "%s %.3f" % (n[:60], t) for n, t in top[:8]),
               attention_ms(top, 4)))
    med = {tag: statistics.median(1e3 * r["seconds"]
                                  for r in runs[tag]["records"])
           for tag in runs}
    log("BERT-base MLM step ms median per run: prefetch 2 %.3f (the "
        "counted run, first) and %.3f, prefetch 0 %.3f and %.3f, plain "
        "%.3f; device idle share of steps 3-6: %.1f%% (prefetch 2), %.1f%% "
        "(prefetch 0); peak device memory %.3f GiB (kernel) / %.3f GiB "
        "(plain)"
        % (med["kernel"], med["pf2#2"], med["pf0#1"], med["pf0#2"],
           med["plain"], 100 * (1 - shares[2]), 100 * (1 - shares[0]),
           runs["kernel"]["peak_gib"], runs["plain"]["peak_gib"]))
    # the profiler's own host cost stretches the profiled steps; the device
    # time per step it records against the unprofiled runs' step time
    for prefetch, tags in ((2, ("kernel", "pf2#2")), (0, ("pf0#1", "pf0#2"))):
        step_ms = statistics.median(med[t] for t in tags)
        log("BERT-base MLM prefetch %d: device idle %.1f%% of the unprofiled "
            "step (1 - %.3f ms busy per profiled step / %.3f ms, the median "
            "of its two runs' medians)" % (prefetch, 100 * (1 - busy[prefetch]
                                                            / step_ms),
                                          busy[prefetch], step_ms))

    # RoBERTa-base at 8 x 512
    t1 = time.perf_counter()
    rdir = os.path.join(workdir, ROBERTA_MODEL_DIR)
    make_roberta_model_dir(torch, rdir, seed)
    tokenizer = RobertaTokenizer.from_pretrained(rdir)
    r_tsv = os.path.join(workdir, "roberta_train.tsv")
    make_roberta_tsv(r_tsv, tokenizer, seed, ROBERTA_BATCH * ROBERTA_STEPS)
    with open(r_tsv, encoding="utf-8") as f:
        lengths = tokenizer([line.rstrip("\n").split("\t")[1] for line in f],
                            max_length=ROBERTA_SEQ_LEN)["attention_mask"].sum(1)
    log("RoBERTa-base directory and %d-row TSV made from seed %d in %.3f s; "
        "real tokens per row %d..%d" % (len(lengths), seed,
                                        time.perf_counter() - t1,
                                        lengths.min(), lengths.max()))

    def roberta(use_kernel):
        return run_train(torch, rdir, r_tsv, None, None, use_kernel, seed,
                         common=_mlm_argv(use_kernel, 2, roberta=True),
                         logging_steps=ROBERTA_STEPS)
    rk = main_path("RoBERTa-base MLM training (%d steps of %d x %d)"
                   % (ROBERTA_STEPS, ROBERTA_BATCH, ROBERTA_SEQ_LEN),
                   lambda: roberta(True),
                   dict.fromkeys(counted, N_LAYERS * ROBERTA_STEPS))
    rp = no_launch("RoBERTa-base MLM training", lambda: roberta(False))
    for tag, run in (("kernel", rk), ("plain", rp)):
        _check_train_run("RoBERTa " + tag, run, ROBERTA_STEPS)
        describe_train("R-" + tag, run, batch=ROBERTA_BATCH)
    d = abs(rk["records"][0]["loss"] - rp["records"][0]["loss"])
    log("RoBERTa-base MLM step 1, kernel vs plain: loss %.6f vs %.6f, |d| "
        "%.3e (bound %.1e); step ms median %.3f vs %.3f; peak device memory "
        "%.3f vs %.3f GiB"
        % (rk["records"][0]["loss"], rp["records"][0]["loss"], d,
           MLM_LOSS_ATOL, statistics.median(1e3 * r["seconds"]
                                            for r in rk["records"]),
           statistics.median(1e3 * r["seconds"] for r in rp["records"]),
           rk["peak_gib"], rp["peak_gib"]))
    if d > MLM_LOSS_ATOL:
        raise AssertionError("kernel and plain RoBERTa MLM runs disagree at "
                             "step 1: %.3e" % d)

    # data_augmentation predict on the BERT kernel run's checkpoint
    outs = {}
    for use_kernel in (True, False):
        tag = "kernel" if use_kernel else "plain"
        outs[tag] = os.path.join(workdir, "augmented_%s.tsv" % tag)
        argv = _mlm_argv(use_kernel, 2) + [
            "--mode=predict", "--app_name=data_augmentation",
            "--tables=" + dev_tsv, "--outputs=" + outs[tag],
            "--checkpoint_dir=" + ckpt_k, "--output_schema=augmented",
            "--append_cols=id"]
        run = (lambda a=argv: _cli(torch, a))
        if use_kernel:
            _, seconds = main_path(
                "data_augmentation predict (%d rows x %d copies)"
                % (N_DEV_ROWS, AUG_COUNT), run,
                {"short_attention_fwd": N_LAYERS * N_DEV_ROWS * AUG_COUNT
                 // BATCH, "short_attention_bwd": 0})
        else:
            _, seconds = no_launch("data_augmentation predict", run)
        log("data_augmentation %s: %d rows in %.3f s" % (tag, N_DEV_ROWS,
                                                         seconds))
    rows = {}
    for tag, path in outs.items():
        with open(path, encoding="utf-8") as f:
            rows[tag] = [line.rstrip("\n").split("\t") for line in f]
        if [r[-1] for r in rows[tag]] != [str(i) for i in range(N_DEV_ROWS)] \
                or any(len(r) != AUG_COUNT + 1 or not all(r[:AUG_COUNT])
                       for r in rows[tag]):
            raise AssertionError("%s: want %d rows of %d texts and the id"
                                 % (path, N_DEV_ROWS, AUG_COUNT))
    with open(dev_tsv, encoding="utf-8") as f:
        texts = [line.rstrip("\n").split("\t")[1] for line in f]
    texts_k, decided, ids_k, ids_p, chosen = _augment_decided(
        torch, ckpt_k, dev_tsv, texts)
    if ["\t".join(r[:AUG_COUNT]) for r in rows["kernel"]] != texts_k:
        raise AssertionError("the CLI's augmented texts are not the "
                             "in-process predictor's (other masks?)")
    flips = int((decided & (ids_k != ids_p)).sum())
    whole = decided.sum(1) == chosen.sum(1)  # copies decided at every mask
    copy_text = {tag: [t for r in rows[tag] for t in r[:AUG_COUNT]]
                 for tag in rows}
    differ = [c for c in np.nonzero(whole)[0]
              if copy_text["kernel"][c] != copy_text["plain"][c]]
    log("data_augmentation kernel vs plain: refilled ids agree at %d of %d "
        "masked positions with a plain top-2 margin > %.1e (%d masked in "
        "all); %d of %d copies decided at every mask, their texts %s; %d of "
        "%d copies identical"
        % (int(decided.sum()) - flips, int(decided.sum()), 2 * SLICE_ATOL,
           int(chosen.sum()), int(whole.sum()), len(whole),
           "identical" if not differ else "differ at %s" % differ,
           sum(a == b for a, b in zip(copy_text["kernel"],
                                      copy_text["plain"])), len(whole)))
    if flips or differ:
        raise AssertionError("data_augmentation kernel and plain runs "
                             "disagree where the margin decides")
    return launches


# --------------------------------------------------------------------------
# phase 12: multi-label text_classify, information_extraction,
# geep_classify, Lion and Adafactor
# --------------------------------------------------------------------------

ML_LABELS = ("sports", "finance", "tech", "games", "health", "travel",
             "autos", "education")
# CLUENER2020's 10 entity types
IE_TYPES = ("address", "book", "company", "game", "government", "movie",
            "name", "organization", "position", "scene")
# IE trains 0.75 of an epoch of 8 steps: t_total 6, so the Trainer breaks
# in mid-epoch with prefetched batches staged (ROADMAP C17's path)
IE_EPOCHS = 0.75
# the default, one that some rows reach early, and 0.5, which every row
# reaches at the first layer (two labels: the top probability is >= 0.5)
GEEP_THRESHOLDS = (0.9, 0.55, 0.5)
OPTIMIZER_STEPS = 4
# The 4-step optimizer runs train on one repeated batch with dropout off,
# so each step's loss is a function of the weights alone: with dropout on,
# the loss moved by ~0.03 from step to step on an H100 whatever the
# optimizer (Lion at 3e-6 and Adafactor at 3e-4 gave one pattern). Lion's
# sign update moves each of BERT-base's 1e8 weights by lr, and the loss
# swung at 1e-4 (0.69 -> 1.44 -> 1.43 -> 0.78, dropout on) and at 1e-5
# (0.69 -> 0.83 -> 0.68 -> 0.81, dropout off): 1e-6. Adafactor moves each
# weight by about lr x its tensor's rms (~0.02 for the matrices, ~1 for
# the LayerNorm scales): 1e-4.
OPTIMIZER_LR = {"Lion": 1e-6, "Adafactor": 1e-4}
# information_extraction's learning rate: the global-pointer loss weighs
# the ~9000 negative spans of a row against its 0-3 positive ones, and at
# 5e-5 six steps drove every span score below 0 on an H100 (predict wrote
# no span to parse); at 2e-6 the random pointer's scores stay on both sides
# of 0
IE_LR = 2e-6
APPS12 = {
    "multi_label": dict(
        argv=["--app_name=text_classify",
              "--input_schema=id:str:1,sentence:str:1,labels:str:1",
              "--first_sequence=sentence", "--label_name=labels",
              "--user_defined_parameters=multi_label=true"],
        outputs="predictions,probabilities,logits"),
    "information_extraction": dict(
        argv=["--app_name=information_extraction",
              "--input_schema=id:str:1,content:str:1,entities:str:1",
              "--first_sequence=content", "--label_name=entities"],
        outputs="predictions"),
    "geep_classify": dict(
        argv=["--app_name=geep_classify",
              "--input_schema=id:str:1,sentence:str:1,label:str:1",
              "--first_sequence=sentence", "--label_name=label"],
        outputs="predictions,probabilities,logits"),
}
# Kernel against plain, both bf16 end to end on the same weights and
# batches, differing only in attention's rounding (SLICE_ATOL's argument:
# logits within 5e-2).
# - Multi-label: the step-1 loss is the mean over 32 x 8 logits of a
#   binary cross-entropy whose slope in its logit lies in (-1, 1), so it
#   moves by at most the largest logit change: bound SLICE_ATOL. A label
#   is decided where the plain logit lies farther from 0 than SLICE_ATOL.
# - GEEP: the step-1 loss is a weighted mean (weights summing to 1) of
#   cross-entropies, each moving by at most twice the largest logit change:
#   bound 2 x SLICE_ATOL.
# - IE: a span score q_i . k_j / 8 is a product of two projections of the
#   f32 last hidden state, each moved by attention's rounding by about what
#   moves the heads' logits (phase 8's sequence-labeling logits, ~0.5 in
#   size, moved 1.6e-2 on an H100: ~3%); with 0.02-std weights over 768
#   inputs each of the 64 lanes of q and k has std ~0.55, a score std
#   ~0.3, and the largest of the 2.6e6 live spans of a dev batch ~1.5, so
#   a score moves by up to ~2 x 3% x 1.5 = 0.09. Bound 0.25 on the scores;
#   the loss, a mean of two logsumexps each moving by at most the largest
#   score change, within 2 x 0.25. A span is decided where the plain score
#   lies farther from 0 than the bound.
# - The optimizers: the four steps' losses as phase 4's 8 AdamW steps
#   (TRAIN_LOSS_ATOL).
ML_LOSS_ATOL = SLICE_ATOL
GEEP_LOSS_ATOL = 2 * SLICE_ATOL
IE_SCORE_ATOL = 0.25
IE_LOSS_ATOL = 2 * IE_SCORE_ATOL


def make_phase12_tsvs(workdir, cjk, seed):
    """{kind: (train tsv, dev tsv)}: CJK sentences of 8-90 characters with
    1-3 of ML_LABELS; CJK texts of 20-60 characters (rows of 22-62 tokens)
    with 0-3 spans of IE_TYPES as `start,end,type;...`; and a 32-row
    table (phase 4's first rows) for the optimizer runs."""
    rng = random.Random(seed)
    common = cjk[:3000]
    out = {}
    for kind in ("multi_label", "information_extraction"):
        paths = []
        for split, n in (("train", N_ROWS), ("dev", N_DEV_ROWS)):
            path = os.path.join(workdir, "%s_%s.tsv" % (kind[:11], split))
            with open(path, "w", encoding="utf-8") as f:
                for i in range(n):
                    if kind == "multi_label":
                        text = _cjk_text(rng, common, 8, 90)
                        tag = " ".join(rng.sample(ML_LABELS,
                                                  rng.randint(1, 3)))
                    else:
                        text = _cjk_text(rng, common, 20, 60)
                        spans = []
                        for _ in range(rng.randint(0, 3)):
                            start = rng.randrange(len(text))
                            end = min(len(text) - 1,
                                      start + rng.randint(1, 6))
                            spans.append("%d,%d,%s" % (
                                start, end, rng.choice(IE_TYPES)))
                        tag = ";".join(spans)
                    f.write("%d\t%s\t%s\n" % (i, text, tag))
            paths.append(path)
        out[kind] = tuple(paths)
    out["geep_classify"] = (os.path.join(workdir, "train.tsv"),  # phase 4's
                            os.path.join(workdir, "dev.tsv"))
    out["optimizer"] = os.path.join(workdir, "optimizer_batch.tsv")
    with open(out["geep_classify"][0], encoding="utf-8") as f, \
            open(out["optimizer"], "w", encoding="utf-8") as g:
        g.writelines(f.readlines()[:BATCH])
    return out


def _argv12(name, use_kernel, threshold=None):
    argv = list(APPS12[name]["argv"])
    if threshold is not None:
        argv.append("--user_defined_parameters=exit_threshold=%s"
                    % threshold)
    return argv + ["--device=cuda", "--dtype=bfloat16",
                   "--sequence_length=%d" % SEQ_LEN,
                   "--micro_batch_size=%d" % BATCH,
                   "--use_flash_attention=%s" % ("auto" if use_kernel
                                                 else "false")]


def _model_inputs(torch, app, predictor, tsv, schema):
    """The predictor's preprocessed model inputs of every row of tsv, as
    device batches of BATCH rows."""
    import numpy as np
    from easynlp_tpu_torch.utils import parse_row_by_schema
    with open(tsv, encoding="utf-8") as f:
        rows = [parse_row_by_schema(line, schema) for line in f
                if line.strip()]
    inputs = predictor.preprocess({k: [r[k] for r in rows] for k in rows[0]})
    return [{k: torch.from_numpy(np.asarray(inputs[k][s:s + BATCH],
                                            np.int32)).to(app.device)
             for k in app.model_input_keys if k in inputs}
            for s in range(0, len(rows), BATCH)], rows


def _forward12(torch, name, ckpt, tsv, keys, udp=None, **forward_kw):
    """{True: kernel outputs, False: plain outputs} of the app's forward
    (its `keys`, concatenated over BATCH-row batches) over tsv's rows, bf16
    on the card."""
    import numpy as np
    from types import SimpleNamespace
    from easynlp_tpu_torch.appzoo import api
    from easynlp_tpu_torch.ops import attention as A
    argv = dict(a.split("=", 1) for a in _argv12(name, True))
    udp = dict(dict(kv.split("=", 1) for kv in argv.get(
        "--user_defined_parameters", "").split() if kv), **(udp or {}))
    with open(os.path.join(ckpt, "label_mapping.json")) as f:
        n_labels = max(len(json.load(f)), 2)
    app = api._resolve(api.MODEL_REGISTRY, argv["--app_name"], udp) \
        .from_pretrained(ckpt, args=SimpleNamespace(
            user_defined_parameters_dict=udp), dtype=torch.bfloat16,
            device="cuda", num_labels=n_labels)
    predictor = api._resolve(api.PREDICTOR_REGISTRY, argv["--app_name"],
                             udp)(model_dir=ckpt, app=app,
                                  first_sequence=argv["--first_sequence"],
                                  sequence_length=SEQ_LEN, batch_size=BATCH)
    batches, _ = _model_inputs(torch, app, predictor, tsv,
                               argv["--input_schema"])
    outs = {}
    try:
        with torch.inference_mode():
            for use_kernel in (True, False):
                A.set_kernel_override(None if use_kernel else False)
                parts = [app.module(**b, **forward_kw) for b in batches]
                outs[use_kernel] = {k: np.concatenate(
                    [p[k].float().cpu().numpy() for p in parts])
                    for k in keys}
    finally:
        A.set_kernel_override(None)
    return outs


def _geep_speed(torch, ckpt, tsv, threshold):
    """At `threshold`, on the card with the kernels: (rows/s of the
    early-exit forward, rows/s of the all-layers forward (each the median
    of 3 timed passes over tsv's rows, synchronised), the exit layers,
    short-forward launches per early-exit pass). Raises unless the two
    forwards give the same logits, probabilities, labels and exits bit for
    bit."""
    import numpy as np
    from types import SimpleNamespace
    from easynlp_tpu_torch.appzoo.geep_classification.model import (
        GEEPClassification)
    from easynlp_tpu_torch.appzoo.sequence_classification.predictor import (
        SequenceClassificationPredictor)
    from easynlp_tpu_torch.ops import attention as A
    udp = {"exit_threshold": str(threshold)}
    app = GEEPClassification.from_pretrained(
        ckpt, args=SimpleNamespace(user_defined_parameters_dict=udp),
        dtype=torch.bfloat16, device="cuda", num_labels=2)
    predictor = SequenceClassificationPredictor(
        ckpt, app, first_sequence="sentence", sequence_length=SEQ_LEN,
        batch_size=BATCH)
    batches, rows = _model_inputs(torch, app, predictor, tsv,
                                  "id:str:1,sentence:str:1,label:str:1")
    keys = ("logits", "probabilities", "predictions", "exit_layer")
    outs, rates, launched = {}, {}, 0
    with torch.inference_mode():
        for all_layers in (False, True):
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                before = A.short_attention_fwd.launches
                t0 = time.perf_counter()
                parts = [app.module(**b, all_layers=all_layers)
                         for b in batches]
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if not all_layers:
                    launched = A.short_attention_fwd.launches - before
            rates[all_layers] = len(rows) / statistics.median(times)
            outs[all_layers] = {k: torch.cat([p[k] for p in parts])
                                for k in keys}
    for k in keys:
        if not torch.equal(outs[False][k], outs[True][k]):
            raise AssertionError("GEEP at threshold %s: the early-exit "
                                 "forward's %s differs from the all-layers "
                                 "forward's" % (threshold, k))
    exits = outs[False]["exit_layer"].cpu().numpy()
    want = sum(int(exits[s:s + BATCH].max()) + 1
               for s in range(0, len(exits), BATCH))
    if launched != want:
        raise AssertionError("GEEP early exit launched %d short forwards, "
                             "want %d (the layers each batch computed)"
                             % (launched, want))
    return rates[False], rates[True], exits, launched


def _optimizer_ms(torch, model_dir):
    """{optimizer: (device ms per step from the profiler, timed ms per step
    with CUDA events)} of one guarded step (apply=True, as the Trainer
    takes it) over the BERT-base text_classify module's f32 parameters,
    gradients drawn once."""
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification)
    from easynlp_tpu_torch.core.optimizers import get_optimizer
    app = SequenceClassification.from_pretrained(
        model_dir, dtype=torch.bfloat16, device="cuda", num_labels=2)
    g = torch.Generator(device=app.device).manual_seed(0)
    grads = [1e-3 * torch.randn(p.shape, generator=g, device=app.device)
             for p in app.module.parameters()]
    flag = torch.tensor(True, device=app.device)
    out = {}
    for kind in ("AdamW", "Lion", "Adafactor"):
        opt, _, _ = get_optimizer(app.module.named_parameters(),
                                  optimizer_type=kind, learning_rate=1e-6,
                                  steps_per_epoch=1000, epoch_num=1,
                                  max_grad_norm=0.0)

        def step():
            opt.step(grads, apply=flag)
        timed = _time_ms(torch, step, iters=20, warmup=3)
        device = sum(_device_ms(torch, step, calls=5).values())
        out[kind] = (device, timed)
        del opt
    del app
    return out


def phase_encoder_apps2(torch, seed, workdir, cjk):
    """Phase 12. Returns the launches of each counted wrapper in the main
    path's runs (each app's kernel training run with its evaluation, and
    its kernel predict runs; the optimizers' kernel runs), each counted
    from 0."""
    import numpy as np
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 12: multi-label text_classify, information_extraction, "
        "geep_classify, Lion and Adafactor (BERT-base)")
    t0 = time.perf_counter()
    model_dir = os.path.join(workdir, ENCODER_MODEL_DIR)
    if not os.path.isdir(model_dir):
        model_dir = make_encoder_model_dir(torch, workdir)
    tsvs = make_phase12_tsvs(workdir, cjk, seed + 13)
    log("phase 12 TSVs made in %.3f s" % (time.perf_counter() - t0))
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")
    launches = dict.fromkeys(wrappers, 0)

    def counted(what, fn, want):
        """fn() with the counts set to 0 just before and read just after
        (the main path); raises unless they are `want`."""
        for w in wrappers:
            getattr(A, w).launches = 0
        out = fn()
        used = {w: getattr(A, w).launches for w in wrappers}
        log("%s launches: %s" % (what, used))
        if used != dict(dict.fromkeys(wrappers, 0), **want):
            raise AssertionError("%s launched %s, want %s"
                                 % (what, used, want))
        for w in wrappers:
            launches[w] += used[w]
        return out

    def no_launch(what, fn):
        before = {w: getattr(A, w).launches for w in wrappers}
        out = fn()
        if {w: getattr(A, w).launches for w in wrappers} != before:
            raise AssertionError("%s (--use_flash_attention=false) launched "
                                 "a kernel" % what)
        return out

    def train(name, use_kernel, ckpt, steps, extra=()):
        train_tsv, dev_tsv = tsvs[name]
        common = _argv12(name, use_kernel) + ["--logging_steps=1"] \
            + list(extra)
        run = run_train(torch, model_dir, train_tsv, dev_tsv, ckpt,
                        use_kernel, seed, common=common)
        _check_train_run("%s %s" % (name, "kernel" if use_kernel
                                    else "plain"), run, steps)
        describe_train("%s-%s" % (name[:5], "k" if use_kernel else "p"),
                       run)
        return run

    steps, eval_batches = N_ROWS // BATCH, -(-N_DEV_ROWS // BATCH)
    fwd_bwd = {"short_attention_fwd": N_LAYERS * (steps + eval_batches),
               "short_attention_bwd": N_LAYERS * steps}
    per_app_s = {}

    # 1. multi-label text_classify
    t_app = time.perf_counter()
    ckpt = os.path.join(workdir, "ckpt_multi_label")
    runs = {True: counted("multi-label training (8 steps + evaluation)",
                          lambda: train("multi_label", True, ckpt, steps),
                          fwd_bwd),
            False: no_launch("multi-label training",
                             lambda: train("multi_label", False, None,
                                           steps))}
    d = abs(runs[True]["records"][0]["loss"] - runs[False]["records"][0][
        "loss"])
    log("multi-label step 1, kernel vs plain: loss %.6f vs %.6f, |d| %.3e "
        "(bound %.1e)" % (runs[True]["records"][0]["loss"],
                          runs[False]["records"][0]["loss"], d,
                          ML_LOSS_ATOL))
    if d > ML_LOSS_ATOL:
        raise AssertionError("multi-label kernel and plain runs disagree at "
                             "step 1: %.3e" % d)
    results, secs = _cli(torch, ["--mode=evaluate", "--tables=" + tsvs[
        "multi_label"][1], "--checkpoint_dir=" + ckpt]
        + _argv12("multi_label", True))
    log("multi-label evaluate: %s in %.3f s" % (", ".join(
        "%s %.6f" % kv for kv in results), secs))
    if [m for m, _ in results] != ["f1_micro", "f1_macro", "precision_micro",
                                   "recall_micro"] or not all(
            0 <= x <= 1 for _, x in results):
        raise AssertionError("multi-label evaluate: %s" % results)
    preds = {}
    for use_kernel in (True, False):
        out = os.path.join(workdir, "pred_multi_label_%d.tsv" % use_kernel)
        run = (lambda o=out, k=use_kernel: _cli(torch, [
            "--mode=predict", "--tables=" + tsvs["multi_label"][1],
            "--outputs=" + o, "--checkpoint_dir=" + ckpt,
            "--output_schema=" + APPS12["multi_label"]["outputs"]]
            + _argv12("multi_label", k)))
        if use_kernel:
            counted("multi-label predict", run,
                    {"short_attention_fwd": N_LAYERS * eval_batches})
        else:
            no_launch("multi-label predict", run)
        with open(out, encoding="utf-8") as f:
            preds[use_kernel] = [line.rstrip("\n").split("\t") for line in f]
    logits = {k: np.array([[float(x) for x in r[2].split()]
                           for r in preds[k]]) for k in preds}
    gap = float(np.abs(logits[True] - logits[False]).max())
    decided = np.abs(logits[False]) > ML_LOSS_ATOL    # per (row, label)
    flips = int(((logits[True] > 0) != (logits[False] > 0))[decided].sum())
    rows = np.nonzero(decided.all(1))[0]
    row_flips = sum(preds[True][i][0] != preds[False][i][0] for i in rows)
    names = {n for r in preds[True] for n in r[0].split()}
    log("multi-label predict, kernel vs plain: max |d logit| %.3e (bound "
        "%.1e); label decisions agree at all %d (row, label) pairs whose "
        "plain logit lies farther from 0 than the bound (%d flips), "
        "predictions at all %d rows decided at every label (%d differ); %d "
        "of %d rows identical; labels per row %s; seconds %.3f"
        % (gap, SLICE_ATOL, int(decided.sum()) - flips, flips, len(rows),
           row_flips, sum(a[0] == b[0] for a, b in zip(preds[True],
                                                      preds[False])),
           len(preds[True]), sorted({len(r[0].split())
                                     for r in preds[True]}),
           time.perf_counter() - t_app))
    if gap > SLICE_ATOL or flips or row_flips or not names <= set(ML_LABELS):
        raise AssertionError("multi-label predict: gap %.3e, %d flips, "
                             "labels %s" % (gap, flips, names))
    per_app_s["multi_label"] = time.perf_counter() - t_app

    # 2. information_extraction, 0.75 epochs
    t_app = time.perf_counter()
    ckpt = os.path.join(workdir, "ckpt_ie")
    ie_steps = int(np.ceil(steps * IE_EPOCHS))
    extra = ["--epoch_num=%g" % IE_EPOCHS, "--learning_rate=%g" % IE_LR]
    runs = {True: counted(
        "information_extraction training (%d steps, the break in mid-epoch, "
        "+ evaluation)" % ie_steps,
        lambda: train("information_extraction", True, ckpt, ie_steps,
                      extra),
        {"short_attention_fwd": N_LAYERS * (ie_steps + eval_batches),
         "short_attention_bwd": N_LAYERS * ie_steps}),
        False: no_launch("information_extraction training",
                         lambda: train("information_extraction", False, None,
                                       ie_steps, extra))}
    final = [r for r in map(json.loads, open(os.path.join(
        ckpt, "events.jsonl"))) if r["kind"] == "eval"]
    d = abs(runs[True]["records"][0]["loss"] - runs[False]["records"][0][
        "loss"])
    log("information_extraction: %d of %d steps, then the evaluation after "
        "the break: %s; step 1 kernel vs plain loss %.6f vs %.6f, |d| %.3e "
        "(bound %.1e); span scores per batch %d x %d x %d x %d f32 = %.1f "
        "MB; peak device memory %.3f GiB (kernel) / %.3f GiB (plain)"
        % (ie_steps, steps, final[-1] if final else None,
           runs[True]["records"][0]["loss"],
           runs[False]["records"][0]["loss"], d, IE_LOSS_ATOL, BATCH,
           len(IE_TYPES), SEQ_LEN, SEQ_LEN,
           BATCH * len(IE_TYPES) * SEQ_LEN * SEQ_LEN * 4 / 1e6,
           runs[True]["peak_gib"], runs[False]["peak_gib"]))
    if not final or d > IE_LOSS_ATOL:
        raise AssertionError("information_extraction: evaluation %s, loss "
                             "gap %.3e" % (final, d))
    ie_dev = tsvs["information_extraction"][1]
    results, secs = _cli(torch, ["--mode=evaluate", "--tables=" + ie_dev,
                                 "--checkpoint_dir=" + ckpt]
                         + _argv12("information_extraction", True))
    log("information_extraction evaluate: %s in %.3f s"
        % (", ".join("%s %.6f" % kv for kv in results), secs))
    if [m for m, _ in results] != ["f1", "precision", "recall"]:
        raise AssertionError("information_extraction evaluate: %s" % results)
    out = os.path.join(workdir, "pred_ie.tsv")
    manager, secs = counted("information_extraction predict", lambda: _cli(
        torch, ["--mode=predict", "--tables=" + ie_dev, "--outputs=" + out,
                "--checkpoint_dir=" + ckpt, "--output_schema=predictions",
                "--append_cols=content"]
        + _argv12("information_extraction", True)),
        {"short_attention_fwd": N_LAYERS * eval_batches})
    n_spans = 0
    with open(out, encoding="utf-8") as f:
        for line in f:
            pred, text = line.rstrip("\n").split("\t")
            for span in filter(None, pred.split(";")):
                start, end, etype, chars = span.split(",", 3)
                if etype not in IE_TYPES or \
                        text[int(start):int(end) + 1] != chars:
                    raise AssertionError("span %r does not parse against "
                                         "%r" % (span, text))
                n_spans += 1
    got = _forward12(torch, "information_extraction", ckpt, ie_dev,
                        ("span_scores",))
    k, p = got[True]["span_scores"], got[False]["span_scores"]
    live = p > -1e29
    gap = float(np.abs(k[live] - p[live]).max())
    decided = live & (np.abs(p) > IE_SCORE_ATOL)
    flips = int(((k > 0) != (p > 0))[decided].sum())
    log("information_extraction predict: %d rows, %d spans parsed, %.4f s "
        "(%.2f rows/s); kernel vs plain span scores: max |d| %.3e over %d "
        "live spans (bound %.2f), the same masked spans %s, signs agree at "
        "all %d decided spans (%d flips); seconds %.3f"
        % (manager.n_rows, n_spans, manager.seconds,
           manager.n_rows / manager.seconds, gap, int(live.sum()),
           IE_SCORE_ATOL, bool(((k > -1e29) == live).all()),
           int(decided.sum()) - flips, flips, time.perf_counter() - t_app))
    if gap > IE_SCORE_ATOL or flips or not ((k > -1e29) == live).all() \
            or not n_spans:
        raise AssertionError("information_extraction kernel vs plain: gap "
                             "%.3e, %d flips" % (gap, flips))
    per_app_s["information_extraction"] = time.perf_counter() - t_app

    # 3. geep_classify
    t_app = time.perf_counter()
    ckpt = os.path.join(workdir, "ckpt_geep")
    # the main path; its evaluation exits early, so its forwards number
    # at most N_LAYERS a batch
    runs = {}
    for w in wrappers:
        getattr(A, w).launches = 0
    runs[True] = train("geep_classify", True, ckpt, steps)
    used = {w: getattr(A, w).launches for w in wrappers}
    eval_fwd = used["short_attention_fwd"] - N_LAYERS * steps
    log("geep_classify training (8 steps + evaluation) launches: %s (the "
        "evaluation's early-exit forwards %d of at most %d)"
        % (used, eval_fwd, N_LAYERS * eval_batches))
    if used["short_attention_bwd"] != N_LAYERS * steps or not \
            0 < eval_fwd <= N_LAYERS * eval_batches or \
            used["flash_attention_fwd"] or used["flash_attention_bwd"]:
        raise AssertionError("geep_classify training launched %s" % used)
    for w in wrappers:
        launches[w] += used[w]
    runs[False] = no_launch("geep_classify training",
                            lambda: train("geep_classify", False, None,
                                          steps))
    d = abs(runs[True]["records"][0]["loss"] - runs[False]["records"][0][
        "loss"])
    log("geep_classify step 1, kernel vs plain: loss %.6f vs %.6f, |d| %.3e "
        "(bound %.1e)" % (runs[True]["records"][0]["loss"],
                          runs[False]["records"][0]["loss"], d,
                          GEEP_LOSS_ATOL))
    if d > GEEP_LOSS_ATOL:
        raise AssertionError("geep_classify kernel and plain runs disagree "
                             "at step 1: %.3e" % d)
    geep_train, geep_dev = tsvs["geep_classify"]
    results, secs = _cli(torch, ["--mode=evaluate", "--tables=" + geep_dev,
                                 "--checkpoint_dir=" + ckpt]
                         + _argv12("geep_classify", True))
    log("geep_classify evaluate: %s in %.3f s"
        % (", ".join("%s %.6f" % kv for kv in results), secs))
    if [m for m, _ in results][:2] != ["accuracy", "f1"]:
        raise AssertionError("geep_classify evaluate: %s" % results)
    for threshold in GEEP_THRESHOLDS:
        out = os.path.join(workdir, "pred_geep_%s.tsv" % threshold)
        manager, _ = _cli(torch, [
            "--mode=predict", "--tables=" + geep_dev, "--outputs=" + out,
            "--checkpoint_dir=" + ckpt,
            "--output_schema=predictions,probabilities,logits",
            "--append_cols=id"] + _argv12("geep_classify", True, threshold))
        labels, _, _ = check_output(out, N_DEV_ROWS)
        early, full, exits, launched = _geep_speed(torch, ckpt, geep_train,
                                                   threshold)
        hist = np.bincount(exits, minlength=N_LAYERS)
        got = _forward12(torch, "geep_classify", ckpt, geep_dev,
                            ("logits", "exit_layer"),
                            udp={"exit_threshold": str(threshold)},
                            all_layers=True)
        k, p = got[True], got[False]
        same_exit = k["exit_layer"] == p["exit_layer"]
        margin = np.abs(p["logits"][:, 0] - p["logits"][:, 1])
        decided = same_exit & (margin > 2 * SLICE_ATOL)
        flips = int((k["logits"].argmax(1) != p["logits"].argmax(1))[
            decided].sum())
        log("geep_classify at exit_threshold %s: predict %d rows (%s); "
            "early exit %.2f rows/s against %.2f rows/s through all %d "
            "layers (%.2fx; %d rows, 3 passes, the same exits and labels "
            "bit for bit; %d short forwards launched a pass); exit layers "
            "(0-based) histogram %s; kernel vs plain: exits agree on %d of "
            "%d dev rows, labels on all %d of those decided (%d flips)"
            % (threshold, manager.n_rows, {x: labels.count(x)
                                           for x in sorted(set(labels))},
               early, full, N_LAYERS, early / full, len(exits), launched,
               hist.tolist(), int(same_exit.sum()), len(same_exit),
               int(decided.sum()) - flips, flips))
        if flips:
            raise AssertionError("geep_classify kernel and plain labels "
                                 "differ where decided")
    if hist[0] != len(exits):
        raise AssertionError("at threshold %s every row exits at the first "
                             "layer; the exits were %s"
                             % (GEEP_THRESHOLDS[-1], hist.tolist()))
    per_app_s["geep_classify"] = time.perf_counter() - t_app

    # 4. Lion and Adafactor: 4 steps on one repeated batch, dropout off
    t_app = time.perf_counter()
    still_dir = os.path.join(workdir, ENCODER_MODEL_DIR + "-no-dropout")
    os.makedirs(still_dir, exist_ok=True)
    for name in ("vocab.txt", "pytorch_model.bin"):
        if not os.path.exists(os.path.join(still_dir, name)):
            os.symlink(os.path.join(model_dir, name),
                       os.path.join(still_dir, name))
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    config.update(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    with open(os.path.join(still_dir, "config.json"), "w") as f:
        json.dump(config, f)
    for kind in ("Lion", "Adafactor"):
        extra = ["--optimizer_type=" + kind, "--epoch_num=%d"
                 % OPTIMIZER_STEPS, "--lr_scheduler=constant",
                 "--learning_rate=%g" % OPTIMIZER_LR[kind]]
        opt_runs = {}
        for use_kernel in (True, False):
            fn = (lambda k=use_kernel: run_train(
                torch, still_dir, tsvs["optimizer"], None, None, k, seed,
                common=_common_argv(k) + extra))
            if use_kernel:
                opt_runs[True] = counted(
                    "%s text_classify (%d steps)" % (kind, OPTIMIZER_STEPS),
                    fn, {"short_attention_fwd": N_LAYERS * OPTIMIZER_STEPS,
                         "short_attention_bwd": N_LAYERS * OPTIMIZER_STEPS})
            else:
                opt_runs[False] = no_launch(kind, fn)
            _check_train_run("%s %s" % (kind, use_kernel),
                             opt_runs[use_kernel], OPTIMIZER_STEPS)
        losses = {k: [r["loss"] for r in v["records"]]
                  for k, v in opt_runs.items()}
        d = max(abs(a - b) for a, b in zip(losses[True], losses[False]))
        log("%s, 4 steps on one repeated batch of 32 x 128 (dropout off) at "
            "lr %g: losses "
            "%s (kernel), %s (plain), max |d| %.3e (bound %.1e); step ms "
            "median %.3f (kernel) / %.3f (plain)"
            % (kind, OPTIMIZER_LR[kind], " ".join("%.4f" % x
                                                  for x in losses[True]),
               " ".join("%.4f" % x for x in losses[False]), d,
               TRAIN_LOSS_ATOL,
               statistics.median(1e3 * r["seconds"]
                                 for r in opt_runs[True]["records"]),
               statistics.median(1e3 * r["seconds"]
                                 for r in opt_runs[False]["records"])))
        if d > TRAIN_LOSS_ATOL or not (losses[True][-1] < losses[True][0]
                                       and losses[False][-1]
                                       < losses[False][0]):
            raise AssertionError("%s: losses %s" % (kind, losses))
    for kind, (device, timed) in _optimizer_ms(torch, model_dir).items():
        log("optimizer %s, one guarded step over BERT-base text_classify's "
            "parameters: device %.3f ms (profiler), %.3f ms timed (CUDA "
            "events, host launches included)" % (kind, device, timed))
    per_app_s["optimizers"] = time.perf_counter() - t_app
    log("phase 12 seconds by part: %s" % ", ".join(
        "%s %.1f" % kv for kv in per_app_s.items()))
    return launches

# --------------------------------------------------------------------------
# phase 13: the Trainer's --remat, --ema_decay and --async_save; KD, PET and
# CPT, MetaKD, LoRA (BERT-base; BART-base under remat)
# --------------------------------------------------------------------------

REMAT = ("none", "full", "selective", "names")
EMA_DECAY = 0.999
# a save after the 8th of the 8 steps and the final one, so 2 saves a run
# (3 until slice 14, a save every 4 steps), of the first EMA_LAYERS layers
# of bert-base-chinese: each writes 0.5 GB (weights, EMA, AdamW state; 1.6
# GB at 12 layers until slice 13), and the card's machine allows 45 GiB
# of disk writes to the whole script
EMA_SAVE_STEPS = 8
EMA_LAYERS = 2
KD_UDP = "enable_distillation=true temperature=2 alpha=0.5"
PET_PATTERN = {"pattern": "{sent1},{mask}", "label_desc": "bad,good"}
METAKD_DOMAINS = ("books", "dvd", "electronics", "kitchen")
METAKD_STEPS = 4
LORA_UDP = "enable_lora=true lora_rank=8 lora_alpha=16"
OPTION_FILES = ("pytorch_model.bin", "pytorch_model_ema.bin", "optimizer.pt")


def _flat_tensors(obj, prefix=""):
    """{path: leaf} of a nested dict (a torch.load of a checkpoint file)."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_flat_tensors(v, "%s%s/" % (prefix, k)))
        return out
    return {prefix: obj}


def _same_file(torch, a, b):
    """Whether two checkpoint files hold the same leaves, bit for bit."""
    x = _flat_tensors(torch.load(a, weights_only=True))
    y = _flat_tensors(torch.load(b, weights_only=True))
    return x.keys() == y.keys() and all(
        torch.equal(x[k], y[k]) if torch.is_tensor(x[k]) else x[k] == y[k]
        for k in x)


def make_metakd_tsv(src, dst, seed, n_rows):
    """src's first n_rows rows with a domain and a sample weight column."""
    rng = random.Random(seed)
    with open(src, encoding="utf-8") as f, \
            open(dst, "w", encoding="utf-8") as g:
        for line in f.readlines()[:n_rows]:
            g.write("%s\t%s\t%.2f\n" % (line.rstrip("\n"),
                                        rng.choice(METAKD_DOMAINS),
                                        rng.uniform(0.5, 1.5)))
    return dst


def phase_trainer_options(torch, seed, workdir, bart_run):
    """Phase 13. On phase 3's BERT-base directory and phase 4's tables:
    text_classify at every --remat policy (the same losses bit for bit, the
    peak memory each), then BART-base at --remat=full against phase 6's
    first kernel run; --ema_decay with --async_save against the same run
    with synchronous saves; KD from the logits phase 4's checkpoint
    predicts; PET train, evaluate and predict and a CPT run on phase 11's
    masked LM; MetaKD's teacher and its two distillation stages (the
    explicit-scores attention: no kernel); LoRA. Returns the launches of
    each counted wrapper in the main path's runs, each counted from 0."""
    import shutil

    import numpy as np
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 13: --remat, --ema_decay, --async_save; KD, PET/CPT, "
        "MetaKD, LoRA (BERT-base; BART-base under remat)")
    t_phase = time.perf_counter()
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")
    launches = dict.fromkeys(wrappers, 0)

    def counted(what, fn, want):
        """fn() with the counts set to 0 just before and read just after
        (the main path); raises unless they are `want`."""
        for w in wrappers:
            getattr(A, w).launches = 0
        out = fn()
        used = {w: getattr(A, w).launches for w in wrappers}
        log("%s launches: %s" % (what, used))
        if used != dict(dict.fromkeys(wrappers, 0), **want):
            raise AssertionError("%s launched %s, want %s"
                                 % (what, used, want))
        for w in wrappers:
            launches[w] += used[w]
        return out

    model_dir = os.path.join(workdir, MODEL_DIR)
    train_tsv = os.path.join(workdir, "train.tsv")
    dev_tsv = os.path.join(workdir, "dev.tsv")
    steps, eval_batches = N_ROWS // BATCH, -(-N_DEV_ROWS // BATCH)
    part_s = {}

    # 1. --remat: 8 steps at each policy, no evaluation or checkpoint
    t0 = time.perf_counter()
    runs = {}
    for policy in REMAT:
        runs[policy] = counted(
            "text_classify --remat=%s (%d steps)" % (policy, steps),
            lambda p=policy: run_train(
                torch, model_dir, train_tsv, None, None, True, seed,
                common=_common_argv(True) + ["--remat=" + p]),
            {"short_attention_fwd": (2 if policy == "full" else 1)
             * N_LAYERS * steps,
             "short_attention_bwd": N_LAYERS * steps})
        _check_train_run("remat " + policy, runs[policy], steps)
    losses = {p: [r["loss"] for r in run["records"]]
              for p, run in runs.items()}
    for policy, run in runs.items():
        log("--remat=%-9s step ms median %.3f (CUDA events), peak device "
            "memory %.3f GiB above the run's start (%.3f GiB under none); "
            "losses %s" % (policy, statistics.median(
                1e3 * r["seconds"] for r in run["records"]),
                run["peak_gib"], runs["none"]["peak_gib"] - run["peak_gib"],
                " ".join("%.6f" % x for x in losses[policy])))
    if any(v != losses["none"] for v in losses.values()):
        raise AssertionError("--remat changed the losses: %s" % losses)
    # a run's peak comes at the optimizer step (its _foreach temporaries
    # over every parameter), after the activations are freed: the
    # activations' peak is that of a step's forward and backward
    peaks = _remat_peaks(torch, "text_classify", model_dir, train_tsv,
                         BATCH, REMAT, seed)
    if not all(peaks[p] < peaks["none"] for p in REMAT[1:]):
        raise AssertionError("--remat did not lower the forward and "
                             "backward's peak memory: %s" % peaks)
    bart_dir = os.path.join(workdir, BART_MODEL_DIR)
    layers = BART_BASE["encoder_layers"]
    bart = counted(
        "BART-base --remat=full (%d steps of %d x %d / %d)"
        % (BART_STEPS, BART_BATCH, BART_SEQ_LEN, BART_TARGET_TOKENS),
        lambda: run_bart_train(torch, bart_dir,
                               os.path.join(workdir, "bart_train.tsv"), None,
                               True, seed, extra=["--remat=full"]),
        {"flash_attention_fwd": 2 * 2 * layers * BART_STEPS,
         "flash_attention_bwd": 2 * layers * BART_STEPS,
         "short_attention_fwd": 2 * layers * BART_STEPS,
         "short_attention_bwd": layers * BART_STEPS})
    got = [r["loss"] for r in bart["records"]]
    want = [r["loss"] for r in bart_run["records"]]
    log("BART-base --remat=full: losses %s (phase 6's kernel run: %s); step "
        "ms median %.3f against %.3f; peak device memory %.3f GiB against "
        "%.3f GiB (%.3f GiB less)" % (
            " ".join("%.6f" % x for x in got),
            " ".join("%.6f" % x for x in want),
            statistics.median(1e3 * r["seconds"] for r in bart["records"]),
            statistics.median(1e3 * r["seconds"]
                              for r in bart_run["records"]),
            bart["peak_gib"], bart_run["peak_gib"],
            bart_run["peak_gib"] - bart["peak_gib"]))
    # the schedule depends on the run's step count: all 8 steps are run
    if got != want:
        raise AssertionError("BART --remat=full: losses %s against %s"
                             % (got, want))
    peaks = _remat_peaks(torch, "sequence_generation", bart_dir,
                         os.path.join(workdir, "bart_train.tsv"),
                         BART_BATCH, ("none", "full"), seed)
    if not peaks["full"] < peaks["none"]:
        raise AssertionError("BART --remat=full did not lower the forward "
                             "and backward's peak memory: %s" % peaks)
    part_s["remat"] = time.perf_counter() - t0

    # 2. --ema_decay with --async_save against synchronous saves, on the
    # first EMA_LAYERS layers; no evaluation, so that every save is made
    # (one after every EMA_SAVE_STEPS steps, and the final one)
    t0 = time.perf_counter()
    saves = steps // EMA_SAVE_STEPS + 1
    ema_dir = os.path.join(workdir, "bert-ema-cut")
    depth_cut(torch, model_dir, ema_dir, EMA_LAYERS, "num_hidden_layers")
    ema = {}
    for mode in ("sync", "async"):
        ckpt = os.path.join(workdir, "ckpt_ema_" + mode)
        extra = ["--ema_decay=%g" % EMA_DECAY,
                 "--save_checkpoint_steps=%d" % EMA_SAVE_STEPS] + (
                     ["--async_save"] if mode == "async" else [])
        ema[mode] = counted(
            "text_classify --ema_decay --save_checkpoint_steps=%d %s "
            "(%d steps, %d saves)" % (EMA_SAVE_STEPS, mode, steps, saves),
            lambda c=ckpt, e=extra: run_train(
                torch, ema_dir, train_tsv, None, c, True, seed,
                common=_common_argv(True) + e),
            {"short_attention_fwd": EMA_LAYERS * steps,
             "short_attention_bwd": EMA_LAYERS * steps})
        _check_train_run("ema " + mode, ema[mode], steps)
        with open(os.path.join(ckpt, "meta.json")) as f:
            meta = json.load(f)
        weights = torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                             weights_only=True)
        averaged = torch.load(os.path.join(ckpt, "pytorch_model_ema.bin"),
                              weights_only=True)
        moved = max(float((averaged[k] - weights[k]).abs().max())
                    for k in weights)
        if len(ema[mode]["save_s"]) != saves \
                or meta.get("ema_num_updates") != steps \
                or meta["global_step"] != steps \
                or set(averaged) != set(weights) or not moved > 0 \
                or not all(torch.isfinite(v).all()
                           for v in averaged.values()):
            raise AssertionError("EMA artifact: count %s, %d of %d keys, "
                                 "moved %.3e" % (meta.get("ema_num_updates"),
                                                 len(averaged), len(weights),
                                                 moved))
        log("--ema_decay=%g %s: the last checkpoint (step %d) has "
            "ema_num_updates %d, the average at most %.3e from its weights; "
            "save on the training thread %s s (sum %.3f); step ms median "
            "%.3f" % (EMA_DECAY, mode, meta["global_step"],
                      meta["ema_num_updates"], moved,
               " ".join("%.3f" % x for x in ema[mode]["save_s"]),
               sum(ema[mode]["save_s"]), statistics.median(
                   1e3 * r["seconds"] for r in ema[mode]["records"])))
    same = {name: _same_file(torch, os.path.join(workdir, "ckpt_ema_sync",
                                                 name),
                             os.path.join(workdir, "ckpt_ema_async", name))
            for name in OPTION_FILES}
    log("--async_save artifacts against the synchronous run's, bit for "
        "bit: %s; save time on the training thread, sync %.3f s against "
        "async %.3f s over %d saves" % (
            same, sum(ema["sync"]["save_s"]), sum(ema["async"]["save_s"]),
            len(ema["async"]["save_s"])))
    if not all(same.values()) or [r["loss"] for r in ema["sync"][
            "records"]] != [r["loss"] for r in ema["async"]["records"]]:
        raise AssertionError("async and sync saves differ: %s" % same)
    part_s["ema, async save"] = time.perf_counter() - t0

    # 3. KD: the teacher's logits from phase 4's checkpoint, then the student
    t0 = time.perf_counter()
    logits_tsv = os.path.join(workdir, "kd_teacher_logits.tsv")
    counted("KD teacher logits (--mode=predict, %d rows)" % N_ROWS,
            lambda: _cli(torch, [
                "--mode=predict", "--tables=" + train_tsv,
                "--outputs=" + logits_tsv, "--output_schema=logits",
                "--checkpoint_dir=" + os.path.join(workdir, "ckpt_kernel")]
                + _common_argv(True)),
            {"short_attention_fwd": N_LAYERS * steps})
    kd_udp = ["--user_defined_parameters=%s logits_saved_path=%s"
              % (KD_UDP, logits_tsv)]
    ckpt = os.path.join(workdir, "ckpt_kd")
    kd = counted("KD student training (%d steps + evaluation)" % steps,
                 lambda: run_train(torch, model_dir, train_tsv, dev_tsv,
                                   ckpt, True, seed,
                                   common=_common_argv(True) + kd_udp),
                 {"short_attention_fwd": N_LAYERS * (steps + eval_batches),
                  "short_attention_bwd": N_LAYERS * steps})
    _check_train_run("KD", kd, steps)
    describe_train("kd", kd)
    results, secs = _cli(torch, ["--mode=evaluate", "--tables=" + dev_tsv,
                                 "--checkpoint_dir=" + ckpt]
                         + _common_argv(True) + kd_udp)
    out = os.path.join(workdir, "pred_kd.tsv")
    counted("KD student predict", lambda: _cli(torch, [
        "--mode=predict", "--tables=" + dev_tsv, "--outputs=" + out,
        "--checkpoint_dir=" + ckpt, "--append_cols=id",
        "--output_schema=predictions,probabilities,logits"]
        + _common_argv(True) + kd_udp),
        {"short_attention_fwd": N_LAYERS * eval_batches})
    labels, _, _ = check_output(out, N_DEV_ROWS)
    log("KD (T=2, alpha=0.5) evaluate: %s in %.3f s; predict labels %s"
        % (", ".join("%s %.6f" % kv for kv in results), secs,
           {x: labels.count(x) for x in sorted(set(labels))}))
    part_s["KD"] = time.perf_counter() - t0

    # 4. PET (train, evaluate, predict) and a CPT run on the masked LM
    t0 = time.perf_counter()
    mlm_dir = os.path.join(workdir, MLM_MODEL_DIR)
    if not os.path.isdir(mlm_dir):
        mlm_dir = make_mlm_model_dir(torch, workdir, seed)
    pet_udp = ["--user_defined_parameters=enable_fewshot=true " + " ".join(
        "%s=%s" % kv for kv in PET_PATTERN.items())]
    ckpt = os.path.join(workdir, "ckpt_pet")
    pet = counted("PET training (%d steps + evaluation)" % steps,
                  lambda: run_train(torch, mlm_dir, train_tsv, dev_tsv, ckpt,
                                    True, seed,
                                    common=_common_argv(True) + pet_udp),
                  {"short_attention_fwd": N_LAYERS * (steps + eval_batches),
                   "short_attention_bwd": N_LAYERS * steps})
    _check_train_run("PET", pet, steps)
    describe_train("pet", pet)
    results, secs = _cli(torch, ["--mode=evaluate", "--tables=" + dev_tsv,
                                 "--checkpoint_dir=" + ckpt]
                         + _common_argv(True) + pet_udp)
    out = os.path.join(workdir, "pred_pet.tsv")
    counted("PET predict", lambda: _cli(torch, [
        "--mode=predict", "--tables=" + dev_tsv, "--outputs=" + out,
        "--checkpoint_dir=" + ckpt, "--output_schema=predictions,"
        "probabilities", "--append_cols=id"] + _common_argv(True)
        + ["--user_defined_parameters=enable_fewshot=true"]),
        {"short_attention_fwd": N_LAYERS * eval_batches})
    with open(out, encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    probs = np.array([[float(x) for x in r[1].split()] for r in rows])
    if len(rows) != N_DEV_ROWS or not {r[0] for r in rows} <= {
            "negative", "positive"} or np.abs(probs.sum(1) - 1).max() > 1e-3:
        raise AssertionError("PET predict output: %s" % rows[:3])
    log("PET evaluate: %s in %.3f s; predict %d rows, labels %s"
        % (", ".join("%s %.6f" % kv for kv in results), secs, len(rows),
           sorted({r[0] for r in rows})))
    cpt = counted("CPT training (%d steps)" % steps,
                  lambda: _train_python(torch, "cpt", mlm_dir, train_tsv,
                                        seed), {
                      "short_attention_fwd": N_LAYERS * steps,
                      "short_attention_bwd": N_LAYERS * steps})
    recs = cpt.step_records
    if len(recs) != steps or not all(np.isfinite([r["loss"], r["cl_loss"]])
                                     .all() for r in recs):
        raise AssertionError("CPT run: %s" % recs)
    log("CPT %d steps: loss %s, of it the contrastive term %s; step ms "
        "median %.3f" % (steps, " ".join("%.4f" % r["loss"] for r in recs),
                         " ".join("%.4f" % r["cl_loss"] for r in recs),
                         statistics.median(1e3 * r["seconds"]
                                           for r in recs)))
    del cpt
    part_s["PET, CPT"] = time.perf_counter() - t0

    # 5. MetaKD: no attention kernel in the teacher's or the student's runs
    t0 = time.perf_counter()
    metakd_tsv = make_metakd_tsv(train_tsv, os.path.join(
        workdir, "metakd_train.tsv"), seed + 17, METAKD_STEPS * BATCH)
    teacher = counted("MetaTeacherTrainer (enable_metakd, %d steps)"
                      % METAKD_STEPS,
                      lambda: _train_python(torch, "teacher", model_dir,
                                            metakd_tsv, seed), {})
    student_dir = os.path.join(workdir, "bert-base-metakd-student")
    os.makedirs(student_dir, exist_ok=True)
    shutil.copy(os.path.join(model_dir, "vocab.txt"), student_dir)
    with open(os.path.join(model_dir, "config.json")) as f:
        config = json.load(f)
    # half the teacher's depth (each student layer matched to every second
    # teacher layer) at its full width
    student_layers = config["num_hidden_layers"] // 2
    config.update(num_hidden_layers=student_layers,
                  fit_size=config["hidden_size"])
    with open(os.path.join(student_dir, "config.json"), "w") as f:
        json.dump(config, f)
    for stage in ("first", "second"):
        run = counted("MetaDistillationTrainer stage %s (%d steps)"
                      % (stage, METAKD_STEPS),
                      lambda s=stage: _train_python(
                          torch, "student", student_dir, metakd_tsv, seed,
                          teacher_app=teacher.app, stage=s), {})
        recs = run.step_records
        if len(recs) != METAKD_STEPS or not all(
                np.isfinite(r["loss"]) for r in recs):
            raise AssertionError("MetaKD stage %s: %s" % (stage, recs))
        log("MetaKD stage %s (%d-layer student, teacher frozen in the same "
            "step): losses %s%s; step ms median %.3f"
            % (stage, student_layers,
               " ".join("%.4f" % r["loss"] for r in recs),
               "; attention loss %s" % " ".join(
                   "%.4f" % r["att_loss"] for r in recs)
               if stage == "first" else "",
               statistics.median(1e3 * r["seconds"] for r in recs)))
    log("MetaTeacherTrainer: losses %s, domain loss %s; step ms median %.3f"
        % (" ".join("%.4f" % r["loss"] for r in teacher.step_records),
           " ".join("%.4f" % r["domain_loss"]
                    for r in teacher.step_records),
           statistics.median(1e3 * r["seconds"]
                             for r in teacher.step_records)))
    del teacher
    part_s["MetaKD"] = time.perf_counter() - t0

    # 6. LoRA: the base stays, the adapters move, the merged checkpoint
    # predicts what the live model does
    t0 = time.perf_counter()
    ckpt = os.path.join(workdir, "ckpt_lora")
    lora_udp = ["--user_defined_parameters=" + LORA_UDP]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    at_start = torch.cuda.memory_allocated()
    argv = ["--mode=train", "--tables=%s,%s" % (train_tsv, dev_tsv),
            "--pretrained_model_name_or_path=" + model_dir,
            "--checkpoint_dir=" + ckpt, "--epoch_num=1",
            "--learning_rate=%g" % LEARNING_RATE, "--optimizer_type=AdamW",
            "--logging_steps=1", "--random_seed=%d" % seed] \
        + _common_argv(True) + lora_udp
    trainer, _ = counted("LoRA training (%d steps + evaluation)" % steps,
                         lambda: _cli(torch, argv),
                         {"short_attention_fwd": N_LAYERS * (
                             steps + eval_batches),
                          "short_attention_bwd": N_LAYERS * steps})
    peak = (torch.cuda.max_memory_allocated() - at_start) / 2 ** 30
    base = torch.load(os.path.join(ckpt, "pytorch_model_base.bin"),
                      weights_only=True)
    start = torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                       weights_only=True)
    adapters = torch.load(os.path.join(ckpt, "pytorch_model_lora.bin"),
                          weights_only=True)
    moved = max(float(v.abs().max()) for k, v in adapters.items()
                if k.endswith("lora_b"))
    if not all(torch.equal(v, start[k]) for k, v in base.items()) or \
            len(adapters) != 2 * 3 * N_LAYERS or not moved > 0:
        raise AssertionError("LoRA: base changed or adapters %d, moved %.3e"
                             % (len(adapters), moved))
    out = os.path.join(workdir, "pred_lora.tsv")
    counted("LoRA merged checkpoint predict", lambda: _cli(torch, [
        "--mode=predict", "--tables=" + dev_tsv, "--outputs=" + out,
        "--checkpoint_dir=" + ckpt, "--append_cols=id",
        "--output_schema=predictions,probabilities,logits"]
        + _common_argv(True)), {"short_attention_fwd": N_LAYERS
                                * eval_batches})
    check_output(out, N_DEV_ROWS)
    live, merged = _lora_logits(torch, trainer.app, ckpt, dev_tsv)
    log("LoRA r=8: %d adapter tensors over the %d query/key/value weights "
        "(%d trained parameters against %d), lora_b at most %.3e; base bit "
        "for bit the pretrained weights; step ms median %.3f against the "
        "full fine-tune's %.3f (--remat=none above); peak %.3f GiB against "
        "%.3f (the full fine-tune's without evaluation); merged "
        "checkpoint's logits against the live model's: max |d| %.3e over %d "
        "rows" % (
            len(adapters), 3 * N_LAYERS,
            sum(p.numel() for p in trainer.params),
            sum(v.numel() for v in start.values()), moved,
            statistics.median(1e3 * r["seconds"]
                              for r in trainer.step_records),
            statistics.median(1e3 * r["seconds"]
                              for r in runs["none"]["records"]),
            peak, runs["none"]["peak_gib"],
            float(np.abs(live - merged).max()), len(live)))
    if not np.array_equal(live, merged):
        raise AssertionError("the merged checkpoint's logits differ from "
                             "the live LoRA model's")
    del trainer
    part_s["LoRA"] = time.perf_counter() - t0
    log("phase 13 seconds by part: %s; total %.1f" % (", ".join(
        "%s %.1f" % kv for kv in part_s.items()),
        time.perf_counter() - t_phase))
    return launches


def _remat_peaks(torch, app_name, model_dir, tsv, batch_size, policies,
                 seed):
    """{policy: GiB} that one training step's forward and backward
    allocate on the card above what is held before it (the activations,
    the gradients, workspace), on tsv's first batch_size rows as the
    Trainer featurises them, bf16 with the kernels; the losses must agree
    bit for bit."""
    from easynlp_tpu_torch.appzoo import api
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        set_remat)
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    argv = (_common_argv(True) if app_name == "text_classify"
            else _bart_argv(True))
    args = initialize_easynlp(args_list=argv + [
        "--random_seed=%d" % seed])
    ds = api._resolve(api.DATASET_REGISTRY, app_name, {})(
        data_file=tsv, is_training=True,
        **api._dataset_kwargs(args, tokenizer_for(model_dir)))
    app = api._resolve(api.MODEL_REGISTRY, app_name, {}).from_pretrained(
        model_dir, args=args, dtype=torch.bfloat16, device="cuda",
        num_labels=max(len(ds.label_enumerate_values), 2))
    batch = {k: torch.from_numpy(v[:batch_size]).cuda()
             for k, v in ds.features.items()}
    app.module.train()
    peaks, losses = {}, {}
    for policy in policies:
        set_remat(app.module, policy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        torch.manual_seed(seed)
        loss = app.loss_fn(app.forward(batch), batch)["loss"]
        loss.backward()
        loss = loss.detach()
        torch.cuda.synchronize()
        peaks[policy] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        losses[policy] = loss.item()
        for p in app.module.parameters():
            p.grad = None
    log("%s, one step's forward and backward at %d x %s: peak device "
        "memory above the step's start %s GiB (%s GiB under none); losses "
        "%s" % (app_name, batch_size, "x".join(
            str(n) for n in batch["input_ids"].shape[1:]), ", ".join(
            "%s %.3f" % kv for kv in peaks.items()), ", ".join(
            "%s %.3f" % (p, peaks["none"] - v) for p, v in peaks.items()
            if p != "none"), losses))
    if len(set(losses.values())) != 1:
        raise AssertionError("--remat changed the loss: %s" % losses)
    return peaks


def _train_python(torch, kind, model_dir, tsv, seed, teacher_app=None,
                  stage=None):
    """The A12 trainers the JAX package reaches only from Python:
    CPTClassification through the Trainer ('cpt'), MetaTeacherTrainer
    ('teacher') and MetaDistillationTrainer ('student', at `stage`), on
    the card in bf16 with the kernels. Returns the trainer."""
    from easynlp_tpu_torch.core.distiller import (
        MetaDistillationTrainer,
        MetaTeacherTrainer,
    )
    from easynlp_tpu_torch.core.trainer import Trainer
    from easynlp_tpu_torch.distillation.distill_metakd_application import (
        MetaStudentClassification,
        MetaTeacherClassification,
    )
    from easynlp_tpu_torch.distillation.distill_metakd_dataset import (
        MetaKDClassificationDataset,
    )
    from easynlp_tpu_torch.fewshot_learning.fewshot_application import (
        CPTClassification)
    from easynlp_tpu_torch.fewshot_learning.fewshot_dataset import (
        FewshotDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    schema = "id:str:1,sentence:str:1,label:str:1"
    args = initialize_easynlp(args_list=[
        "--mode=train", "--epoch_num=1", "--learning_rate=%g"
        % LEARNING_RATE, "--optimizer_type=AdamW", "--logging_steps=1",
        "--random_seed=%d" % seed] + _common_argv(True))
    tokenizer = BertTokenizer.from_pretrained(model_dir)
    kw = dict(max_seq_length=SEQ_LEN, first_sequence="sentence",
              label_name="label")
    if kind == "cpt":
        ds = FewshotDataset(tsv, tokenizer, input_schema=schema,
                            user_defined_parameters=PET_PATTERN, **kw)
        app = CPTClassification.from_pretrained(
            model_dir, dtype=torch.bfloat16, device="cuda",
            label_mapping=ds.label_mapping)
        trainer = Trainer(app, ds, args=args)
    else:
        ds = MetaKDClassificationDataset(
            tsv, tokenizer, input_schema=schema + ",domain:str:1,"
            "weight:str:1", **kw)
        n = max(len(ds.label_enumerate_values), 2)
        if kind == "teacher":
            app = MetaTeacherClassification.from_pretrained(
                model_dir, dtype=torch.bfloat16, device="cuda", num_labels=n,
                label_mapping=ds.label_mapping)
            trainer = MetaTeacherTrainer(app, ds, args=args,
                                         user_defined_parameters={})
        else:
            app = MetaStudentClassification.from_pretrained(
                model_dir, dtype=torch.bfloat16, device="cuda", num_labels=n,
                label_mapping=ds.label_mapping)
            trainer = MetaDistillationTrainer(
                app, ds, teacher_app=teacher_app, args=args,
                user_defined_parameters={"distill_stage": stage, "T": "2"})
    trainer.train()
    torch.cuda.synchronize()
    return trainer


def _lora_logits(torch, app, ckpt, tsv):
    """(the live LoRA app's logits, the merged checkpoint's as a plain
    text_classify app) over tsv's rows in BATCH-row batches, bf16 with the
    kernels."""
    import numpy as np
    from easynlp_tpu_torch.appzoo.sequence_classification.data import (
        ClassificationDataset)
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    ds = ClassificationDataset(
        tsv, BertTokenizer.from_pretrained(ckpt), max_seq_length=SEQ_LEN,
        input_schema="id:str:1,sentence:str:1,label:str:1",
        first_sequence="sentence", label_name="label")
    merged = SequenceClassification.from_pretrained(
        ckpt, dtype=torch.bfloat16, device="cuda")
    app.module.eval()
    out = {"live": [], "merged": []}
    with torch.inference_mode():
        for s in range(0, len(ds), BATCH):
            batch = {k: torch.from_numpy(v[s:s + BATCH]).cuda()
                     for k, v in ds.features.items()
                     if k in app.model_input_keys}
            out["live"].append(app.forward(batch)["logits"].float().cpu())
            out["merged"].append(merged.forward(batch)["logits"].float()
                                 .cpu())
    return tuple(np.concatenate([t.numpy() for t in out[k]])
                 for k in ("live", "merged"))


# --------------------------------------------------------------------------
# phase 14: the knowledge models (DKPLM, CKBERT and Kangaroo pretraining
# through language_modeling; MegatronBERT-345M; K-BERT)
# --------------------------------------------------------------------------

MEGATRON_345M = {  # HF MegatronBertConfig defaults: megatron-bert-cased-345m
    "model_type": "megatron-bert", "architectures": ["MegatronBertModel"],
    "vocab_size": 29056, "hidden_size": 1024, "num_hidden_layers": 24,
    "num_attention_heads": 16, "intermediate_size": 4096,
    "max_position_embeddings": 512, "type_vocab_size": 2,
    "hidden_act": "gelu", "layer_norm_eps": 1e-12, "initializer_range": 0.02,
    "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
    "pad_token_id": 0,
}
MEGATRON_DIR = "megatron-bert-345m-random"
# its first 4 of 24 layers at full width (all 24 until slice 12, 8 until
# slice 14): the pass checks the pre-LN layout and B2's route 2 at 16
# heads, which a layer shows as well as 24
MEGATRON_LAYERS = 4
MEGATRON_BATCH, MEGATRON_SEQ = 8, 512
# kernel pass against plain pass, bf16 through 24 pre-LN layers: the loss's
# relative |d| and the last hidden state's relative rms (readings 6.9e-3
# and 1.4e-2 on an H100 80GB HBM3 at 700 W), and the gradients' relative
# rms over all parameters (reading 3.2e-3, same card)
MEGATRON_RTOL = 5e-2
MEGATRON_GRAD_RTOL = 1e-2
# the knowledge variants' training runs, kernels against plain: each
# step's gradient norm, relative (largest reading 6.4e-4, same card)
KG_GRAD_NORM_RTOL = 5e-3
# DKPLM's TransE tables (knowledge_emb_size) and Kangaroo's knowledge sizes:
# the JAX package's dataset defaults, in the config and the data alike
KG_DIM = 100
KG_ENTITIES, KG_RELATIONS = 2000, 50
KANGAROO = {"ent_size": 100, "ent_heads": 4, "concept_size": 100,
            "ent_num": 3, "sample_num": 4}
KANGAROO_UDP = "ent_num=3 sample_num=4 entity_gap=5 concept_size=100"


def _knowledge_tables(workdir, cjk, seed):
    """DKPLM's entity and relation tables (comma-separated text), and
    Kangaroo's entity CSV, contrastive samples (level_1..4 sentences of
    3-30 characters) and Poincaré concept table (utils/poincare.py over a
    tree of the entities), all from the seed. Returns (paths, entity
    names)."""
    import csv

    import numpy as np
    from easynlp_tpu_torch.utils.poincare import train_concept_embeddings
    rng = np.random.RandomState(seed + 14)
    common = cjk[:3000]
    paths = {}
    for name, n in (("entity_emb", KG_ENTITIES), ("rel_emb", KG_RELATIONS)):
        paths[name] = os.path.join(workdir, name + ".txt")
        np.savetxt(paths[name], rng.standard_normal((n, KG_DIM)) * 0.1,
                   fmt="%.6f", delimiter=",")
    names = []
    seen = set()
    while len(names) < 2 * KG_ENTITIES:
        name = "".join(rng.choice(common[:400], rng.randint(2, 5)))
        if name not in seen:
            seen.add(name)
            names.append(name)
    paths["entity_file"] = os.path.join(workdir, "entities.csv")
    with open(paths["entity_file"], "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(["index", "main_name", "name_list"])
        for i in range(KG_ENTITIES):
            w.writerow([i, names[2 * i], names[2 * i + 1]])
    samples = {}
    for i in range(KG_ENTITIES):
        samples[i] = {}
        for level in range(1, KANGAROO["sample_num"] + 1 - i % 2):
            text = "".join(rng.choice(common, rng.randint(3, 31)))
            samples[i]["level_%d" % level] = [
                {"tokens": text, "position_id": list(range(len(text)))}]
    paths["samples_file"] = os.path.join(workdir, "samples.npy")
    np.save(paths["samples_file"], samples, allow_pickle=True)
    paths["concept_emb_file"] = os.path.join(workdir, "concepts.npy")
    tree = [(i, (i - 1) // 4) for i in range(1, KG_ENTITIES)]
    train_concept_embeddings(tree, KG_ENTITIES, dim=KANGAROO["concept_size"],
                             out_file=paths["concept_emb_file"], epochs=2,
                             seed=seed)
    return paths, names


def _knowledge_tsvs(workdir, cjk, names, seed):
    """dkplm_{train,dev}.tsv (id, a dict literal with [ENT]-marked spans
    and their relation and entity ids) and kangaroo_{train,dev}.tsv (id,
    text naming 0-5 entities); N_ROWS and N_DEV_ROWS rows each."""
    import numpy as np
    rng = np.random.RandomState(seed + 15)
    common = cjk[400:3000]

    def filler(lo, hi):
        return "".join(rng.choice(common, rng.randint(lo, hi)))
    for split, n in (("train", N_ROWS), ("dev", N_DEV_ROWS)):
        with open(os.path.join(workdir, "dkplm_%s.tsv" % split), "w",
                  encoding="utf-8") as f:
            for i in range(n):
                k = rng.randint(1, 4)
                text = "".join(filler(5, 40) + "[ENT]%s[ENT]" % filler(2, 5)
                               for _ in range(k)) + filler(5, 40)
                rels = [int(x) for x in rng.randint(0, KG_RELATIONS, k)]
                ents = [int(x) for x in rng.randint(0, KG_ENTITIES, k)]
                f.write("%d\t%r\n" % (i, {"text": text, "relation_id": rels,
                                          "replced_entity_id": ents}))
        with open(os.path.join(workdir, "kangaroo_%s.tsv" % split), "w",
                  encoding="utf-8") as f:
            for i in range(n):
                parts = []
                for _ in range(rng.randint(0, 6)):
                    parts += [filler(3, 20), names[rng.randint(len(names))]]
                f.write("%d\t%s\n" % (i, "".join(parts) + filler(10, 60)))


def _knowledge_argv(use_kernel, udp):
    return ["--app_name=language_modeling", "--device=cuda",
            "--dtype=bfloat16", "--sequence_length=%d" % SEQ_LEN,
            "--micro_batch_size=%d" % BATCH,
            "--input_schema=id:str:1,text:str:1", "--first_sequence=text",
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false"),
            "--user_defined_parameters=" + udp]


def _make_knowledge_dirs(torch, workdir, seed):
    """(DKPLM dir, Kangaroo dir): phase 11's BERT-base masked LM with
    knowledge_emb_size in its config (know_linear starts at its init from
    seed 0, as a BERT checkpoint has none), and a Kangaroo directory at
    bert-base-chinese widths with the default layer types (4 sim, 4 norm,
    4 mix) whose pytorch_model.bin, under the reference names, is the
    module's truncated-normal(0.02) init from the seed."""
    import shutil
    from easynlp_tpu_torch.modelzoo.models.kangaroo import (
        KangarooConfig, KangarooForPreTraining)
    from easynlp_tpu_torch.modelzoo.models.kangaroo.modeling_kangaroo import (
        reference_state_dict)
    src = os.path.join(workdir, MLM_MODEL_DIR)
    dkplm = os.path.join(workdir, "dkplm-bert-base")
    shutil.copytree(src, dkplm)
    with open(os.path.join(dkplm, "config.json")) as f:
        config = json.load(f)
    config["knowledge_emb_size"] = KG_DIM
    with open(os.path.join(dkplm, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    kangaroo = os.path.join(workdir, "kangaroo-base")
    os.makedirs(kangaroo)
    shutil.copy(os.path.join(src, "vocab.txt"), kangaroo)
    cfg = dict(BERT_BASE_CHINESE, model_type="kangaroo",
               architectures=["KangarooForPreTraining"], **KANGAROO)
    with open(os.path.join(kangaroo, "config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    module = KangarooForPreTraining(
        KangarooConfig.from_pretrained(kangaroo), device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    torch.save({k: v.cpu() for k, v in reference_state_dict(module).items()},
               os.path.join(kangaroo, "pytorch_model.bin"))
    del module
    return dkplm, kangaroo


def _megatron_dir(torch, workdir, seed):
    """HF MegatronBertModel names and config.json (model_type
    megatron-bert), truncated-normal(0.02) weights from the seed, unit
    LayerNorms, zero biases."""
    import numpy as np
    path = os.path.join(workdir, MEGATRON_DIR)
    os.makedirs(path)
    c = dict(MEGATRON_345M, num_hidden_layers=MEGATRON_LAYERS)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(c, f, indent=2)
    rng = np.random.default_rng(seed + 16)
    e, inter, std = c["hidden_size"], c["intermediate_size"], \
        c["initializer_range"]
    state = {}

    def t(shape):
        return torch.from_numpy(_truncated_normal(rng, shape, std))

    def dense(name, n_out, n_in):
        state[name + ".weight"] = t((n_out, n_in))
        state[name + ".bias"] = torch.zeros(n_out)

    def norm(name):
        state[name + ".weight"] = torch.ones(e)
        state[name + ".bias"] = torch.zeros(e)
    for name, rows in (("word", c["vocab_size"]),
                       ("position", c["max_position_embeddings"]),
                       ("token_type", c["type_vocab_size"])):
        state["embeddings.%s_embeddings.weight" % name] = t((rows, e))
    for i in range(c["num_hidden_layers"]):
        base = "encoder.layer.%d." % i
        norm(base + "attention.ln")
        for proj in ("query", "key", "value"):
            dense(base + "attention.self." + proj, e, e)
        dense(base + "attention.output.dense", e, e)
        norm(base + "ln")
        dense(base + "intermediate.dense", inter, e)
        dense(base + "output.dense", e, inter)
    norm("encoder.ln")
    dense("pooler.dense", e, e)
    torch.save(state, os.path.join(path, "pytorch_model.bin"))
    return path, sum(v.numel() for v in state.values())


def _encoder_pass(torch, module, inputs, w, backward=True):
    """(f32 last hidden state, pooler output, loss, seconds): one forward
    and, with backward, one backward of a fixed projection of both."""
    module.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = module(**inputs)
    loss = (out["last_hidden_state"].float() * w).mean() \
        + (out["pooler_output"].float() * w).mean()
    if backward:
        loss.backward()
    torch.cuda.synchronize()
    return (out["last_hidden_state"].detach().float(),
            out["pooler_output"].detach().float(), float(loss.detach()),
            time.perf_counter() - t0)


def phase_knowledge(torch, seed, workdir, cjk):
    """Phase 14. DKPLM, CKBERT and Kangaroo pretraining (8 AdamW steps of
    32 x 128 and evaluate, with and without the kernels), MegatronBERT-345M
    through AutoModel (a bf16 forward and backward at 8 x 512) and K-BERT
    at bert-base widths with a visible matrix (no kernel launch). Returns
    the launches of each counted wrapper in the main path's runs, each
    counted from 0."""
    import shutil

    import numpy as np
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        KangarooLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.auto import AutoModel
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 14: knowledge models (DKPLM, CKBERT, Kangaroo "
        "pretraining; MegatronBERT-345M; K-BERT)")
    t_phase = time.perf_counter()
    counted = ("short_attention_fwd", "short_attention_bwd")
    launches = dict.fromkeys(counted, 0)

    def main_path(what, fn, want):
        for w in counted:
            getattr(A, w).launches = 0
        out = fn()
        used = {w: getattr(A, w).launches for w in counted}
        log("%s launches: %s (want %s)" % (what, used, want))
        if used != want:
            raise AssertionError("%s launched %s, want %s"
                                 % (what, used, want))
        for w in counted:
            launches[w] += used[w]
        return out

    def no_launch(what, fn):
        before = {w: getattr(A, w).launches for w in counted}
        out = fn()
        if {w: getattr(A, w).launches for w in counted} != before:
            raise AssertionError("%s launched a kernel" % what)
        return out

    t0 = time.perf_counter()
    paths, names = _knowledge_tables(workdir, cjk, seed)
    _knowledge_tsvs(workdir, cjk, names, seed)
    dkplm_dir, kangaroo_dir = _make_knowledge_dirs(torch, workdir, seed)
    log("knowledge tables (%d entities, %d relations, %d-wide TransE and "
        "concept tables), TSVs and directories made from seed %d in %.3f s"
        % (KG_ENTITIES, KG_RELATIONS, KG_DIM, seed,
           time.perf_counter() - t0))
    steps, eval_batches = N_ROWS // BATCH, -(-N_DEV_ROWS // BATCH)
    n_sim = N_LAYERS // 3  # Kangaroo's default layer types: a third sim
    variants = {
        # name: (model dir, udp, table prefix, B1 per training step, B1
        # per evaluated batch)
        "DKPLM": (dkplm_dir, "enable_dkplm=true entity_emb_file=%s "
                  "rel_emb_file=%s" % (paths["entity_emb"],
                                       paths["rel_emb"]), "dkplm",
                  N_LAYERS, N_LAYERS),
        "CKBERT": (os.path.join(workdir, MLM_MODEL_DIR),
                   "contrast_learning_flag=true", "kangaroo",
                   2 * N_LAYERS, N_LAYERS),
        "Kangaroo": (kangaroo_dir, "enable_kangaroo=true entity_file=%s "
                     "samples_file=%s concept_emb_file=%s %s"
                     % (paths["entity_file"], paths["samples_file"],
                        paths["concept_emb_file"], KANGAROO_UDP),
                     "kangaroo", N_LAYERS + n_sim, N_LAYERS + n_sim),
    }
    summary = {}
    for name, (model_dir, udp, tables, per_step, per_batch) in \
            variants.items():
        t0 = time.perf_counter()
        train_tsv = os.path.join(workdir, "%s_train.tsv" % tables)
        dev_tsv = os.path.join(workdir, "%s_dev.tsv" % tables)
        # only the kernel run writes a checkpoint, which both evaluates
        # read (each run wrote its own until slice 12)
        runs, ckpt = {}, os.path.join(workdir, "%s_ckpt" % name)
        for use_kernel in (True, False):
            tag = "kernel" if use_kernel else "plain"

            def train(k=use_kernel):
                return run_train(torch, model_dir, train_tsv, dev_tsv,
                                 ckpt if k else None, k, seed,
                                 common=_knowledge_argv(k, udp),
                                 logging_steps=1)
            runs[tag] = (main_path(
                "%s training (%d steps + evaluation)" % (name, steps),
                train, {"short_attention_fwd": per_step * steps
                        + per_batch * eval_batches,
                        "short_attention_bwd": per_step * steps})
                if use_kernel else no_launch(name + " training", train))
            _check_train_run(name + " " + tag, runs[tag], steps)
            describe_train("%s-%s" % (name[:3], tag[0]), runs[tag])
        results = {}
        for tag, use_kernel in (("kernel", True), ("plain", False)):
            argv = ["--mode=evaluate", "--tables=" + dev_tsv,
                    "--checkpoint_dir=" + ckpt] + _knowledge_argv(
                        use_kernel, udp)
            run = (lambda a=argv: dict(_cli(torch, a)[0]))
            results[tag] = (main_path(
                name + " evaluate", run, {
                    "short_attention_fwd": per_batch * eval_batches,
                    "short_attention_bwd": 0})
                if use_kernel else no_launch(name + " evaluate", run))
        final = [r for r in map(json.loads, open(os.path.join(
            ckpt, "events.jsonl"))) if r["kind"] == "eval"][-1]
        k, p = results["kernel"], results["plain"]
        # every step's loss and gradient norm, kernel run against plain
        # run: the later steps carry each earlier step's gradients
        pairs = list(zip(runs["kernel"]["records"],
                         runs["plain"]["records"]))
        d_loss = max(abs(a["loss"] - b["loss"]) for a, b in pairs)
        d_gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                      for a, b in pairs)
        d_acc = abs(k["accuracy"] - p["accuracy"])
        d_ppl = abs(np.log(k["perplexity"] / p["perplexity"]))
        med = {tag: statistics.median(1e3 * r["seconds"]
                                      for r in runs[tag]["records"])
               for tag in runs}
        log("%s: loss kernel %s vs plain %s (max |d| over the %d steps "
            "%.3e, bound %.1e); gradient norm max relative |d| %.3e (bound "
            "%.1e); evaluate accuracy %.6f vs %.6f (|d| %.3e, bound %.1e), "
            "perplexity %.4f vs %.4f (|d log| %.3e, bound %.1e); step ms "
            "median %.3f vs %.3f; peak %.3f vs %.3f GiB; %.1f s"
            % (name, " ".join("%.6f" % a["loss"] for a, _ in pairs),
               " ".join("%.6f" % b["loss"] for _, b in pairs), len(pairs),
               d_loss, MLM_LOSS_ATOL, d_gnorm, KG_GRAD_NORM_RTOL,
               k["accuracy"], p["accuracy"], d_acc, MLM_ACCURACY_ATOL,
               -k["perplexity"], -p["perplexity"], d_ppl, MLM_LOSS_ATOL,
               med["kernel"], med["plain"], runs["kernel"]["peak_gib"],
               runs["plain"]["peak_gib"], time.perf_counter() - t0))
        for metric in ("accuracy", "perplexity"):
            if abs(final[metric] - k[metric]) > 1e-9 * abs(final[metric]):
                raise AssertionError("%s evaluate disagrees with the "
                                     "trainer's final evaluation: %s vs %s"
                                     % (name, k, final))
        if d_loss > MLM_LOSS_ATOL or d_gnorm > KG_GRAD_NORM_RTOL \
                or d_acc > MLM_ACCURACY_ATOL \
                or d_ppl > MLM_LOSS_ATOL or not (
                    k["perplexity"] < 0
                    and np.isfinite(list(k.values())).all()):
            raise AssertionError("%s kernel and plain runs disagree" % name)
        summary[name] = (med["kernel"], med["plain"],
                         runs["kernel"]["peak_gib"])
        if name == "Kangaroo":
            check_repeat(name, runs["kernel"], main_path(
                "%s training again (%d steps)" % (name, steps),
                lambda: run_train(torch, model_dir, train_tsv, None, None,
                                  True, seed, common=_knowledge_argv(True,
                                                                     udp)),
                {"short_attention_fwd": per_step * steps,
                 "short_attention_bwd": per_step * steps}))
            _kangaroo_masked_samples(torch, ckpt, dev_tsv, udp)
        shutil.rmtree(ckpt)

    # MegatronBERT-345M through AutoModel: a bf16 forward and backward
    t0 = time.perf_counter()
    mdir, n_params = _megatron_dir(torch, workdir, seed)
    made_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    module = AutoModel.from_pretrained(mdir, dtype=torch.bfloat16,
                                       device="cuda")
    load_s = time.perf_counter() - t0
    rng = np.random.RandomState(seed + 17)
    lengths = np.r_[MEGATRON_SEQ, rng.randint(256, MEGATRON_SEQ + 1,
                                              MEGATRON_BATCH - 1)]
    mask = (np.arange(MEGATRON_SEQ)[None] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask == 1, rng.randint(
        1000, MEGATRON_345M["vocab_size"], mask.shape), 0)
    inputs = {"input_ids": torch.from_numpy(ids).cuda(),
              "attention_mask": torch.from_numpy(mask).cuda()}
    w = torch.linspace(-1, 1, MEGATRON_345M["hidden_size"], device="cuda")
    n_layers = MEGATRON_LAYERS
    # the kernels (--use_flash_attention=auto); the plain runs above left
    # the override set
    A.set_kernel_override(None)
    hk, pk, lk, sk = main_path(
        "MegatronBERT-345M forward + backward (%d x %d)"
        % (MEGATRON_BATCH, MEGATRON_SEQ),
        lambda: _encoder_pass(torch, module, inputs, w),
        dict.fromkeys(counted, n_layers))
    grads = [p.grad.detach().clone() for p in module.parameters()]
    finite = all(torch.isfinite(g).all() for g in grads)
    again = [_encoder_pass(torch, module, inputs, w)[3] for _ in range(3)]
    A.set_kernel_override(False)
    try:
        hp, pp, lp, sp = no_launch("MegatronBERT-345M (plain)",
                                   lambda: _encoder_pass(torch, module,
                                                         inputs, w))
        plain_grads = [p.grad.detach().clone() for p in module.parameters()]
        plain_again = [_encoder_pass(torch, module, inputs, w)[3]
                       for _ in range(3)]
    finally:
        A.set_kernel_override(None)
    real = torch.from_numpy(mask).cuda().bool()
    d_hidden = float((hk - hp).abs()[real].max())
    rms = float((hk - hp)[real].pow(2).mean().sqrt()
                / hp[real].pow(2).mean().sqrt())
    d_pool = float((pk - pp).abs().max())
    rel_loss = abs(lk - lp) / abs(lp)
    # the gradients, kernel pass against plain pass: relative rms over all
    # parameters (a single tensor's can be rounding noise: at this init the
    # scores are near uniform, so the q/k projections' gradients are near
    # zero)
    sq = [(float((g.float() - h.float()).pow(2).sum()),
           float(h.float().pow(2).sum())) for g, h in zip(grads, plain_grads)]
    g_rel = (sum(d for d, _ in sq) / sum(n for _, n in sq)) ** 0.5
    log("MegatronBERT-345M (%d parameters, %d layers, pre-LN, HF names): "
        "written in %.3f s, AutoModel.from_pretrained %.3f s; forward + "
        "backward %.3f s the first (the kernels' first launches), then "
        "%s s, plain %s s; kernel vs plain: loss %.6f vs %.6f (relative "
        "|d| %.3e, bound %.1e), pooler output max |d| %.3e (bound %.1e), "
        "last hidden state max |d| %.3e over the real tokens, relative rms "
        "%.3e (bound %.1e); gradients finite: %s, relative rms %.3e (bound "
        "%.1e); peak device memory %.3f GiB"
        % (n_params, n_layers, made_s, load_s, sk,
           " ".join("%.3f" % s for s in again),
           " ".join("%.3f" % s for s in [sp] + plain_again), lk, lp,
           rel_loss, MEGATRON_RTOL, d_pool, SLICE_ATOL, d_hidden, rms,
           MEGATRON_RTOL, finite, g_rel, MEGATRON_GRAD_RTOL,
           torch.cuda.max_memory_allocated() / 2 ** 30))
    if not finite or rel_loss > MEGATRON_RTOL or d_pool > SLICE_ATOL \
            or rms > MEGATRON_RTOL or g_rel > MEGATRON_GRAD_RTOL \
            or not torch.isfinite(hk).all():
        raise AssertionError("MegatronBERT-345M: kernel and plain passes "
                             "disagree, or non-finite values")
    del module, grads, plain_grads
    shutil.rmtree(mdir)

    # K-BERT at bert-base widths with a visible matrix: no kernel launches
    t0 = time.perf_counter()
    kdir = os.path.join(workdir, "kbert-base")
    os.makedirs(kdir)
    src = os.path.join(workdir, MODEL_DIR)
    shutil.copy(os.path.join(src, "pytorch_model.bin"), kdir)
    with open(os.path.join(kdir, "config.json"), "w") as f:
        json.dump(dict(BERT_BASE_CHINESE, model_type="kbert"), f)
    module = AutoModel.from_pretrained(kdir, dtype=torch.bfloat16,
                                       device="cuda")
    rng = np.random.RandomState(seed + 18)
    lengths = rng.randint(40, SEQ_LEN + 1, BATCH)
    mask = (np.arange(SEQ_LEN)[None] < lengths[:, None]).astype(np.int32)
    branch = (rng.rand(BATCH, SEQ_LEN) < 0.25) & (mask == 1)
    branch[:, 0] = False
    # a branch token sees its branch-mates and its anchor's trunk token;
    # trunk tokens see the trunk
    anchor = np.maximum.accumulate(np.where(branch, 0, np.arange(SEQ_LEN)),
                                   axis=1)
    same = anchor[:, :, None] == anchor[:, None, :]
    visible = np.where(branch[:, :, None] | branch[:, None, :], same,
                       True).astype(np.int32)
    position = np.cumsum(~branch, axis=1) - 1 + np.where(
        branch, np.cumsum(branch, axis=1) % 3, 0)
    ids = np.where(mask == 1, rng.randint(
        200, BERT_BASE_CHINESE["vocab_size"], mask.shape), 0)
    inputs = {k: torch.from_numpy(v).cuda() for k, v in (
        ("input_ids", ids), ("attention_mask", mask),
        ("position_ids", position), ("visible_matrix", visible))}
    w = torch.linspace(-1, 1, BERT_BASE_CHINESE["hidden_size"],
                       device="cuda")
    A.set_kernel_override(None)
    hk, _, lk, sk = no_launch("K-BERT forward + backward",
                              lambda: _encoder_pass(torch, module, inputs,
                                                    w))
    del inputs["visible_matrix"]
    hv, _, _, _ = _encoder_pass(torch, module, inputs, w, backward=False)
    moved = float((hk - hv).abs().max())
    log("K-BERT (bert-base widths, %d x %d, %.1f%% of the real key pairs "
        "hidden by the visible matrix, soft positions): forward + backward "
        "%.3f s on attention's plain path (an additive bias: no kernel "
        "launched, as designed); loss %.6f; the visible matrix moves the "
        "hidden states by up to %.3e; %.1f s"
        % (BATCH, SEQ_LEN, 100 * float(((visible == 0) & (mask[:, None] == 1)
                                        & (mask[:, :, None] == 1)).sum())
           / float((mask.sum(1) ** 2).sum()), sk, lk, moved,
           time.perf_counter() - t0))
    if not (np.isfinite(lk) and torch.isfinite(hk).all() and moved > 1e-2):
        raise AssertionError("K-BERT: non-finite, or the visible matrix "
                             "changed nothing")
    del module
    log("phase 14 step ms median kernel / plain, peak GiB: %s; total %.1f s"
        % ("; ".join("%s %.3f / %.3f, %.3f" % ((n,) + v)
                     for n, v in summary.items()),
           time.perf_counter() - t_phase))
    return launches


def _kangaroo_masked_samples(torch, ckpt, dev_tsv, udp):
    """The trained Kangaroo's sample encoding over the dev rows' samples
    through the kernels: every [CLS] state finite, the fully masked sample
    rows (entity slots with no entity) included."""
    from easynlp_tpu_torch.appzoo.language_modeling.kangaroo_data import (
        KangarooPretrainDataset)
    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        KangarooLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    app = KangarooLanguageModeling.from_pretrained(ckpt,
                                                   dtype=torch.bfloat16)
    ds = KangarooPretrainDataset(
        dev_tsv, BertTokenizer.from_pretrained(ckpt), max_seq_length=SEQ_LEN,
        input_schema="id:str:1,text:str:1", first_sequence="text",
        user_defined_parameters=dict(kv.split("=", 1)
                                     for kv in udp.split()))
    batch = ds.batch_fn([ds[i] for i in range(BATCH)])
    t = {k: torch.from_numpy(batch[k]).cuda() for k in
         ("sample_token_id", "sample_position_id", "sample_mask")}
    with torch.no_grad():
        cls = app.module.kangaroo.encode_samples(**t)
    empty = int((batch["sample_mask"].reshape(-1, SEQ_LEN).sum(1) == 0)
                .sum())
    log("Kangaroo sample encoding, %d x %d sample rows (%d fully masked): "
        "[CLS] states finite %s" % (cls.shape[0] * cls.shape[1]
                                    * cls.shape[2], SEQ_LEN, empty,
                                    bool(torch.isfinite(cls).all())))
    if not torch.isfinite(cls).all() or not empty:
        raise AssertionError("Kangaroo's sample encoding: non-finite [CLS] "
                             "states, or no fully masked sample row")


# --------------------------------------------------------------------------
# phase 15: T5, mT5, Pegasus, Randeng, GPT-2 evaluate, open_domain_dialogue
# --------------------------------------------------------------------------

T5_BASE = {  # HF t5-base config.json, dropout set to 0
    "model_type": "t5", "architectures": ["T5ForConditionalGeneration"],
    "vocab_size": 32128, "d_model": 768, "d_kv": 64, "d_ff": 3072,
    "num_layers": 12, "num_decoder_layers": 12, "num_heads": 12,
    "relative_attention_num_buckets": 32,
    "relative_attention_max_distance": 128, "dropout_rate": 0.0,
    "layer_norm_epsilon": 1e-6, "initializer_factor": 1.0,
    "feed_forward_proj": "relu", "tie_word_embeddings": True,
    "is_encoder_decoder": True, "pad_token_id": 0, "eos_token_id": 1,
    "decoder_start_token_id": 0,
}
MT5_BASE = dict(  # HF google/mt5-base config.json, dropout set to 0
    T5_BASE, model_type="mt5", architectures=["MT5ForConditionalGeneration"],
    vocab_size=250112, d_ff=2048, feed_forward_proj="gated-gelu",
    tie_word_embeddings=False)
PEGASUS_LARGE = {  # HF google/pegasus-large config.json, dropout set to 0
    "model_type": "pegasus",
    "architectures": ["PegasusForConditionalGeneration"],
    "vocab_size": 96103, "d_model": 1024, "encoder_layers": 16,
    "decoder_layers": 16, "encoder_attention_heads": 16,
    "decoder_attention_heads": 16, "encoder_ffn_dim": 4096,
    "decoder_ffn_dim": 4096, "max_position_embeddings": 1024,
    "activation_function": "relu", "dropout": 0.0, "attention_dropout": 0.0,
    "activation_dropout": 0.0, "scale_embedding": True,
    "normalize_before": True, "is_encoder_decoder": True,
    "pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": 0,
}
RANDENG = dict(  # IDEA-CCNL/Randeng-Pegasus-238M-Summary-Chinese widths
    PEGASUS_LARGE, model_type="randeng", vocab_size=50000, d_model=768,
    encoder_layers=12, decoder_layers=12, encoder_attention_heads=12,
    decoder_attention_heads=12, encoder_ffn_dim=3072, decoder_ffn_dim=3072,
    max_position_embeddings=512)
DIALOGUE = {  # the `transformer` family's defaults (ParlAI's reference)
    "model_type": "transformer", "vocab_size": 54944,
    "embedding_size": 512, "ffn_size": 2048, "n_layers": 8, "n_heads": 16,
    "n_positions": 512, "dropout": 0.0, "activation": "gelu",
}
T5_SP_PIECES = 32000      # t5-base's spiece.model; + 100 sentinels
PEGASUS_SP_PIECES = 96000  # pegasus-large's; + the 103 offset ids
# family: (--sequence_length, --micro_batch_size, training steps, dev or
# predict rows); every target is the dataset's 64 tokens (63 + EOS: the
# CLI's SequenceGenerationDataset fixes max_target_length at 64, as JAX's)
# (sequence length, batch, training steps, rows): T5's and the dialogue's
# 8 steps until slice 14
# 4 steps and twice the rows until slice 17
S2S_RUNS = {"t5": (512, 8, 2, 4), "mt5": (512, 8, 0, 4),
            "pegasus": (1024, 4, 2, 2), "randeng": (512, 8, 0, 4),
            "dialogue": (128, 16, 2, 8)}
# Pegasus-large and mT5-base run their first 2 encoder and 2 decoder
# layers at full width (16 + 16 and 12 + 12 until slice 12, 4 + 4 until
# slice 17: 0.36 GiB less written): T5-base's and GLM-large's steps
# measure full depth, and these paths differ from them in widths and
# vocabularies, not in depth
S2S_CUT_LAYERS = 2
S2S_TARGET_TOKENS = 64
S2S_LR = 5e-5
# Training, kernel run against the --use_flash_attention=false run, per
# step: both bf16 end to end and differing only in attention's rounding.
# Bounds from the card's readings (NVIDIA H100 80GB HBM3, 700 W): the
# largest loss gap 1.9e-3 (T5; Pegasus 9.1e-4, dialogue 9.5e-5), the
# largest relative gradient-norm gap 3.7e-3 (T5; Pegasus 2.6e-3, dialogue
# 5.4e-5). T5 has the largest: its unscaled cross-attention scores.
S2S_LOSS_ATOL = 1e-2
S2S_GNORM_RTOL = 1.5e-2


def sp_model_bytes(pieces, model_type=1, unk_id=2, bos_id=-1, eos_id=1,
                   pad_id=0, byte_fallback=False):
    """A SentencePiece ModelProto in protobuf's wire format: each piece's
    text, score and type, the trainer spec's model type, vocab size, byte
    fallback and special ids, and an nfkc normaliser spec that adds the
    dummy prefix, removes extra spaces and escapes them (the fields
    tokenization_sentencepiece reads). Written here because the card's
    machine has neither protobuf nor transformers."""
    import struct

    def varint(n):
        n &= (1 << 64) - 1  # negative int32s as 10-byte two's complement
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            if n:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    def field(num, wire, payload):
        key = varint(num << 3 | wire)
        if wire == 2:
            return key + varint(len(payload)) + payload
        return key + payload

    def integer(num, n):
        return field(num, 0, varint(int(n)))

    out = bytearray()
    for piece, score, ptype in pieces:
        out += field(1, 2, field(1, 2, piece.encode("utf-8"))
                     + field(2, 5, struct.pack("<f", score))
                     + integer(3, ptype))
    out += field(2, 2, integer(3, model_type) + integer(4, len(pieces))
                 + integer(35, byte_fallback) + integer(40, unk_id)
                 + integer(41, bos_id) + integer(42, eos_id)
                 + integer(43, pad_id))
    out += field(3, 2, field(1, 2, b"nfkc") + integer(3, 1) + integer(4, 1)
                 + integer(5, 1))
    return bytes(out)


def t5_sp_pieces(rng, n=T5_SP_PIECES):
    """n unigram pieces (text, score, type): <pad>, </s> and <unk> (T5's
    and Pegasus's ids 0-2), the 26 letters alone and after U+2581, then
    random lowercase strings of 2-5 letters, half of them after U+2581,
    each scoring higher the longer it is (words split into 2-3 pieces)."""
    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    seen = set()
    for c in GEN_LETTERS:
        for p in (c, "▁" + c):
            pieces.append((p, -12.0 - rng.random(), 1))
            seen.add(p)
    while len(pieces) < n:
        p = "".join(rng.choice(GEN_LETTERS)
                    for _ in range(rng.randint(2, 5)))
        if rng.random() < 0.5:
            p = "▁" + p
        if p not in seen:
            seen.add(p)
            pieces.append((p, -9.0 - rng.random() + 0.8 * len(p), 1))
    return pieces


def dialogue_bpe(rng, words, vocab_size):
    """(vocab tokens, merges): subword-nmt codecs v0.2 that build each of
    `words` letter by letter (so each is one token), the ParlAI specials,
    the letters, every merged piece alone and with the "@@" continuation
    mark, and filler tokens up to vocab_size."""
    merges, pieces = [], set()
    for w in words:
        for i in range(1, len(w)):
            pair = (w[:i], w[i] + ("</w>" if i == len(w) - 1 else ""))
            if pair[0] + pair[1] not in pieces:
                pieces.add(pair[0] + pair[1])
                merges.append(pair)
    tokens = ["__null__", "__start__", "__end__", "__unk__", "__newln__"]
    letters = sorted(set(GEN_LETTERS))
    body = sorted({p.replace("</w>", "") for p in pieces} | set(letters))
    tokens += body + [p + "@@" for p in body]
    tokens += ["__fill%d__" % i for i in range(vocab_size - len(tokens))]
    if len(tokens) != vocab_size:
        raise AssertionError("%d dialogue tokens for a %d vocab"
                             % (len(tokens), vocab_size))
    return tokens, merges


def make_s2s_model_dir(torch, path, config, seed, files):
    """A model directory: config.json, the tokenizer `files` ({name:
    bytes or text}) and pytorch_model.bin, the port's own init of the
    family's module from `seed` (HF T5 factors; BART's truncated 0.02) on
    the card, saved under HF names."""
    from easynlp_tpu_torch.modelzoo.models.auto import AutoConfig, AutoModel
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    for name, data in files.items():
        mode = "wb" if isinstance(data, bytes) else "w"
        with open(os.path.join(path, name), mode) as f:
            f.write(data)
    module = AutoModel.from_config(AutoConfig.from_pretrained(path))
    module.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    torch.save(module.state_dict(), os.path.join(path, "pytorch_model.bin"))
    n = sum(p.numel() for p in module.parameters())
    del module
    torch.cuda.empty_cache()
    return n


def make_s2s_tsv(path, tokenize, words, rng, n_rows, src_tokens,
                 tgt_tokens=S2S_TARGET_TOKENS + 8):
    """n_rows of (id, source, target): random `words` until each side
    passes its token count (`tokenize` counts them), so sources fill
    --sequence_length and targets the 63 + EOS target slots."""
    cost = {}

    def text(target):
        out, n = [], 0
        while n < target:
            w = rng.choice(words)
            if w not in cost:
                cost[w] = len(tokenize(w))
            out.append(w)
            n += cost[w]
        return " ".join(out)

    with open(path, "w", encoding="utf-8") as f:
        for i in range(n_rows):
            f.write("%d\t%s\t%s\n" % (i, text(src_tokens), text(tgt_tokens)))


def _s2s_argv(app, seq_len, batch, use_kernel, dtype="bfloat16"):
    return ["--app_name=" + app, "--device=cuda", "--dtype=" + dtype,
            "--sequence_length=%d" % seq_len,
            "--micro_batch_size=%d" % batch,
            "--input_schema=id:str:1,src:str:1,tgt:str:1",
            "--first_sequence=src", "--second_sequence=tgt",
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false")]


def _s2s_predict(torch, app, ckpt, tsv, out, use_kernel, seq_len, batch,
                 udp, dtype="float32"):
    """--mode=predict through the CLI entry: (seconds with load, the
    predictor's batch seconds, generated_ids [N, T])."""
    import numpy as np
    argv = ["--mode=predict", "--tables=" + tsv, "--outputs=" + out,
            "--checkpoint_dir=" + ckpt,
            "--output_schema=predictions,generated_ids", "--append_cols=id",
            "--user_defined_parameters=" + udp] + _s2s_argv(
                app, seq_len, batch, use_kernel, dtype)
    manager, seconds = _cli(torch, argv)
    with open(out, encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    if [r[2] for r in rows] != [str(i) for i in range(len(rows))]:
        raise AssertionError("%s does not parse as predictions, "
                             "generated_ids, id rows" % out)
    return seconds, list(manager.predictor.batch_seconds), np.array(
        [[int(x) for x in r[1].split()] for r in rows])


def _s2s_evaluate(torch, app, ckpt, tsv, use_kernel, seq_len, batch,
                  dtype="bfloat16", schema=None):
    argv = ["--mode=evaluate", "--tables=" + tsv,
            "--checkpoint_dir=" + ckpt] + _s2s_argv(app, seq_len, batch,
                                                    use_kernel, dtype)
    if schema:
        argv = [a for a in argv if not a.startswith(
            ("--input_schema", "--first_sequence", "--second_sequence"))]
        argv += schema
    results, seconds = _cli(torch, argv)
    if [m for m, _ in results] != ["bleu", "rouge_l"] or not all(
            0.0 <= x <= 1.0 for _, x in results):
        raise AssertionError("%s evaluate gave %s" % (app, results))
    return results, seconds


def _s2s_compare_training(tag, runs):
    """Every step's loss and gradient norm of the kernel run against the
    plain run's, within S2S_LOSS_ATOL and S2S_GNORM_RTOL; logs both runs'
    step ms (steps 2..) and peak memory."""
    rec_k, rec_p = runs[True]["records"], runs[False]["records"]
    d_loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(rec_k, rec_p))
    d_gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                  for a, b in zip(rec_k, rec_p))
    for use_kernel, run in runs.items():
        ms = [1e3 * r["seconds"] for r in run["records"]]
        log("%s train %-6s %d steps: step ms median %.3f (steps 2-%d; first "
            "%.3f), peak device memory %.3f GiB above the run's start, run "
            "%.3f s with load and save; losses %s; grad norms %s"
            % (tag, "kernel" if use_kernel else "plain", len(ms),
               statistics.median(ms[1:]), len(ms), ms[0], run["peak_gib"],
               run["total_s"], " ".join("%.5f" % r["loss"]
                                        for r in run["records"]),
               " ".join("%.4f" % r["grad_norm"] for r in run["records"])))
    log("%s kernel vs plain training: max |d loss| per step %.3e (bound "
        "%.1e), max relative grad-norm gap %.3e (bound %.1e)"
        % (tag, d_loss, S2S_LOSS_ATOL, d_gnorm, S2S_GNORM_RTOL))
    if d_loss > S2S_LOSS_ATOL or d_gnorm > S2S_GNORM_RTOL:
        raise AssertionError("%s: kernel and plain training disagree (loss "
                             "%.3e, grad norm %.3e)" % (tag, d_loss, d_gnorm))


def phase_seq2seq(torch, seed, workdir, cjk):
    """Phase 15: every path of this slice with the kernels and with
    --use_flash_attention=false. Training in bf16 (every step's loss and
    gradient norm held to the plain run's), generation in f32 (token for
    token), each path's launches counted from 0. Returns the launches of
    the paths' kernel runs by wrapper."""
    import numpy as np
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    from easynlp_tpu_torch.modelzoo.models.pegasus import PegasusTokenizer
    from easynlp_tpu_torch.modelzoo.models.t5 import T5Tokenizer
    from easynlp_tpu_torch.modelzoo.models.transformer import (
        TransformerTokenizer)
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 15: T5-base, mT5-base, Pegasus-large, Randeng, GPT-2 "
        "evaluate, open_domain_dialogue")
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")
    main_path, plain, total = _launch_counter(A, wrappers)

    def read():
        return {w: getattr(A, w).launches for w in wrappers}

    rng = random.Random(seed + 15)
    words = ["".join(rng.choice(GEN_LETTERS) for _ in range(rng.randint(2,
                                                                        9)))
             for _ in range(3000)]
    t0 = time.perf_counter()
    t5_sp = sp_model_bytes(t5_sp_pieces(rng))
    dirs = {}
    for name, config, files in (
            ("t5", T5_BASE, {"spiece.model": t5_sp}),
            ("mt5", dict(MT5_BASE, num_layers=S2S_CUT_LAYERS,
                         num_decoder_layers=S2S_CUT_LAYERS),
             {"spiece.model": t5_sp}),
            ("pegasus", dict(PEGASUS_LARGE, encoder_layers=S2S_CUT_LAYERS,
                             decoder_layers=S2S_CUT_LAYERS),
             {"spiece.model": sp_model_bytes(
                 t5_sp_pieces(rng, PEGASUS_SP_PIECES))})):
        dirs[name] = os.path.join(workdir, name + "-random")
        n = make_s2s_model_dir(torch, dirs[name], config, seed, files)
        log("%s model dir: %d parameters, %d-piece spiece.model"
            % (name, n, PEGASUS_SP_PIECES if name == "pegasus"
               else T5_SP_PIECES))
    tokens, _ = _vocab()  # bert-base-chinese's synthetic CJK WordPiece
    tokens += ["[unused%d]" % i for i in range(100, 100 + RANDENG[
        "vocab_size"] - len(tokens))]
    dirs["randeng"] = os.path.join(workdir, "randeng-random")
    make_s2s_model_dir(torch, dirs["randeng"], RANDENG, seed,
                       {"vocab.txt": "\n".join(tokens) + "\n"})
    vocab, merges = dialogue_bpe(rng, words, DIALOGUE["vocab_size"])
    dirs["dialogue"] = os.path.join(workdir, "dialogue-random")
    make_s2s_model_dir(torch, dirs["dialogue"], DIALOGUE, seed, {
        "vocab.txt": "\n".join(vocab) + "\n",
        "codecs.txt": "#version: 0.2\n" + "".join("%s %s\n" % m
                                                  for m in merges)})
    toks = {"t5": T5Tokenizer.from_pretrained(dirs["t5"]),
            "pegasus": PegasusTokenizer.from_pretrained(dirs["pegasus"]),
            "dialogue": TransformerTokenizer.from_pretrained(
                dirs["dialogue"])}
    toks["mt5"] = toks["t5"]
    tsvs = {}
    for name, (seq_len, batch, steps, rows) in S2S_RUNS.items():
        if name == "randeng":
            continue
        tokenize = toks[name].tokenize
        for kind, n in (("train", batch * steps), ("dev", rows)):
            if n:
                tsvs[name, kind] = os.path.join(workdir, "%s_%s.tsv"
                                                % (name, kind))
                make_s2s_tsv(tsvs[name, kind], tokenize, words, rng, n,
                             seq_len + 16)
    tsvs["randeng", "dev"] = os.path.join(workdir, "randeng_dev.tsv")
    with open(tsvs["randeng", "dev"], "w", encoding="utf-8") as f:
        for i in range(S2S_RUNS["randeng"][3]):
            f.write("%d\t%s\t%s\n" % (i, "".join(rng.choice(cjk[:3000])
                                                 for _ in range(600)),
                                        "".join(rng.choice(cjk[:3000])
                                                for _ in range(40))))
    log("phase 15 model dirs and tables made from seed %d in %.3f s"
        % (seed, time.perf_counter() - t0))

    # the SentencePiece encoder: 16 x 512 tokens, native against Python
    sp_model = toks["t5"].sp
    with open(tsvs["t5", "train"], encoding="utf-8") as f:
        texts = [line.split("\t")[1] for line in f][:16]
    texts = [sp_model.normalize(t) for t in texts]
    timing = {}
    for native in (True, False):
        fast = sp_model._fast
        if not native:
            sp_model._fast = False
        t0 = time.perf_counter()
        ids = [sp_model._encode_unigram(t) for t in texts]
        timing[native] = (time.perf_counter() - t0, ids)
        sp_model._fast = fast
    if timing[True][1] != timing[False][1] or not sp_model._fast:
        raise AssertionError("the native SentencePiece encoder gave other "
                             "ids, or did not load")
    log("sentencepiece encode, 16 texts of %d tokens (normalised first): "
        "native %.4f s, Python %.4f s (%.1fx); ids identical"
        % (statistics.median(len(i) for i in timing[True][1]),
           timing[True][0], timing[False][0],
           timing[False][0] / timing[True][0]))

    eos_banned = "max_decoder_length=%d min_decoder_length=%d" % (
        S2S_TARGET_TOKENS, S2S_TARGET_TOKENS)
    scores = {}

    def generation(tag, app, ckpt, name, udp, want_kernels):
        """The f32 CLI predict with the kernels (the main path) and plain:
        the same tokens."""
        seq_len, batch, _, rows = S2S_RUNS[name]
        tsv = tsvs[name, "dev"]
        out_k = os.path.join(workdir, "%s_%s_k.tsv" % (name, tag))
        out_p = os.path.join(workdir, "%s_%s_p.tsv" % (name, tag))
        sec_k, batches_k, ids_k = main_path(
            "%s %s predict (f32)" % (name, tag), lambda: _s2s_predict(
                torch, app, ckpt, tsv, out_k, True, seq_len, batch, udp))
        if not all(read()[w] for w in want_kernels):
            raise AssertionError("%s %s predict did not launch %s"
                                 % (name, tag, want_kernels))
        sec_p, batches_p, ids_p = plain("%s %s predict" % (name, tag),
                                        lambda: _s2s_predict(
                                            torch, app, ckpt, tsv, out_p,
                                            False, seq_len, batch, udp))
        same = (ids_k == ids_p).all(axis=1)
        log("%s %s predict, %d rows x %d slots, f32: kernel %.3f s (batch "
            "median %.3f s), plain %.3f s (%.3f s) with load; %d of %d rows "
            "token for token; %d distinct tokens"
            % (name, tag, rows, ids_k.shape[1], sec_k,
               statistics.median(batches_k), sec_p,
               statistics.median(batches_p), int(same.sum()), rows,
               len(set(ids_k[:, 1:].ravel().tolist()))))
        if ids_k.shape != ids_p.shape or ids_k.shape[0] != rows \
                or not same.all():
            raise AssertionError("%s %s predict: kernel and plain f32 "
                                 "generation differ" % (name, tag))

    def training(name, want_per_step, save=True, repeat=False):
        seq_len, batch, steps, _ = S2S_RUNS[name]
        app = "open_domain_dialogue" if name == "dialogue" else \
            "sequence_generation"
        ckpt = os.path.join(workdir, name + "_ckpt") if save else None
        want = {w: n * steps for w, n in want_per_step.items()}
        runs = {True: main_path("%s train (bf16)" % name, lambda: run_train(
            torch, dirs[name], tsvs[name, "train"], None, ckpt, True, seed,
            common=_s2s_argv(app, seq_len, batch, True)), want)}
        runs[False] = plain("%s train" % name, lambda: run_train(
            torch, dirs[name], tsvs[name, "train"], None, None, False, seed,
            common=_s2s_argv(app, seq_len, batch, False)))
        for use_kernel, run in runs.items():
            _check_train_run("%s %s" % (name, use_kernel), run, steps)
        _s2s_compare_training(name, runs)
        if repeat:
            check_repeat(name, runs[True], main_path(
                "%s train again (bf16)" % name, lambda: run_train(
                    torch, dirs[name], tsvs[name, "train"], None, None, True,
                    seed, common=_s2s_argv(app, seq_len, batch, True)),
                want))
        return app, ckpt

    # T5-base: train, evaluate, predict (greedy and 4 beams)
    layers = T5_BASE["num_layers"]
    app, ckpt = training("t5", {"short_attention_fwd": layers,
                                "short_attention_bwd": layers,
                                "flash_attention_fwd": 0,
                                "flash_attention_bwd": 0}, repeat=True)
    seq_len, batch, _, rows = S2S_RUNS["t5"]
    for use_kernel in (True, False):
        run = (lambda: _s2s_evaluate(torch, app, ckpt, tsvs["t5", "dev"],
                                     use_kernel, seq_len, batch))
        results, seconds = (main_path("t5 evaluate (bf16)", run)
                            if use_kernel else plain("t5 evaluate", run))
        scores["t5", use_kernel] = results
        log("t5 evaluate %-6s %d rows: %s in %.3f s"
            % ("kernel" if use_kernel else "plain", rows, ", ".join(
                "%s %.6f" % kv for kv in results), seconds))
    generation("greedy", app, ckpt, "t5", eos_banned,
               ("short_attention_fwd",))
    generation("beam4", app, ckpt, "t5", eos_banned + " num_beams=4",
               ("short_attention_fwd",))
    # mT5-base: predict on its random init (gated FFN, untied f32 head)
    generation("greedy", "sequence_generation", dirs["mt5"], "mt5",
               eos_banned, ("short_attention_fwd",))
    # Pegasus-large (S2S_CUT_LAYERS + S2S_CUT_LAYERS layers): train at 4 x
    # 1024, predict with 4 beams
    layers = S2S_CUT_LAYERS
    # (no checkpoint: its 6.8 GB of weights and AdamW state would take a
    # sixth of the disk writes the card's machine allows the script; the
    # 4-beam predict reads the model directory's init instead)
    app, _ = training("pegasus", {"short_attention_fwd": layers,
                                  "short_attention_bwd": layers,
                                  "flash_attention_fwd": 2 * layers,
                                  "flash_attention_bwd": 2 * layers},
                      save=False)
    generation("beam4", app, dirs["pegasus"], "pegasus",
               eos_banned + " num_beams=4",
               ("short_attention_fwd", "flash_attention_fwd"))
    # Randeng: predict with its WordPiece tokenizer on CJK sources
    generation("greedy", "sequence_generation", dirs["randeng"], "randeng",
               eos_banned, ("short_attention_fwd",))
    # GPT-2 small evaluate on phase 4's dev table (sources the sentences,
    # targets the labels), phase 5's model directory, f32
    gpt2_dir = os.path.join(workdir, GPT2_MODEL_DIR)
    schema = ["--input_schema=id:str:1,sent:str:1,label:str:1",
              "--first_sequence=sent", "--second_sequence=label"]
    for use_kernel in (True, False):
        run = (lambda: _s2s_evaluate(
            torch, "sequence_generation", gpt2_dir,
            os.path.join(workdir, "dev.tsv"), use_kernel, SEQ_LEN, BATCH,
            "float32", schema))
        results, seconds = (main_path("gpt2 evaluate (f32)", run)
                            if use_kernel else plain("gpt2 evaluate", run))
        scores["gpt2", use_kernel] = results
        log("gpt2 evaluate %-6s %d rows: %s in %.3f s"
            % ("kernel" if use_kernel else "plain", N_DEV_ROWS, ", ".join(
                "%s %.6f" % kv for kv in results), seconds))
    if scores["gpt2", True] != scores["gpt2", False]:
        raise AssertionError("GPT-2 f32 evaluate: kernel %s, plain %s"
                             % (scores["gpt2", True], scores["gpt2", False]))
    # open_domain_dialogue: train at 16 x 128 (head dim 32), predict
    layers = DIALOGUE["n_layers"]
    app, ckpt = training("dialogue", {"short_attention_fwd": 3 * layers,
                                      "short_attention_bwd": 3 * layers,
                                      "flash_attention_fwd": 0,
                                      "flash_attention_bwd": 0})
    generation("greedy", app, ckpt, "dialogue", eos_banned,
               ("short_attention_fwd",))
    log("phase 15 launches of the kernel runs: %s" % total)
    total["flash_attention_bwd_dkdv"] = total["flash_attention_bwd"]
    total["flash_attention_bwd_dq"] = total["flash_attention_bwd"]
    return total


# --------------------------------------------------------------------------
# phase 16: speculative decoding, int8 weights and KV cache, GLM
# --------------------------------------------------------------------------

SPEC_DRAFTS, SPEC_NGRAM = 8, 2       # num_draft_tokens, lookup_ngram_size
SPEC_UDP = ("speculative_decoding=prompt_lookup num_draft_tokens=%d "
            "lookup_ngram_size=%d" % (SPEC_DRAFTS, SPEC_NGRAM))
SPEC_DECODER = (SPEC_NGRAM, SPEC_DRAFTS)   # DeviceContinuousDecoder's
SPEC_REQUESTS = 8  # 12 until slice 16
P16_ROWS = GEN_BATCH   # GPT-2 f32 predicts: phase 5's first 8 prompts
BART_SPEC_ROWS = 8
GLM_LARGE = {  # JAX GLMConfig's defaults: glm-large-chinese's widths at
    # 512 positions, dropout set to 0
    "model_type": "glm", "vocab_size": 50048, "hidden_size": 1024,
    "num_layers": 24, "num_attention_heads": 16, "max_sequence_length": 512,
    "embedding_dropout_prob": 0.0, "attention_dropout_prob": 0.0,
    "output_dropout_prob": 0.0,
}
GLM_SP_PIECES = GLM_LARGE["vocab_size"] - 8   # + the 8 command tokens
GLM_SEQ_LEN, GLM_TARGET, GLM_BATCH, GLM_STEPS = 512, 64, 8, 4  # 8 steps
# until slice 17
GLM_SRC_LEN = GLM_SEQ_LEN - GLM_TARGET - 3     # src, gMASK, sop, tgt, eop
GLM_UDP = "enable_glm=true src_len=%d tgt_len=%d" % (GLM_SRC_LEN, GLM_TARGET)
GLM_LM_STEPS, GLM_DEV_ROWS = 4, 16
# GLM runs the first GLM_CUT_LAYERS of glm-large's 24 layers at full
# width: its paths differ from the other decoders' in their attention
# masks and inputs, not in their depth (fine-tuning ran all 24 layers
# until slice 13, whose latent diffusion phase needed the time and the
# disk writes: 131.6 ms a step at 18.4 GiB, PERF.md)
GLM_CUT_LAYERS = 2   # 4 until slice 16
GLM_NEW_TOKENS = 32
# predict's --sequence_length: the prompt, gMASK and sop, the new tokens
# and a verify chunk's K+1 slots fill the 512 keys B1 takes
GLM_PREDICT_SEQ = GLM_SEQ_LEN - GLM_NEW_TOKENS - (SPEC_DRAFTS + 1) - 2


def _launch_counter(A, wrappers):
    """(main_path, plain, total) over the `wrappers`' launch counts:
    main_path(tag, fn, want=None) runs fn() with every count 0 just before
    and read just after, adds them to `total`, and fails unless they equal
    `want` (where given) or some kernel launched (want_any); plain(tag, fn)
    fails if fn() (a --use_flash_attention=false run) launches any."""
    total = dict.fromkeys(wrappers, 0)

    def read():
        return {w: getattr(A, w).launches for w in wrappers}

    def main_path(tag, fn, want=None, want_any=True):
        for w in wrappers:
            getattr(A, w).launches = 0
        out = fn()
        got = read()
        for w in wrappers:
            total[w] += got[w]
        log("%s launches: %s%s" % (tag, got, "" if want is None
                                   else " (want %s)" % want))
        if (want is not None and got != want) or (
                want_any and not any(got.values())):
            raise AssertionError("%s launched %s, want %s" % (tag, got,
                                                              want))
        return out

    def plain(tag, fn):
        before = read()
        out = fn()
        if read() != before:
            raise AssertionError("--use_flash_attention=false %s launched "
                                 "a kernel" % tag)
        return out

    return main_path, plain, total


def _f32_margin(torch, model, prefix):
    """The top-2 logit margin of `model` (f32, plain attention) after the
    token list `prefix`: one forward."""
    from easynlp_tpu_torch.ops import attention as A
    A.set_kernel_override(False)
    try:
        with torch.inference_mode():
            ids = torch.tensor([prefix],
                               device=next(model.parameters()).device)
            top2 = model(ids)["logits"][0, -1].float().topk(2).values
    finally:
        A.set_kernel_override(None)
    return (top2[0] - top2[1]).item()


def _same_or_tie(tag, rows_a, rows_b, margin_at):
    """Rows token for token, but where they part at a near-tie (the f32
    top-2 margin margin_at(row, step) <= SERVE_F32_TIE). Returns (rows
    identical, rows parting at a tie)."""
    same = ties = 0
    for i, (a, b) in enumerate(zip(rows_a, rows_b)):
        j = _first_divergence(list(a), list(b))
        if j is None:
            same += 1
            continue
        m = margin_at(i, j)
        if m > SERVE_F32_TIE:
            raise AssertionError("%s: row %d parts at step %d (%s vs %s) at "
                                 "an f32 top-2 margin of %.3e > %.0e"
                                 % (tag, i, j, list(a[j:j + 2]),
                                    list(b[j:j + 2]), m, SERVE_F32_TIE))
        ties += 1
    return same, ties


def _kl(torch, ref, other):
    """Per-position KL(softmax(ref) || softmax(other)) of f32 logits."""
    lp, lq = torch.log_softmax(ref, -1), torch.log_softmax(other, -1)
    return (lp.exp() * (lp - lq)).sum(-1)


def phase_slice11(torch, seed, workdir):
    """Phase 16: slice 11's paths, each with the kernels (its launches
    counted from 0) and with --use_flash_attention=false: GPT-2 small
    speculative decoding and the int8 KV cache (CLI predict, f32), the
    speculative device decoder, `/generate` with serve_quantize=int8,
    pipeline(quantize="int8") on phase 4's text_classify checkpoint, BART
    speculative predict on phase 6's checkpoint, and GLM (glm-large
    widths, the first GLM_CUT_LAYERS layers) blank-infilling train,
    evaluate and predict (greedy, 4 beams, speculative) and
    block-infilling pretraining. Returns the kernel runs' launches by
    wrapper."""
    import numpy as np
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    from easynlp_tpu_torch.modelzoo import speculative as S
    from easynlp_tpu_torch.modelzoo.models.glm import GLMTokenizer
    from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns)
    from easynlp_tpu_torch.modelzoo.quantization import (
        cast_params, quantization_report, quantize_params)
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.pipelines import pipeline
    from easynlp_tpu_torch.serving.continuous import DeviceContinuousDecoder
    log("== phase 16: speculative decoding, int8 weights and KV cache "
        "(GPT-2 small, BART-base, BERT-base), GLM (glm-large widths)")
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")
    main_path, plain, total = _launch_counter(A, wrappers)
    eos = GPT2_SMALL["eos_token_id"]
    gpt2_dir = os.path.join(workdir, GPT2_MODEL_DIR)   # phase 5's
    # phase 5's first 8 prompts: one batch a predict (16 until slice 12)
    tsv = os.path.join(workdir, "prompts16.tsv")
    with open(os.path.join(workdir, "prompts.tsv"), encoding="utf-8") as f, \
            open(tsv, "w", encoding="utf-8") as g:
        g.writelines(f.readlines()[:P16_ROWS])
    app32 = SequenceGeneration.from_pretrained(gpt2_dir, dtype=torch.float32,
                                               device="cuda")
    width = GEN_PROMPT_WIDTH

    # speculative stats from the CLI runs: every call's verify rounds and
    # accepted drafts
    stats = []
    real_rowwise = S.speculative_greedy_rowwise

    def recorded(*args, **kwargs):
        out = real_rowwise(*args, **kwargs)
        stats.append(out[2])
        return out
    S.speculative_greedy_rowwise = recorded

    def predict(tag, udp, use_kernel):
        out = os.path.join(workdir, "p16_%s_%s.tsv"
                           % (tag, "k" if use_kernel else "p"))
        run = (lambda: run_generate(torch, gpt2_dir, tsv, out, use_kernel,
                                    udp, dtype="float32"))
        return (main_path("GPT-2 %s predict (f32)" % tag, run) if use_kernel
                else plain("GPT-2 %s predict" % tag, run))

    def prefix(ids, i, j):
        """Row i's real prompt tokens (the left pads, id 0, dropped: the
        prompts hold no "!") and its first j generated ones."""
        row = ids[i].tolist()
        start = next(k for k, t in enumerate(row) if t)
        return row[start:width + j]

    try:
        base = "max_decoder_length=%d" % GEN_NEW_TOKENS
        greedy = predict("greedy", base, True)
        spec = predict("speculative", base + " " + SPEC_UDP, True)
        spec_stats = list(stats)
        spec_p = predict("speculative", base + " " + SPEC_UDP, False)
    finally:
        S.speculative_greedy_rowwise = real_rowwise
    gen = [generated_lengths(r["ids"], width, eos) for r in (greedy, spec)]
    rounds = sum(s["verify_rounds"] for s in spec_stats)
    accepted = sum(s["accepted_drafts"] for s in spec_stats)
    committed = sum(s["generated"] for s in spec_stats)
    same, ties = _same_or_tie("speculative vs greedy", spec["ids"][:, width:],
                              greedy["ids"][:, width:],
                              lambda i, j: _f32_margin(
                                  torch, app32.module,
                                  prefix(greedy["ids"], i, j)))
    same_p, ties_p = _same_or_tie("speculative kernel vs plain",
                                  spec["ids"][:, width:],
                                  spec_p["ids"][:, width:],
                                  lambda i, j: 0.0)
    ms_tok = {tag: 1e3 * sum(r["batch_s"]) / sum(lens) for tag, r, lens in
              (("greedy", greedy, gen[0]), ("speculative", spec, gen[1]))}
    log("GPT-2 f32 predict, %d rows x %d new tokens: speculative (K=%d, "
        "n-gram %d, per-row acceptance) %d rows token for token with "
        "greedy, %d part at a near-tie; kernel vs plain %d rows identical; "
        "%d verify forwards of %d rows committed %d tokens (%.3f a forward, "
        "%.3f a row a forward; %d accepted drafts; one read-back a round "
        "plus one a call: %d); ms per output token (batch time / generated "
        "tokens, host clock) greedy %.3f, speculative %.3f (%.2fx)"
        % (P16_ROWS, GEN_NEW_TOKENS, SPEC_DRAFTS, SPEC_NGRAM, same, ties,
           same_p, rounds, GEN_BATCH, committed, committed / max(rounds, 1),
           committed / max(rounds * GEN_BATCH, 1), accepted,
           sum(s["read_backs"] for s in spec_stats), ms_tok["greedy"],
           ms_tok["speculative"], ms_tok["greedy"] / ms_tok["speculative"]))
    if same_p != P16_ROWS:
        raise AssertionError("speculative predict: kernel and plain differ")

    # the int8 KV cache: kernel and plain token for token; token match and
    # mean logit KL against the f32 cache along the f32 greedy tokens
    kv = predict("int8-kv", base + " kv_cache_dtype=int8", True)
    kv_p = predict("int8-kv", base + " kv_cache_dtype=int8", False)
    kv_same, _ = _same_or_tie("int8 KV kernel vs plain",
                              kv["ids"][:, width:], kv_p["ids"][:, width:],
                              lambda i, j: 0.0)
    match = [(_first_divergence(list(a), list(b)) or len(b)) / len(b)
             for a, b in zip(kv["ids"][:, width:], greedy["ids"][:, width:])]
    ids0 = torch.from_numpy(greedy["ids"][:GEN_BATCH]).cuda()
    mask0 = ((ids0[:, :width] != 0).cumsum(-1) > 0).to(torch.int32)
    with torch.inference_mode():
        logits = {}
        for kvc in (None, "int8"):
            prefill, decode = make_gpt2_generation_fns(
                app32.module, width + GEN_NEW_TOKENS, kv_cache=kvc)
            lg, cache = prefill(ids0[:, :width], mask0)
            steps = [lg]
            for j in range(GEN_NEW_TOKENS - 1):
                lg, cache = decode(ids0[:, width + j:width + j + 1], cache)
                steps.append(lg)
            logits[kvc] = torch.stack(steps, 1)
        kls = _kl(torch, logits[None], logits["int8"])
    log("GPT-2 int8 KV cache, f32: kernel vs plain %d of %d rows token for "
        "token; against the f32 cache: token-match rate %.4f (mean share "
        "of each f32 output before the first divergence); mean KL(f32 || "
        "int8 KV) %.6e nats over %d positions (max %.6e), teacher-forced "
        "along the f32 run's tokens, batch 0"
        % (kv_same, P16_ROWS, float(np.mean(match)), kls.mean().item(),
           kls.numel(), kls.max().item()))
    if kv_same != P16_ROWS:
        raise AssertionError("int8 KV predict: kernel and plain differ")
    del logits, kls

    # DeviceContinuousDecoder(speculative=(2, 8)) over 12 requests, f32,
    # against speculative=None; both held to standalone greedy decoding
    A.set_kernel_override(None)   # the plain CLI run above turned it off
    work = serve_workload(seed)[:SPEC_REQUESTS]
    prompts = [p for p, _ in work]
    budgets = [n for _, n in work]
    outs, secs, spec_dec = {}, {}, None
    for name, use_kernel, speculative in (("plain decoder", True, None),
                                          ("speculative", True,
                                           SPEC_DECODER),
                                          ("speculative", False,
                                           SPEC_DECODER)):
        dec = DeviceContinuousDecoder(
            app32.module, max_slots=SERVE_SLOTS, max_length=SERVE_WINDOW,
            prompt_bucket=SERVE_BUCKET, eos_token_id=eos,
            chunk_size=SERVE_CHUNK, speculative=speculative)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec(prompts, max_new_tokens=budgets)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        tag = "device decoder, %s" % name
        if use_kernel:
            outs[name], secs[name] = main_path(tag, run)
        else:
            A.set_kernel_override(False)
            try:
                outs["plain"], secs["plain"] = plain(tag, run)
            finally:
                A.set_kernel_override(None)
        if speculative and use_kernel:
            spec_dec = dict(dec.last_spec_stats)
    want, gaps = _greedy_reference(torch, app32.module, work, 0, "f32")
    checks = {}
    for name in ("plain decoder", "speculative", "plain"):
        checks[name] = _same_or_tie("device decoder %s vs greedy" % name,
                                    outs[name], want,
                                    lambda i, j: gaps[i][j]
                                    if j < len(gaps[i]) else 0.0)
    n_tok = sum(len(o) for o in outs["speculative"])
    log("device decoder, %d requests, %d slots, f32: speculative %s rows "
        "identical to standalone greedy (%d at a near-tie), speculative=None "
        "%s (%d), speculative plain attention %s (%d); speculative and "
        "not: %d of %d identical; %d verify rounds over %d slots "
        "committed %d tokens (%.3f a round, %d read-backs); wall %.3f s "
        "against %.3f s (%.2f ms per output token against %.2f)"
        % (SPEC_REQUESTS, SERVE_SLOTS, checks["speculative"][0],
           checks["speculative"][1], checks["plain decoder"][0],
           checks["plain decoder"][1], checks["plain"][0], checks["plain"][1],
           sum(a == b for a, b in zip(outs["speculative"],
                                      outs["plain decoder"])),
           SPEC_REQUESTS, spec_dec["verify_rounds"], SERVE_SLOTS,
           spec_dec["tokens_committed_in_rounds"],
           spec_dec["tokens_committed_in_rounds"]
           / max(spec_dec["verify_rounds"], 1), spec_dec["read_backs"],
           secs["speculative"], secs["plain decoder"],
           1e3 * secs["speculative"] / n_tok,
           1e3 * secs["plain decoder"] / sum(len(o) for o in
                                            outs["plain decoder"])))

    # /generate with serve_quantize=int8 (bf16 compute, the rest of the
    # weights cast to bf16 as the server does), against f32 and bf16
    # weights on the same SPEC_REQUESTS requests
    load = [{"prompt_ids": p, "max_new_tokens": n} for p, n in work]
    served, tpot, report = {}, {}, None
    for tag, dtype, extra in (("f32", "float32", ""),
                              ("bf16", "bfloat16", ""),
                              ("int8", "bfloat16", "serve_quantize=int8")):
        srv, _ = start_generation_server(torch, gpt2_dir, dtype, True, extra)
        try:
            _drive(srv.port, load[:2], 2)
            srv.timings.clear()
            if tag == "int8":
                report = quantization_report(srv.batcher.model)
                results, wall = main_path("/generate int8", lambda: _drive(
                    srv.port, load, SERVE_CLIENTS))
            else:
                results, wall = _drive(srv.port, load, SERVE_CLIENTS)
            timings = list(srv.timings)
        finally:
            srv.stop()
        describe_serving(tag, results, wall, timings)
        served[tag] = [r["ids"] for r in results]
        tpot[tag] = _pct([1e3 * (b - a) / (k - 1) for a, b, k in timings
                          if k > 1], 50)
    app8 = SequenceGeneration.from_pretrained(gpt2_dir, dtype=torch.bfloat16,
                                              device="cuda")
    quantize_params(app8.module)
    cast_params(app8.module, torch.bfloat16)   # as the server does
    lg32 = _teacher_forced_logits(torch, app32.module, prompts,
                                  served["f32"], 0)
    lg8 = _teacher_forced_logits(torch, app8.module, prompts,
                                 served["f32"], 0)
    kl = torch.cat([_kl(torch, a, b) for a, b in zip(lg32, lg8)])
    match = [(_first_divergence(a, b) or len(b)) / len(b)
             for a, b in zip(served["int8"], served["f32"])]
    log("int8 serving weights (serve_quantize=int8, bf16 compute) vs f32 "
        "(C5; printed, not gated): token-match rate %.4f; mean KL(f32 || "
        "int8) of the next-token distribution %.6e nats over %d positions "
        "(max %.6e); quantization_report: %d bytes against %d (%.3fx), %d "
        "int8 weights; decode ms per output token p50 (server timings): "
        "int8 %.3f, bf16 %.3f, f32 %.3f"
        % (float(np.mean(match)), kl.mean().item(), kl.numel(),
           kl.max().item(), report[0], report[1], report[0] / report[1],
           report[2], tpot["int8"], tpot["bf16"], tpot["f32"]))
    del app8, lg32, lg8, kl
    torch.cuda.empty_cache()

    # pipeline(quantize="int8") on phase 4's text_classify checkpoint
    ckpt = os.path.join(workdir, "ckpt_kernel")
    with open(os.path.join(workdir, "train.tsv"), encoding="utf-8") as f:
        texts = [line.rstrip("\n").split("\t")[1] for line in f]
    A.set_kernel_override(None)
    kw = dict(first_sequence="sentence", sequence_length=SEQ_LEN,
              batch_size=BATCH, dtype=torch.float32, device="cuda")
    rows = {"f32": pipeline(ckpt, **kw)(texts)}
    rows["int8"] = main_path("pipeline int8 (f32)", lambda: pipeline(
        ckpt, quantize="int8", **kw)(texts))
    lg = {k: np.array([[float(x) for x in r["logits"].split()] for r in v])
          for k, v in rows.items()}
    agree = np.mean(lg["f32"].argmax(1) == lg["int8"].argmax(1))
    log("pipeline(quantize=\"int8\"), BERT-base text_classify, %d rows, "
        "f32: argmax agreement with f32 weights %.4f, largest logit gap "
        "%.4e" % (len(texts), agree, np.abs(lg["f32"] - lg["int8"]).max()))
    del app32
    torch.cuda.empty_cache()

    # BART-base f32 predict of 8 rows, speculative against greedy
    bart_tsv = os.path.join(workdir, "bart_spec.tsv")
    with open(os.path.join(workdir, "bart_dev.tsv"), encoding="utf-8") as f:
        lines = f.readlines()[:BART_SPEC_ROWS]
    with open(bart_tsv, "w", encoding="utf-8") as f:
        f.writelines(lines)
    bart_ckpt = os.path.join(workdir, "bart_ckpt")
    bart = {}
    for tag, udp, use_kernel in (
            ("greedy", BART_PREDICT_UDP["greedy"], True),
            ("speculative", BART_PREDICT_UDP["greedy"] + " " + SPEC_UDP,
             True),
            ("speculative", BART_PREDICT_UDP["greedy"] + " " + SPEC_UDP,
             False)):
        out = os.path.join(workdir, "bart_%s_%d.tsv" % (tag, use_kernel))
        argv = ["--mode=predict", "--tables=" + bart_tsv, "--outputs=" + out,
                "--checkpoint_dir=" + bart_ckpt,
                "--output_schema=predictions,generated_ids",
                "--append_cols=id", "--user_defined_parameters=" + udp] + [
                    a.replace("bfloat16", "float32")
                    for a in _bart_argv(use_kernel)]

        def run():
            manager, seconds = _cli(torch, argv)
            with open(out, encoding="utf-8") as f:
                return [[int(x) for x in line.split("\t")[1].split()]
                        for line in f], seconds
        bart[tag, use_kernel] = (main_path("BART %s predict (f32)" % tag, run)
                                 if use_kernel else
                                 plain("BART %s predict" % tag, run))
    b_same = sum(a == b for a, b in zip(bart["speculative", True][0],
                                        bart["greedy", True][0]))
    b_plain = sum(a == b for a, b in zip(bart["speculative", True][0],
                                         bart["speculative", False][0]))
    log("BART-base f32 predict, %d rows x %d slots: speculative %d rows "
        "token for token with greedy, %d with its plain run; %.3f s against "
        "greedy's %.3f s with load"
        % (BART_SPEC_ROWS, len(bart["greedy", True][0][0]), b_same, b_plain,
           bart["speculative", True][1], bart["greedy", True][1]))
    if b_same != BART_SPEC_ROWS or b_plain != BART_SPEC_ROWS:
        raise AssertionError("BART speculative predict differs from greedy "
                             "or from its plain run")

    # GLM at glm-large widths: the model dir (the port's init from --seed,
    # a synthetic SentencePiece model of ~50000 pieces), tables
    rng = random.Random(seed + 16)
    t0 = time.perf_counter()
    glm_dir = os.path.join(workdir, "glm-large-random")
    n_params = make_s2s_model_dir(
        torch, glm_dir, dict(GLM_LARGE, num_layers=GLM_CUT_LAYERS), seed,
        {"spiece.model": sp_model_bytes(t5_sp_pieces(rng, GLM_SP_PIECES))})
    tok = GLMTokenizer.from_pretrained(glm_dir)
    if tok.vocab_size != GLM_LARGE["vocab_size"]:
        raise AssertionError("the GLM tokenizer holds %d ids, want %d"
                             % (tok.vocab_size, GLM_LARGE["vocab_size"]))
    words = ["".join(rng.choice(GEN_LETTERS) for _ in range(rng.randint(
        2, 9))) for _ in range(3000)]
    glm_tsv = {}
    for kind, n in (("train", GLM_BATCH * GLM_STEPS), ("dev", GLM_DEV_ROWS)):
        glm_tsv[kind] = os.path.join(workdir, "glm_%s.tsv" % kind)
        make_s2s_tsv(glm_tsv[kind], tok.tokenize, words, rng, n,
                     GLM_SEQ_LEN)
    for kind, n in (("lm_train", GLM_BATCH * GLM_LM_STEPS),
                    ("lm_dev", GLM_DEV_ROWS)):
        glm_tsv[kind] = os.path.join(workdir, "glm_%s.tsv" % kind)
        with open(glm_tsv[kind], "w", encoding="utf-8") as f, \
                open(glm_tsv["train"], encoding="utf-8") as g:
            for i, line in zip(range(n), g):
                f.write("%d\t%s\n" % (i, line.split("\t")[1]))
    log("GLM model dir (%d parameters, %d SentencePiece pieces + 8 command "
        "tokens: gMASK %d, sop %d, eop %d) and tables made from seed %d in "
        "%.3f s" % (n_params, GLM_SP_PIECES, tok.gmask_token_id,
                    tok.sop_token_id, tok.eop_token_id, seed,
                    time.perf_counter() - t0))
    layers = GLM_CUT_LAYERS

    def glm_argv(app, use_kernel, dtype="bfloat16", udp=GLM_UDP,
                 seq_len=GLM_SEQ_LEN):
        lm = app == "language_modeling"
        argv = ["--app_name=" + app, "--device=cuda", "--dtype=" + dtype,
                "--sequence_length=%d" % seq_len,
                "--micro_batch_size=%d" % GLM_BATCH,
                "--input_schema=" + ("id:str:1,text:str:1" if lm else
                                     "id:str:1,src:str:1,tgt:str:1"),
                "--first_sequence=" + ("text" if lm else "src"),
                "--use_flash_attention=%s" % ("auto" if use_kernel
                                              else "false"),
                "--user_defined_parameters=" + udp]
        return argv if lm else argv + ["--second_sequence=tgt"]

    zero = dict.fromkeys(wrappers, 0)
    glm_ckpt = os.path.join(workdir, "glm_ckpt")
    # GLM's training (and its LM evaluate) launch no kernel: the
    # block-infilling bias takes the plain path, so each runs once (a
    # --use_flash_attention=false twin until slice 14 gave the same bits)
    run = main_path("GLM sequence_generation train (bf16)", lambda: run_train(
        torch, glm_dir, glm_tsv["train"], None, glm_ckpt, True, seed,
        common=glm_argv("sequence_generation", True)), zero, want_any=False)
    _check_train_run("GLM", run, GLM_STEPS)
    describe_train("GLM", run, GLM_BATCH)
    for use_kernel in (True, False):
        argv = ["--mode=evaluate", "--tables=" + glm_tsv["dev"],
                "--checkpoint_dir=" + glm_ckpt] + glm_argv(
                    "sequence_generation", use_kernel)
        run = (lambda: _cli(torch, argv))
        results, seconds = (main_path("GLM evaluate (bf16)", run)
                            if use_kernel else plain("GLM evaluate", run))
        log("GLM evaluate %-6s %d rows (%d new tokens, bf16): %s in %.3f s"
            % ("kernel" if use_kernel else "plain", GLM_DEV_ROWS, 64,
               ", ".join("%s %.6f" % kv for kv in results), seconds))
    glm_out = {}
    for tag, udp in (("greedy", ""), ("beam4", " num_beams=4"),
                     ("speculative", " " + SPEC_UDP)):
        for use_kernel in (True, False):
            out = os.path.join(workdir, "glm_%s_%d.tsv" % (tag, use_kernel))
            argv = ["--mode=predict", "--tables=" + glm_tsv["dev"],
                    "--outputs=" + out, "--checkpoint_dir=" + glm_ckpt,
                    "--output_schema=predictions,generated_ids",
                    "--append_cols=id"] + glm_argv(
                        "sequence_generation", use_kernel, "float32",
                        GLM_UDP + " max_decoder_length=%d" % GLM_NEW_TOKENS
                        + udp, GLM_PREDICT_SEQ)

            def run():
                manager, seconds = _cli(torch, argv)
                with open(out, encoding="utf-8") as f:
                    return ([[int(x) for x in line.split("\t")[1].split()]
                             for line in f], seconds,
                            list(manager.predictor.batch_seconds))
            glm_out[tag, use_kernel] = (
                main_path("GLM %s predict (f32)" % tag, run) if use_kernel
                else plain("GLM %s predict" % tag, run))
        a, b = glm_out[tag, True][0], glm_out[tag, False][0]
        same = sum(x == y for x, y in zip(a, b))
        log("GLM %s predict, %d rows x %d new tokens, f32: kernel %.3f s "
            "(batch median %.3f s), plain %.3f s (%.3f s) with load; %d of "
            "%d rows token for token; %d distinct tokens"
            % (tag, len(a), GLM_NEW_TOKENS, glm_out[tag, True][1],
               statistics.median(glm_out[tag, True][2]),
               glm_out[tag, False][1],
               statistics.median(glm_out[tag, False][2]), same, len(a),
               len({t for row in a for t in row})))
        if same != len(a) or len(a) != GLM_DEV_ROWS:
            raise AssertionError("GLM %s predict: kernel and plain f32 "
                                 "generation differ" % tag)
    if glm_out["speculative", True][0] != glm_out["greedy", True][0]:
        raise AssertionError("GLM speculative predict differs from greedy")
    log("GLM speculative predict equals greedy row for row; ms per output "
        "token (batch time / rows x new tokens) greedy %.3f, speculative "
        "%.3f" % tuple(1e3 * sum(glm_out[t, True][2])
                       / (GLM_DEV_ROWS * GLM_NEW_TOKENS)
                       for t in ("greedy", "speculative")))
    lm_ckpt = os.path.join(workdir, "glm_lm_ckpt")
    run = main_path("GLM language_modeling train (bf16)", lambda: run_train(
        torch, glm_dir, glm_tsv["lm_train"], None, lm_ckpt, True, seed,
        common=glm_argv("language_modeling", True, udp="enable_glm=true")),
        zero, want_any=False)
    _check_train_run("GLM LM", run, GLM_LM_STEPS)
    describe_train("GLM LM", run, GLM_BATCH)
    results, seconds = main_path("GLM LM evaluate (bf16)", lambda: _cli(
        torch, ["--mode=evaluate", "--tables=" + glm_tsv["lm_dev"],
                "--checkpoint_dir=" + lm_ckpt] + glm_argv(
                    "language_modeling", True, udp="enable_glm=true")),
        zero, want_any=False)
    log("GLM LM evaluate %d rows: %s in %.3f s" % (
        GLM_DEV_ROWS, ", ".join("%s %.6f" % kv for kv in results), seconds))
    if [m for m, _ in results] != ["accuracy", "perplexity"] or \
            not np.isfinite([v for _, v in results]).all():
        raise AssertionError("GLM LM evaluate gave %s" % results)
    log("GLM training launches no attention kernel a step (B1 0, B3 0: the "
        "block-infilling bias takes the plain path, in JAX too); its "
        "decode steps and verify chunks take B1 (%d layers a step)" % layers)
    log("phase 16 launches of the kernel runs: %s" % total)
    total["flash_attention_bwd_dkdv"] = total["flash_attention_bwd"]
    total["flash_attention_bwd_dq"] = total["flash_attention_bwd"]
    return total


# --------------------------------------------------------------------------
# phase 17: CLIP retrieval and ViT captioning
# --------------------------------------------------------------------------

CLIP_VISION = {  # OFA-Sys/chinese-clip-vit-base-patch16 config.json's
    "image_size": 224, "patch_size": 16, "hidden_size": 768,
    "num_hidden_layers": 12, "num_attention_heads": 12,
    "intermediate_size": 3072, "hidden_act": "quick_gelu",
    "layer_norm_eps": 1e-5, "initializer_range": 0.02,
}
CHINESE_CLIP_B16 = {  # its text tower (RoBERTa-wwm-base as BERT), dropout 0
    "model_type": "clip", "projection_dim": 512,
    "logit_scale_init_value": 2.6592, "vision_config": CLIP_VISION,
    "text_config": dict(BERT_BASE_CHINESE, num_hidden_layers=12,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0),
}
I2T_B16 = {  # the captioner: that ViT and GPT-2 small's widths over the
    # same 21128-token BERT vocabulary, dropout 0
    "model_type": "clip_gpt_i2t", "vision_config": CLIP_VISION,
    "gpt_config": dict(GPT2_SMALL, vocab_size=21128, resid_pdrop=0.0,
                       embd_pdrop=0.0, attn_pdrop=0.0),
}
CLIP_DIR, I2T_DIR, WUKONG_DIR = ("chinese-clip-b16-random",
                                 "clip-gpt-i2t-b16-random",
                                 "wukong-b16-random")
CLIP_TEXT_LEN = 32          # --sequence_length of the captions
CLIP_BATCH, CLIP_STEPS, CLIP_DEV_ROWS = 32, 2, 32  # 4 steps, 64 rows
# until slice 17
VIDEOS, VIDEO_FRAMES = 8, 12
I2T_BATCH, I2T_STEPS, I2T_PRED_ROWS, I2T_TEXT_LEN = 16, 4, 16, 32
V2T_FRAMES = 3
# bf16 training, kernel run against plain run, every step: the losses of
# phase 15's seq2seq runs (S2S_LOSS_ATOL; bf16 rounding through 12 + 12
# layers) and the same relative grad-norm bound
CLIP_LOSS_ATOL = S2S_LOSS_ATOL
CLIP_GNORM_RTOL = S2S_GNORM_RTOL
# f32 embeddings, kernel against plain: the CUDA-core kernels hold each
# attention to 2e-5; 12 layers of that on unit-normalised 512-wide
# embeddings stay well inside 1e-4
CLIP_EMBED_F32_ATOL = 1e-4


def _png_b64(rng, size, urlsafe=False):
    """A smooth random RGB image (an 8 x 8 colour grid upsampled, with
    noise) of `size` (w, h) as base64 PNG."""
    import base64
    import io as _io

    import numpy as np
    from PIL import Image
    w, h = size
    grid = rng.randint(0, 256, (8, 8, 3)).astype(np.float32)
    img = np.repeat(np.repeat(grid, -(-h // 8), 0), -(-w // 8), 1)[:h, :w]
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255)
    buf = _io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, format="PNG")
    enc = base64.urlsafe_b64encode if urlsafe else base64.b64encode
    return enc(buf.getvalue()).decode()


def make_clip_rows(workdir, cjk, seed):
    """The phase's tables from the seed: CLIP rows (caption, base64 PNG)
    for training and evaluation, videos (caption, a JSON list of 12
    url-safe PNG frames), captioning rows (url-safe PNG, caption) and
    3-frame lists. Images are 224-320 pixels a side, so the resize and the
    centre crop both act."""
    import numpy as np
    rng = np.random.RandomState(seed + 17)
    common = cjk[:3000]

    def caption():
        return "".join(rng.choice(common, rng.randint(8, 40)))

    def size():
        return int(rng.randint(224, 321)), int(rng.randint(224, 321))
    paths = {}
    for name, n in (("clip_train", CLIP_BATCH * CLIP_STEPS),
                    ("clip_dev", CLIP_DEV_ROWS)):
        paths[name] = os.path.join(workdir, name + ".tsv")
        with open(paths[name], "w", encoding="utf-8") as f:
            for _ in range(n):
                f.write("%s\t%s\n" % (caption(), _png_b64(rng, size())))
    frames = [_png_b64(rng, size(), urlsafe=True)
              for _ in range(VIDEO_FRAMES * 3)]
    paths["video"] = os.path.join(workdir, "video.tsv")
    with open(paths["video"], "w", encoding="utf-8") as f:
        for i in range(VIDEOS):
            n = VIDEO_FRAMES - 4 * (i % 2)  # half the videos 8 frames
            start = rng.randint(0, len(frames) - n)
            f.write("%s\t%s\n" % (caption(),
                                  json.dumps(frames[start:start + n])))
    for name, n in (("i2t_train", I2T_BATCH * I2T_STEPS),
                    ("i2t_dev", I2T_PRED_ROWS)):
        paths[name] = os.path.join(workdir, name + ".tsv")
        with open(paths[name], "w", encoding="utf-8") as f:
            for _ in range(n):
                f.write("%s\t%s\n" % (_png_b64(rng, size(), urlsafe=True),
                                      caption()))
    paths["v2t"] = os.path.join(workdir, "v2t.tsv")
    with open(paths["v2t"], "w", encoding="utf-8") as f:
        for i in range(I2T_PRED_ROWS // 2):
            start = rng.randint(0, len(frames) - V2T_FRAMES)
            f.write("%s\t%s\n" % (json.dumps(
                frames[start:start + V2T_FRAMES - i % 2]), caption()))
    return paths


def make_multimodal_dir(torch, path, config, vocab_path, seed):
    """config.json, vocab.txt and the port's init of the config's module
    from `seed` on the card, under its HF names, as pytorch_model.bin.
    Returns the parameter count."""
    import shutil
    from easynlp_tpu_torch.appzoo.image2text_generation.model import (
        CLIPGPTImageTextModule, I2TConfig)
    from easynlp_tpu_torch.modelzoo.models.clip import CLIPConfig, CLIPModel
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    shutil.copy(vocab_path, os.path.join(path, "vocab.txt"))
    if config["model_type"] == "clip":
        module = CLIPModel(CLIPConfig.from_pretrained(path), device="cuda")
    else:
        module = CLIPGPTImageTextModule(I2TConfig.from_pretrained(path),
                                        device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    torch.save(module.state_dict(), os.path.join(path, "pytorch_model.bin"))
    n = sum(p.numel() for p in module.parameters())
    del module
    torch.cuda.empty_cache()
    return n


def wukong_state_dict(state, layers):
    """A CLIPModel state dict (HF names) under the Wukong/OpenAI names:
    `visual.*` (conv1, class_embedding, positional_embedding, ln_pre, the
    resblocks with fused in_proj, ln_post, proj applied as x @ proj),
    `bert.*`, `text_projection` applied as x @ W and `logit_scale`: the
    inverse of modelzoo/models/clip/conversion.py::from_wukong."""
    import torch
    vm = "vision_model."
    out = {"visual.conv1.weight": state[vm + "embeddings.patch_embedding"
                                        ".weight"],
           "visual.class_embedding": state[vm + "embeddings.class_embedding"],
           "visual.positional_embedding":
               state[vm + "embeddings.position_embedding.weight"],
           "visual.proj": state["visual_projection.weight"].t().contiguous(),
           "text_projection": state["text_projection.weight"].t()
           .contiguous(),
           "logit_scale": state["logit_scale"]}
    for ours, theirs in (("pre_layrnorm", "ln_pre"),
                         ("post_layernorm", "ln_post")):
        for p in ("weight", "bias"):
            out["visual.%s.%s" % (theirs, p)] = state[vm + "%s.%s"
                                                      % (ours, p)]
    for i in range(layers):
        b = vm + "encoder.layers.%d." % i
        rb = "visual.transformer.resblocks.%d." % i
        for p in ("weight", "bias"):
            out[rb + "attn.in_proj_" + p] = torch.cat(
                [state[b + "self_attn.%s_proj.%s" % (n, p)] for n in "qkv"])
            for ours, theirs in (("self_attn.out_proj", "attn.out_proj"),
                                 ("layer_norm1", "ln_1"),
                                 ("layer_norm2", "ln_2"),
                                 ("mlp.fc1", "mlp.c_fc"),
                                 ("mlp.fc2", "mlp.c_proj")):
                out[rb + theirs + "." + p] = state[b + ours + "." + p]
    out.update({"bert." + k[len("text_model."):]: v for k, v in state.items()
                if k.startswith("text_model.")})
    return out


def _clip_argv(app, use_kernel, dtype="bfloat16", second="image",
               udp="", batch=CLIP_BATCH):
    return ["--app_name=" + app, "--device=cuda", "--dtype=" + dtype,
            "--sequence_length=%d" % CLIP_TEXT_LEN,
            "--micro_batch_size=%d" % batch,
            "--input_schema=text:str:1,%s:str:1" % second,
            "--first_sequence=text", "--second_sequence=" + second,
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false"),
            "--user_defined_parameters=image_size=%d %s"
            % (CLIP_VISION["image_size"], udp)]


def _i2t_argv(app, use_kernel, dtype="bfloat16", udp="", batch=I2T_BATCH):
    return ["--app_name=" + app, "--device=cuda", "--dtype=" + dtype,
            "--sequence_length=%d" % I2T_TEXT_LEN,
            "--micro_batch_size=%d" % batch,
            "--input_schema=image:str:1,text:str:1",
            "--first_sequence=image", "--second_sequence=text",
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false"),
            "--user_defined_parameters=img_size=%d frame_num=%d %s"
            % (CLIP_VISION["image_size"], V2T_FRAMES, udp)]


def _read_embeddings(path, cols):
    """{column: [N, P] float64} from a predict TSV whose first len(cols)
    columns are "%.8f" rows."""
    import numpy as np
    with open(path, encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    return {c: np.array([[float(x) for x in r[i].split()] for r in rows])
            for i, c in enumerate(cols)}


def _recalls_decided(sim, err):
    """Whether every rank the recalls count is decided by more than 2 x
    err of similarity (so kernel and plain must give the same recalls)."""
    import numpy as np
    gap = np.abs(sim - np.diag(sim)[:, None])
    np.fill_diagonal(gap, np.inf)
    return float(gap.min()) > 2 * err


def phase_multimodal(torch, seed, workdir, cjk):
    """Phase 17: CLIP retrieval and ViT captioning at Chinese-CLIP
    ViT-B/16 widths, each path with the kernels (launches counted from 0)
    and with --use_flash_attention=false. clip: 4 bf16 AdamW steps of 32 x
    (224 x 224, 32 tokens) (every step's loss and grad norm held to the
    plain run's), f32 evaluate (recall@1/5/10) and predict (embeddings);
    wukong_clip predict from the trained weights under the Wukong names
    (equal to clip's); text2video_retrieval f32 evaluate and predict on 8
    videos of 8-12 frames; image2text_generation 4 bf16 steps of 16 x (197
    + 32) (no checkpoint), f32 predict greedy and 4 beams (token for
    token) and pipeline() on the captioner's directory;
    video2text_generation f32 predict on 3 frames. Returns
    the kernel runs' launches by wrapper."""
    import shutil

    import numpy as np
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.pipelines import pipeline
    log("== phase 17: CLIP retrieval (clip, wukong_clip, "
        "text2video_retrieval) and ViT captioning (image2text_generation, "
        "video2text_generation), Chinese-CLIP ViT-B/16 widths")
    t_phase = time.perf_counter()
    import PIL
    log("image decoding: PIL %s" % PIL.__version__)
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")
    main_path, plain, total = _launch_counter(A, wrappers)
    vit_layers = CLIP_VISION["num_hidden_layers"]
    text_layers = CHINESE_CLIP_B16["text_config"]["num_hidden_layers"]
    gpt_layers = I2T_B16["gpt_config"]["n_layer"]
    t0 = time.perf_counter()
    paths = make_clip_rows(workdir, cjk, seed)
    vocab = os.path.join(workdir, MODEL_DIR, "vocab.txt")  # phase 3's
    clip_dir = os.path.join(workdir, CLIP_DIR)
    i2t_dir = os.path.join(workdir, I2T_DIR)
    n_clip = make_multimodal_dir(torch, clip_dir, CHINESE_CLIP_B16, vocab,
                                 seed)
    n_i2t = make_multimodal_dir(torch, i2t_dir, I2T_B16, vocab, seed)
    log("CLIP (%d parameters) and captioner (%d) directories, %d + %d CLIP "
        "rows, %d videos, %d + %d captioning rows made from seed %d in "
        "%.3f s" % (n_clip, n_i2t, CLIP_BATCH * CLIP_STEPS, CLIP_DEV_ROWS,
                    VIDEOS, I2T_BATCH * I2T_STEPS, I2T_PRED_ROWS, seed,
                    time.perf_counter() - t0))

    def training(tag, model_dir, table, ckpt, argv, steps, per_step):
        runs = {True: main_path(tag + " train (bf16)", lambda: run_train(
            torch, model_dir, table, None, ckpt, True, seed,
            common=argv(True)), {"short_attention_fwd": per_step * steps,
                                 "short_attention_bwd": per_step * steps,
                                 "flash_attention_fwd": 0,
                                 "flash_attention_bwd": 0})}
        runs[False] = plain(tag + " train", lambda: run_train(
            torch, model_dir, table, None, None, False, seed,
            common=argv(False)))
        for use_kernel, run in runs.items():
            _check_train_run("%s %s" % (tag, use_kernel), run, steps)
        rec_k, rec_p = runs[True]["records"], runs[False]["records"]
        d_loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(rec_k,
                                                                rec_p))
        d_gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                      for a, b in zip(rec_k, rec_p))
        for use_kernel, run in runs.items():
            ms = [1e3 * r["seconds"] for r in run["records"]]
            log("%s train %-6s %d steps: step ms median %.3f (steps 2-%d; "
                "first %.3f), peak device memory %.3f GiB above the run's "
                "start, run %.3f s with load and save; losses %s; grad "
                "norms %s; launches a step: B1 %d, B2 %d"
                % (tag, "kernel" if use_kernel else "plain", len(ms),
                   statistics.median(ms[1:]), len(ms), ms[0],
                   run["peak_gib"], run["total_s"],
                   " ".join("%.5f" % r["loss"] for r in run["records"]),
                   " ".join("%.4f" % r["grad_norm"] for r in run["records"]),
                   per_step if use_kernel else 0,
                   per_step if use_kernel else 0))
        log("%s kernel vs plain training: max |d loss| per step %.3e "
            "(bound %.1e), max relative grad-norm gap %.3e (bound %.1e)"
            % (tag, d_loss, CLIP_LOSS_ATOL, d_gnorm, CLIP_GNORM_RTOL))
        if d_loss > CLIP_LOSS_ATOL or d_gnorm > CLIP_GNORM_RTOL:
            raise AssertionError("%s: kernel and plain training disagree "
                                 "(loss %.3e, grad norm %.3e)"
                                 % (tag, d_loss, d_gnorm))
        return runs

    def cli(tag, argv, use_kernel, want=None):
        run = (lambda: _cli(torch, argv))
        if use_kernel:
            return main_path(tag, run, want)
        return plain(tag, run)

    # -- clip: train, evaluate, predict; wukong_clip predict ---------------
    seconds = {}
    t0 = time.perf_counter()
    clip_ckpt = os.path.join(workdir, "clip_ckpt")
    training("clip", clip_dir, paths["clip_train"], clip_ckpt,
             lambda k: _clip_argv("clip", k), CLIP_STEPS,
             vit_layers + text_layers)
    embeds = {}
    for use_kernel in (True, False):
        tag = "kernel" if use_kernel else "plain"
        out = os.path.join(workdir, "clip_pred_%s.tsv" % tag)
        argv = ["--mode=predict", "--tables=" + paths["clip_dev"],
                "--outputs=" + out, "--checkpoint_dir=" + clip_ckpt,
                "--output_schema=text_embeds,image_embeds",
                "--append_cols=text"] + _clip_argv("clip", use_kernel,
                                                   "float32")
        manager, sec = cli("clip predict (f32)", argv, use_kernel,
                           {"short_attention_fwd": -(-CLIP_DEV_ROWS
                                                     // CLIP_BATCH)
                            * (vit_layers + text_layers),
                            "short_attention_bwd": 0,
                            "flash_attention_fwd": 0,
                            "flash_attention_bwd": 0})
        embeds[use_kernel] = _read_embeddings(out, ("text", "image"))
        log("clip predict %-6s %d rows (f32): %.3f s with load; batch "
            "latency median %.3f ms" % (
                tag, manager.n_rows, sec,
                1e3 * statistics.median(manager.predictor.model_predictor
                                        .batch_seconds)))
    d_emb = max(float(np.abs(embeds[True][c] - embeds[False][c]).max())
                for c in ("text", "image"))
    norms = np.linalg.norm(embeds[True]["image"], axis=1)
    log("clip f32 embeddings, kernel vs plain: max |d| %.3e (bound %.1e); "
        "image embedding norms %.6f-%.6f" % (d_emb, CLIP_EMBED_F32_ATOL,
                                             norms.min(), norms.max()))
    if d_emb > CLIP_EMBED_F32_ATOL or abs(norms - 1).max() > 1e-5:
        raise AssertionError("clip f32 embeddings: kernel and plain differ "
                             "by %.3e" % d_emb)
    recalls = {}
    for use_kernel in (True, False):
        argv = ["--mode=evaluate", "--tables=" + paths["clip_dev"],
                "--checkpoint_dir=" + clip_ckpt] + _clip_argv(
                    "clip", use_kernel, "float32")
        recalls[use_kernel], sec = cli("clip evaluate (f32)", argv,
                                       use_kernel)
        log("clip evaluate %-6s %d rows: %s in %.3f s" % (
            "kernel" if use_kernel else "plain", CLIP_DEV_ROWS,
            ", ".join("%s %.6f" % kv for kv in recalls[use_kernel]), sec))
    sim = embeds[False]["text"] @ embeds[False]["image"].T
    decided = _recalls_decided(sim, d_emb)
    if recalls[True] != recalls[False] and decided:
        raise AssertionError("clip evaluate: kernel recalls %s, plain %s, "
                             "though every rank is decided"
                             % (recalls[True], recalls[False]))
    log("clip recalls kernel %s plain (every rank decided by > 2 x the "
        "embedding error: %s)" % ("==" if recalls[True] == recalls[False]
                                  else "!=", decided))
    # wukong_clip: the trained weights under the Wukong/OpenAI names
    wukong_dir = os.path.join(workdir, WUKONG_DIR)
    os.makedirs(wukong_dir)
    for name in ("config.json", "vocab.txt"):
        shutil.copy(os.path.join(clip_ckpt, name), wukong_dir)
    state = torch.load(os.path.join(clip_ckpt, "pytorch_model.bin"),
                       weights_only=True)
    torch.save(wukong_state_dict(state, vit_layers),
               os.path.join(wukong_dir, "pytorch_model.bin"))
    del state
    out = os.path.join(workdir, "wukong_pred.tsv")
    cli("wukong_clip predict (f32)", [
        "--mode=predict", "--tables=" + paths["clip_dev"], "--outputs=" + out,
        "--checkpoint_dir=" + wukong_dir,
        "--output_schema=text_embeds,image_embeds", "--append_cols=text"]
        + _clip_argv("wukong_clip", True, "float32"), True)
    with open(out, encoding="utf-8") as f, open(os.path.join(
            workdir, "clip_pred_kernel.tsv"), encoding="utf-8") as g:
        same = f.read() == g.read()
    log("wukong_clip predict from the Wukong-named weights: %s clip's "
        "%d rows" % ("equal to" if same else "DIFFERENT from",
                     CLIP_DEV_ROWS))
    if not same:
        raise AssertionError("wukong_clip's embeddings differ from clip's")
    seconds["clip"] = time.perf_counter() - t0

    # -- text2video_retrieval: evaluate and predict ------------------------
    t0 = time.perf_counter()
    video = {}
    for use_kernel in (True, False):
        tag = "kernel" if use_kernel else "plain"
        udp = "max_frames=%d" % VIDEO_FRAMES
        argv = ["--mode=evaluate", "--tables=" + paths["video"],
                "--checkpoint_dir=" + clip_ckpt] + _clip_argv(
                    "text2video_retrieval", use_kernel, "float32", "video",
                    udp, VIDEOS)
        results, sec = cli("text2video evaluate (f32)", argv, use_kernel, {
            "short_attention_fwd": vit_layers + text_layers,
            "short_attention_bwd": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd": 0})
        out = os.path.join(workdir, "video_pred_%s.tsv" % tag)
        argv = ["--mode=predict", "--tables=" + paths["video"],
                "--outputs=" + out, "--checkpoint_dir=" + clip_ckpt,
                "--output_schema=text_embeds,video_embeds",
                "--append_cols=text"] + _clip_argv(
                    "text2video_retrieval", use_kernel, "float32", "video",
                    udp, VIDEOS)
        _, psec = cli("text2video predict (f32)", argv, use_kernel)
        video[use_kernel] = (results, _read_embeddings(out, ("text",
                                                             "video")))
        log("text2video %-6s %d videos of 8-%d frames: evaluate %s in %.3f "
            "s, predict %.3f s" % (tag, VIDEOS, VIDEO_FRAMES, ", ".join(
                "%s %.4f" % kv for kv in results), sec, psec))
    d_vid = max(float(np.abs(video[True][1][c] - video[False][1][c]).max())
                for c in ("text", "video"))
    vsim = video[False][1]["text"] @ video[False][1]["video"].T
    log("text2video f32 embeddings, kernel vs plain: max |d| %.3e (bound "
        "%.1e); recalls %s (decided %s)" % (
            d_vid, CLIP_EMBED_F32_ATOL,
            "equal" if video[True][0] == video[False][0] else "differ",
            _recalls_decided(vsim, d_vid)))
    if d_vid > CLIP_EMBED_F32_ATOL or (video[True][0] != video[False][0]
                                       and _recalls_decided(vsim, d_vid)):
        raise AssertionError("text2video: kernel and plain disagree")
    seconds["text2video"] = time.perf_counter() - t0

    # -- image2text_generation: train, predict, pipeline() -----------------
    t0 = time.perf_counter()
    # the training writes no checkpoint (2.2 GB with AdamW's state): the
    # predicts read the captioner's directory, the port's init (they read
    # the trained checkpoint until slice 14)
    i2t_ckpt = i2t_dir
    training("image2text", i2t_dir, paths["i2t_train"], None,
             lambda k: _i2t_argv("image2text_generation", k), I2T_STEPS,
             vit_layers + gpt_layers)
    ids = {}
    for beams in (1, 4):
        for use_kernel in (True, False):
            tag = "kernel" if use_kernel else "plain"
            out = os.path.join(workdir, "i2t_%d_%s.tsv" % (beams, tag))
            argv = ["--mode=predict", "--tables=" + paths["i2t_dev"],
                    "--outputs=" + out, "--checkpoint_dir=" + i2t_ckpt,
                    "--output_schema=gen_text,generated_ids",
                    "--append_cols=text"] + _i2t_argv(
                        "image2text_generation", use_kernel, "float32",
                        "num_beams=%d" % beams)
            manager, sec = cli("image2text predict (f32, %d beams)" % beams,
                               argv, use_kernel)
            with open(out, encoding="utf-8") as f:
                rows = [line.rstrip("\n").split("\t") for line in f]
            ids[beams, use_kernel] = [r[1].split() for r in rows]
            n_tok = sum(len(r) - 1 for r in ids[beams, use_kernel])
            batch_s = manager.predictor.batch_seconds
            log("image2text predict %-6s %d beams, %d rows, f32: %.3f s "
                "with load; %d caption tokens, %.3f ms per output token "
                "(batch time over the rows' generated slots)"
                % (tag, beams, len(rows), sec, n_tok,
                   1e3 * sum(batch_s) / max(n_tok, 1)))
        same = ids[beams, True] == ids[beams, False]
        log("image2text %d beams: kernel and plain %s token for token; %d "
            "distinct tokens" % (beams, "agree" if same else "DIFFER",
                                 len({t for r in ids[beams, True]
                                      for t in r[1:]})))
        if not same:
            raise AssertionError("image2text f32 captions: kernel and plain "
                                 "differ (%d beams)" % beams)
    with open(paths["i2t_dev"], encoding="utf-8") as f:
        images = [line.split("\t")[0] for line in f]
    A.set_kernel_override(None)  # the last CLI run was plain
    pipe = main_path("pipeline(image2text_generation) (f32)", lambda: pipeline(
        "image2text_generation", model_path=i2t_ckpt, dtype=torch.float32,
        sequence_length=I2T_TEXT_LEN, batch_size=I2T_BATCH,
        first_sequence="image")(images))
    if [r["generated_ids"].split() for r in pipe] != ids[1, True]:
        raise AssertionError("pipeline(image2text_generation) differs from "
                             "--mode=predict")
    log("pipeline(\"image2text_generation\") on the checkpoint: the CLI's "
        "%d greedy captions, id for id" % len(pipe))
    seconds["image2text"] = time.perf_counter() - t0

    # -- video2text_generation: predict on 3 frames ------------------------
    t0 = time.perf_counter()
    vids = {}
    for use_kernel in (True, False):
        out = os.path.join(workdir, "v2t_%s.tsv" % use_kernel)
        argv = ["--mode=predict", "--tables=" + paths["v2t"],
                "--outputs=" + out, "--checkpoint_dir=" + i2t_ckpt,
                "--output_schema=gen_text,generated_ids",
                "--append_cols=text"] + _i2t_argv(
                    "video2text_generation", use_kernel, "float32")
        _, sec = cli("video2text predict (f32)", argv, use_kernel)
        with open(out, encoding="utf-8") as f:
            vids[use_kernel] = [line.split("\t")[1] for line in f]
        log("video2text predict %-6s %d videos of 2-%d frames, f32: %.3f s "
            "with load" % ("kernel" if use_kernel else "plain",
                           len(vids[use_kernel]), V2T_FRAMES, sec))
    if vids[True] != vids[False]:
        raise AssertionError("video2text f32 captions: kernel and plain "
                             "differ")
    seconds["video2text"] = time.perf_counter() - t0
    log("phase 17 seconds by part: %s; total %.1f" % (", ".join(
        "%s %.1f" % kv for kv in seconds.items()),
        time.perf_counter() - t_phase))
    log("phase 17 launches of the kernel runs: %s" % total)
    total["flash_attention_bwd_dkdv"] = total["flash_attention_bwd"]
    total["flash_attention_bwd_dq"] = total["flash_attention_bwd"]
    return total



SD_V1 = {  # CompVis configs/stable-diffusion/v1-inference.yaml as an
    # LDMConfig (attention_resolutions [4, 2, 1]: levels 0-2), with
    # PAI-Diffusion's text tower: bert-base-chinese's widths, dropout 0
    "model_type": "latent_diffusion", "image_size": 512,
    "latent_channels": 4, "model_channels": 320,
    "channel_mult": [1, 2, 4, 4], "num_res_blocks": 2,
    "attention_levels": [0, 1, 2], "num_heads": 8, "context_dim": 768,
    "vae_channels": 128, "vae_channel_mult": [1, 2, 4, 4],
    "vae_num_res_blocks": 2, "num_train_timesteps": 1000,
    "scale_factor": 0.18215, "loss_type": "l2",
    "text_config": dict(BERT_BASE_CHINESE, num_hidden_layers=12,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0),
}
SD_DIR = "sd-v1-random"
SD_TEXT_LEN = 32              # --sequence_length: the prompts' tokens
SD_PROMPTS, SD_STEPS, SD_GUIDANCE = 2, 4, 7.5    # 20 steps until slice 14,
                                                # 10 until slice 16, 8
                                                # until slice 17
SD_FAST_STEPS = 4             # PLMS, DPM-Solver++ and the extras (10
                              # until slice 14, 5 until slice 15)
SD_TRAIN_BATCH, SD_TRAIN_STEPS, SD_DEV_ROWS = 2, 3, 4
SD_EXTRA_SIZE = 256           # the extras' images: 32 x 32 latents
SD_ESRGAN_INPUT = 128         # ESRGAN 4x: 128² -> 512²
# f32, kernel run against plain run: each f32 attention kernel is within
# 2e-5 of its twin and the UNet call within 1e-5 of the output's scale
# (TF32 off); 20 guided steps of DDIM, each dividing by sqrt(acp) >= 0.068
# at the first step, may grow that to ~1e-4. Bound 1e-3 of the largest
# |latent|; the PNGs (uint8) within 2 levels.
SD_LATENT_RTOL = 1e-3
SD_PNG_LEVELS = 2
# f32 evaluate, kernel against plain: the mean of per-row eps losses of
# ~1, each within ~1e-5 relative: bound 1e-4 relative
SD_EVAL_RTOL = 1e-4
# bf16 training, kernel against plain, every step: phase 17's bounds
SD_LOSS_ATOL = 1e-2
SD_GNORM_RTOL = 1.5e-2


def make_sd_dir(torch, path, vocab_path, seed):
    """config.json (SD_V1), vocab.txt and the port's init of LDMModule from
    `seed` on the card, under CompVis's names, as pytorch_model.bin.
    Returns (parameter count, seconds to write the file, its bytes)."""
    import shutil
    from easynlp_tpu_torch.appzoo.latent_diffusion.model import (
        LDMConfig, LDMModule)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(SD_V1, f, indent=2)
    shutil.copy(vocab_path, os.path.join(path, "vocab.txt"))
    module = LDMModule(LDMConfig.from_pretrained(path), device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    n = sum(p.numel() for p in module.parameters())
    t0 = time.perf_counter()
    weights = os.path.join(path, "pytorch_model.bin")
    torch.save(module.state_dict(), weights)
    seconds = time.perf_counter() - t0
    del module
    torch.cuda.empty_cache()
    return n, seconds, os.path.getsize(weights)


def make_sd_rows(workdir, cjk, seed):
    """The phase's tables from the seed: training rows (a caption and a
    base64 PNG of 512-640 pixels a side), evaluation rows and prompts."""
    import numpy as np
    rng = np.random.RandomState(seed + 18)
    common = cjk[:3000]

    def caption():
        return "".join(rng.choice(common, rng.randint(8, 24)))
    paths = {}
    for name, n in (("sd_train", SD_TRAIN_BATCH * SD_TRAIN_STEPS),
                    ("sd_dev", SD_DEV_ROWS)):
        paths[name] = os.path.join(workdir, name + ".tsv")
        with open(paths[name], "w", encoding="utf-8") as f:
            for _ in range(n):
                size = (int(rng.randint(512, 641)), int(rng.randint(512, 641)))
                f.write("%s\t%s\n" % (caption(), _png_b64(rng, size)))
    # ControlNet's 2 training rows: the first two training rows
    paths["sd_cn"] = os.path.join(workdir, "sd_cn.tsv")
    with open(paths["sd_train"], encoding="utf-8") as f, \
            open(paths["sd_cn"], "w", encoding="utf-8") as g:
        g.writelines(f.readlines()[:2])
    paths["sd_prompts"] = os.path.join(workdir, "sd_prompts.tsv")
    with open(paths["sd_prompts"], "w", encoding="utf-8") as f:
        for _ in range(SD_PROMPTS):
            f.write("%s\n" % caption())
    return paths


def _sd_argv(use_kernel, dtype="float32", udp="", batch=SD_PROMPTS,
             schema="text:str:1,image:str:1", image_size=None):
    image_size = image_size or SD_V1["image_size"]
    return ["--app_name=latent_diffusion", "--device=cuda",
            "--dtype=" + dtype, "--sequence_length=%d" % SD_TEXT_LEN,
            "--micro_batch_size=%d" % batch, "--input_schema=" + schema,
            "--first_sequence=text", "--second_sequence=image",
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false"),
            "--user_defined_parameters=image_size=%d %s" % (image_size, udp)]


class _HeadDimTally:
    """While entered, counts the short forward's kernel launches by head
    dim: a shim in place of A.short_attention_fwd adds each call's change of
    the wrapper's own count to the tally and to its `launches` (which the
    launch counter reads and zeroes meanwhile); the wrapper itself is
    restored on exit."""

    def __init__(self, A):
        import collections
        self.A, self.by_dim = A, collections.Counter()

    def __enter__(self):
        orig = self.orig = self.A.short_attention_fwd
        by_dim = self.by_dim

        def shim(q, *args, **kw):
            # the wrapper adds to the count of whatever its module's name
            # holds (this shim); a stand-in counting itself adds to its own
            s0, o0 = shim.launches, orig.launches
            out = orig(q, *args, **kw)
            shim.launches += orig.launches - o0
            by_dim[q.shape[-1]] += shim.launches - s0
            return out
        shim.launches = orig.launches
        self.A.short_attention_fwd = shim
        return self.by_dim

    def __exit__(self, *exc):
        self.A.short_attention_fwd = self.orig


def _png_array(b64):
    import base64
    import io as _io

    import numpy as np
    from PIL import Image
    return np.asarray(Image.open(_io.BytesIO(base64.b64decode(b64))),
                      np.int16)


def phase_diffusion(torch, seed, workdir, cjk):
    """Phase 18: latent diffusion at Stable Diffusion v1 widths (1.04 B
    parameters: the 860 M UNet, the 84 M KL VAE, PAI-Diffusion's 102 M
    bert-base-chinese text tower), the port's init from --seed written
    once as a 4.2 GB f32 pytorch_model.bin: f32 --mode=predict of 2
    prompts, 8 DDIM steps at guidance 7.5 (the PNGs, and the final latents
    through the app, kernels against plain), PLMS and DPM-Solver++ at SD_FAST_STEPS (4)
    steps, pipeline("chinese-ldm-general") against the CLI's PNGs, f32
    --mode=evaluate, 3 bf16 AdamW steps of 2 x 512² (no checkpoint),
    kernels against plain each; then at 256² (32 x 32 latents, which still
    run every kernel): ESRGAN 4x of a 128² image (RRDBNet, 23 blocks), a
    fresh ControlNet's sampler (the base's images bit for bit) and 2
    ControlNet training steps through the CLI (the base bit for bit), an
    OLSS fit and sample, edit and a 2-frame stylize_video. Returns the
    kernel runs' launches by wrapper."""
    import copy

    import numpy as np
    from easynlp_tpu_torch.appzoo.latent_diffusion.controlnet_app import (
        ControlNetApplication)
    from easynlp_tpu_torch.appzoo.latent_diffusion.model import (
        LatentDiffusion, upscale)
    from easynlp_tpu_torch.data.image_utils import (decode_base64_image,
                                                    preprocess_image_pm1)
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion import olss
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion.controlnet import (
        edge_hint)
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion.esrgan import (
        RRDBNet)
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.pipelines import pipeline
    log("== phase 18: latent diffusion at Stable Diffusion v1 widths")
    t_phase = time.perf_counter()
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")
    main_path, plain, total = _launch_counter(A, wrappers)
    seconds = {}
    t0 = time.perf_counter()
    sd_dir = os.path.join(workdir, SD_DIR)
    written0 = _written_gib()
    n_params, save_s, nbytes = make_sd_dir(
        torch, sd_dir, os.path.join(workdir, MODEL_DIR, "vocab.txt"), seed)
    paths = make_sd_rows(workdir, cjk, seed)
    written1 = _written_gib()
    log("SD v1 directory: %d parameters, pytorch_model.bin %.3f GB written "
        "in %.3f s (%s more passed to write(2)); %d training, %d evaluation "
        "rows and %d prompts made from seed %d; %.3f s"
        % (n_params, nbytes / 1e9, save_s, "not measured" if written0 is None
           else "%.2f GiB" % (written1 - written0),
           SD_TRAIN_BATCH * SD_TRAIN_STEPS, SD_DEV_ROWS, SD_PROMPTS, seed,
           time.perf_counter() - t0))
    seconds["directory"] = time.perf_counter() - t0
    # launches a UNet call: 16 cross-attentions (32 keys) and the
    # self-attentions of level 2 (5, 256 keys) and the middle block (64
    # keys) on B1; the self-attentions of levels 0 and 1 (4096 and 1024
    # keys) on B3; the text tower's 12 layers on B1
    unet_b1, unet_b1_top, unet_b3 = 22, 12, 10
    text_b1 = SD_V1["text_config"]["num_hidden_layers"]
    # level 2's and the middle block's head dim: 1280 / 8 = 160
    d_top = SD_V1["model_channels"] * SD_V1["channel_mult"][2] \
        // SD_V1["num_heads"]

    def cli(tag, argv, use_kernel, want=None):
        run = (lambda: _cli(torch, argv))
        if use_kernel:
            return main_path(tag, run, want)
        A.set_kernel_override(False)
        try:
            return plain(tag, run)
        finally:
            A.set_kernel_override(None)

    # -- --mode=predict, f32, with the kernels --------------------------
    t0 = time.perf_counter()
    out = os.path.join(workdir, "sd_pred.tsv")
    argv = ["--mode=predict", "--tables=" + paths["sd_prompts"],
            "--outputs=" + out, "--checkpoint_dir=" + sd_dir,
            "--output_schema=gen_imgbase64", "--append_cols=text"] + \
        _sd_argv(True, schema="text:str:1",
                 udp="num_steps=%d guidance_scale=%g seed=0"
                 % (SD_STEPS, SD_GUIDANCE))
    calls = 2 * SD_STEPS
    torch.cuda.reset_peak_memory_stats()
    with _HeadDimTally(A) as by_dim:
        _, sec = cli("sd predict (f32)", argv, True, {
            "short_attention_fwd": calls * unet_b1 + 2 * text_b1,
            "short_attention_bwd": 0,
            "flash_attention_fwd": calls * unet_b3,
            "flash_attention_bwd": 0})
    with open(out, encoding="utf-8") as f:
        pngs = [line.rstrip("\n").split("\t")[0] for line in f]
    shapes = {_png_array(b).shape for b in pngs}
    log("sd predict %d prompts, %d DDIM steps, guidance %g, f32: %.3f s "
        "with load; PNGs %s; peak device memory %.3f GiB; B1 launches by "
        "head dim %s" % (SD_PROMPTS, SD_STEPS, SD_GUIDANCE, sec,
                         sorted(shapes),
                         torch.cuda.max_memory_allocated() / 2 ** 30,
                         dict(sorted(by_dim.items()))))
    if shapes != {(SD_V1["image_size"], SD_V1["image_size"], 3)} \
            or len(pngs) != SD_PROMPTS:
        raise AssertionError("sd predict: PNGs %s" % sorted(shapes))
    if by_dim[d_top] != calls * unet_b1_top:
        raise AssertionError("sd predict: %d B1 launches at head dim %d, "
                             "want %d" % (by_dim[d_top], d_top,
                                          calls * unet_b1_top))
    seconds["predict"] = time.perf_counter() - t0

    # -- the final latents through the app, kernels against plain (the
    # switch --use_flash_attention=false sets): DDIM as the CLI ran it (its
    # kernel latents decode to the CLI's PNGs byte for byte), PLMS and
    # DPM-Solver++
    t0 = time.perf_counter()
    app = LatentDiffusion.from_pretrained(sd_dir, device="cuda")
    tok = tokenizer_for(sd_dir)
    with open(paths["sd_prompts"], encoding="utf-8") as f:
        prompts = [line.rstrip("\n") for line in f]
    enc = tok(prompts, max_length=SD_TEXT_LEN)
    neg = tok([""] * len(prompts), max_length=SD_TEXT_LEN)["input_ids"]
    for method, steps in (("ddim", SD_STEPS), ("plms", SD_FAST_STEPS),
                          ("dpm++", SD_FAST_STEPS)):
        latents, ms = {}, {}
        for use_kernel in (True, False):
            A.set_kernel_override(None if use_kernel else False)
            gen = torch.Generator().manual_seed(0)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run = (lambda: app.sample(
                enc["input_ids"], enc["attention_mask"], num_steps=steps,
                guidance_scale=SD_GUIDANCE, generator=gen,
                negative_input_ids=neg, method=method, decode=False))
            latents[use_kernel] = (main_path("sd %s latents" % method, run)
                                   if use_kernel else plain(method, run))
            torch.cuda.synchronize()
            ms[use_kernel] = 1e3 * (time.perf_counter() - t1)
        A.set_kernel_override(None)
        scale = latents[False].abs().max().item()
        d = (latents[True] - latents[False]).abs().max().item()
        calls = 2 * (steps + (method == "plms"))  # PLMS's first step: 2
        log("sd %-5s %d steps, f32 final latents [%s]: kernel %.1f ms, "
            "plain %.1f ms (%.1f / %.1f ms a guided UNet call); max |d| "
            "%.3e of max |latent| %.3f (bound %.0e relative); finite %s"
            % (method, steps, ", ".join(map(str, latents[True].shape)),
               ms[True], ms[False], ms[True] / calls, ms[False] / calls, d,
               scale, SD_LATENT_RTOL,
               bool(torch.isfinite(latents[True]).all())))
        if not torch.isfinite(latents[True]).all() \
                or d > SD_LATENT_RTOL * scale:
            raise AssertionError("sd %s: kernel and plain latents differ by "
                                 "%.3e" % (method, d))
        if method == "ddim":
            from easynlp_tpu_torch.data.image_utils import (
                encode_image_base64_png)
            decoded = {k: [encode_image_base64_png(x) for x in
                           app.decode(v).float().cpu().numpy()]
                       for k, v in latents.items()}
            d_png = max(int(np.abs(_png_array(a) - _png_array(b)).max())
                        for a, b in zip(decoded[True], decoded[False]))
            log("sd ddim decoded: the kernel run's PNGs %s the CLI's; plain "
                "PNGs within %d of 255 of them (bound %d)"
                % ("are" if decoded[True] == pngs else "DIFFER from", d_png,
                   SD_PNG_LEVELS))
            if decoded[True] != pngs or d_png > SD_PNG_LEVELS:
                raise AssertionError("sd ddim: the app's PNGs differ from "
                                     "the CLI's or plain's")
    seconds["latents"] = time.perf_counter() - t0

    # -- pipeline(): the CLI's PNGs, byte for byte -------------------------
    t0 = time.perf_counter()
    pipe = main_path("pipeline(chinese-ldm-general) (f32)", lambda: pipeline(
        "chinese-ldm-general", model_path=sd_dir, dtype=torch.float32,
        sequence_length=SD_TEXT_LEN), want_any=False)
    pipe._diffusion.num_steps = SD_STEPS
    rows = main_path("pipeline(chinese-ldm-general) call", lambda: pipe(
        prompts))
    same = [r["image_base64"] for r in rows] == pngs
    log("pipeline(\"chinese-ldm-general\") on the directory, %d steps, seed "
        "0: %s the CLI's %d PNGs" % (SD_STEPS, "byte for byte" if same
                                     else "DIFFERENT from", len(rows)))
    if not same:
        raise AssertionError("pipeline(chinese-ldm-general) differs from "
                             "--mode=predict")
    del pipe, rows
    torch.cuda.empty_cache()
    seconds["pipeline"] = time.perf_counter() - t0

    # -- --mode=evaluate, f32 ----------------------------------------------
    t0 = time.perf_counter()
    evals = {}
    for use_kernel in (True, False):
        argv = ["--mode=evaluate", "--tables=" + paths["sd_dev"],
                "--checkpoint_dir=" + sd_dir] + _sd_argv(use_kernel)
        batches = SD_DEV_ROWS // SD_PROMPTS
        evals[use_kernel], sec = cli("sd evaluate (f32)", argv, use_kernel, {
            "short_attention_fwd": batches * (unet_b1 + text_b1),
            "short_attention_bwd": 0,
            "flash_attention_fwd": batches * unet_b3,
            "flash_attention_bwd": 0})
        log("sd evaluate %-6s %d rows (f32): %s in %.3f s with load" % (
            "kernel" if use_kernel else "plain", SD_DEV_ROWS, ", ".join(
                "%s %.6f" % kv for kv in evals[use_kernel]), sec))
    ek, ep = evals[True][0][1], evals[False][0][1]
    log("sd evaluate kernel vs plain: |d eval_loss| %.3e (bound %.0e "
        "relative)" % (abs(ek - ep), SD_EVAL_RTOL))
    if not np.isfinite(ek) or abs(ek - ep) > SD_EVAL_RTOL * abs(ep):
        raise AssertionError("sd evaluate: kernel %.6f, plain %.6f"
                             % (ek, ep))
    seconds["evaluate"] = time.perf_counter() - t0

    # -- --mode=train, bf16 AdamW ------------------------------------------
    t0 = time.perf_counter()
    per_step = {"short_attention_fwd": unet_b1 + text_b1,
                "short_attention_bwd": unet_b1 + text_b1,
                "flash_attention_fwd": unet_b3,
                "flash_attention_bwd": unet_b3}
    runs = {True: main_path("sd train (bf16)", lambda: run_train(
        torch, sd_dir, paths["sd_train"], None, None, True, seed,
        common=_sd_argv(True, "bfloat16", batch=SD_TRAIN_BATCH)),
        {w: n * SD_TRAIN_STEPS for w, n in per_step.items()})}
    A.set_kernel_override(False)
    runs[False] = plain("sd train", lambda: run_train(
        torch, sd_dir, paths["sd_train"], None, None, False, seed,
        common=_sd_argv(False, "bfloat16", batch=SD_TRAIN_BATCH)))
    A.set_kernel_override(None)
    for use_kernel, run in runs.items():
        _check_train_run("sd %s" % use_kernel, run, SD_TRAIN_STEPS)
        ms = [1e3 * r["seconds"] for r in run["records"]]
        log("sd train %-6s %d steps of %d x %d²: step ms %s (CUDA events), "
            "peak device memory %.3f GiB above the run's start, run %.3f s "
            "with load; losses %s; grad norms %s; launches a step: %s"
            % ("kernel" if use_kernel else "plain", SD_TRAIN_STEPS,
               SD_TRAIN_BATCH, SD_V1["image_size"],
               " ".join("%.3f" % m for m in ms), run["peak_gib"],
               run["total_s"],
               " ".join("%.5f" % r["loss"] for r in run["records"]),
               " ".join("%.4f" % r["grad_norm"] for r in run["records"]),
               per_step if use_kernel else 0))
    rec_k, rec_p = runs[True]["records"], runs[False]["records"]
    d_loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(rec_k, rec_p))
    d_gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                  for a, b in zip(rec_k, rec_p))
    log("sd kernel vs plain training: max |d loss| per step %.3e (bound "
        "%.1e), max relative grad-norm gap %.3e (bound %.1e)"
        % (d_loss, SD_LOSS_ATOL, d_gnorm, SD_GNORM_RTOL))
    if d_loss > SD_LOSS_ATOL or d_gnorm > SD_GNORM_RTOL:
        raise AssertionError("sd: kernel and plain training disagree "
                             "(loss %.3e, grad norm %.3e)" % (d_loss,
                                                              d_gnorm))
    seconds["train"] = time.perf_counter() - t0

    # -- the extras at 256² ------------------------------------------------
    t0 = time.perf_counter()
    small = copy.copy(app.config)
    small.image_size = SD_EXTRA_SIZE
    app.config = small
    gen = torch.Generator().manual_seed(1)
    # ESRGAN 4x (RRDBNet, 23 blocks, random weights) on a 128² image
    net = RRDBNet(device="cuda")
    net.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    image = torch.rand((1, SD_ESRGAN_INPUT, SD_ESRGAN_INPUT, 3),
                       generator=gen).cuda() * 2 - 1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    big = upscale(net.eval(), image)
    torch.cuda.synchronize()
    log("ESRGAN 4x (RRDBNet nb 23, f32) %s -> %s in %.3f s, finite %s"
        % (list(image.shape), list(big.shape), time.perf_counter() - t1,
           bool(torch.isfinite(big).all())))
    if big.shape != (1, 4 * SD_ESRGAN_INPUT, 4 * SD_ESRGAN_INPUT, 3) \
            or not torch.isfinite(big).all():
        raise AssertionError("ESRGAN: %s" % list(big.shape))
    del net, big
    # a fresh ControlNet: its sampler gives the base's images bit for bit
    hint_img = np.stack([preprocess_image_pm1(decode_base64_image(
        line.split("\t")[1]), SD_EXTRA_SIZE) for line in open(
            paths["sd_dev"], encoding="utf-8").read().splitlines()[:2]])
    control = ControlNetApplication(app, seed=seed)
    x_t = torch.randn(app.latent_shape(2), generator=gen).cuda()
    base_images = main_path(
        "sd base sample %d² (f32)" % SD_EXTRA_SIZE, lambda: app.sample(
            enc["input_ids"], enc["attention_mask"], num_steps=SD_FAST_STEPS,
            guidance_scale=SD_GUIDANCE, negative_input_ids=neg, x_init=x_t))
    hint = (edge_hint(torch.from_numpy(hint_img)) + 0.0).cuda()
    cn_images = main_path(
        "sd ControlNet sample %d² (f32)" % SD_EXTRA_SIZE,
        lambda: control.sample(enc["input_ids"], enc["attention_mask"], neg,
                               hint, num_steps=SD_FAST_STEPS,
                               guidance_scale=SD_GUIDANCE, x_init=x_t))
    same = torch.equal(base_images, cn_images)
    log("ControlNet (%d parameters, fresh: zero convs) sampler, %d steps at "
        "%d²: the base's images %s" % (
            sum(p.numel() for p in control.controlnet.parameters()),
            SD_FAST_STEPS, SD_EXTRA_SIZE,
            "bit for bit" if same else "DIFFERENT"))
    if not same:
        raise AssertionError("a fresh ControlNet changed the base's images")
    del control, cn_images
    # an OLSS fit (an 8-step DDIM teacher, 5 student steps) and its sampler
    t1 = time.perf_counter()
    fitted = main_path("sd OLSS fit (f32)", lambda: app.fit_olss(
        enc["input_ids"], enc["attention_mask"], neg, teacher_steps=SD_STEPS,
        student_steps=5, guidance_scale=SD_GUIDANCE, generator=gen))
    olss.save_olss(os.path.join(workdir, "olss.npz"), *fitted)
    fitted = olss.load_olss(os.path.join(workdir, "olss.npz"))
    olss_images = main_path("sd OLSS sample (f32)", lambda:
                            app.make_olss_sampler(fitted, SD_GUIDANCE)(
                                enc["input_ids"], enc["attention_mask"],
                                neg, gen))
    log("OLSS: timesteps %s, wx %s; student images %s finite %s; %.3f s"
        % (list(fitted[0]), np.round(fitted[1], 4).tolist(),
           list(olss_images.shape), bool(torch.isfinite(olss_images).all()),
           time.perf_counter() - t1))
    # FreePromptEditing and a 2-frame cross-frame stylization
    t1 = time.perf_counter()
    edited = main_path("sd edit (f32)", lambda: app.edit(
        enc["input_ids"][:1], enc["input_ids"][1:], num_steps=SD_FAST_STEPS,
        guidance_scale=SD_GUIDANCE, generator=gen))
    frames = torch.from_numpy(hint_img)
    styled = main_path("sd stylize_video (f32)", lambda: app.stylize_video(
        frames, enc["input_ids"][:1], num_steps=SD_FAST_STEPS,
        strength=0.7, guidance_scale=SD_GUIDANCE, generator=gen))
    log("edit: %s, stylize_video (2 frames, strength 0.7): %s, finite %s; "
        "%.3f s" % (list(edited.shape), list(styled.shape), bool(
            torch.isfinite(edited).all() and torch.isfinite(styled).all()),
            time.perf_counter() - t1))
    for name, images in (("OLSS", olss_images), ("edit", edited),
                         ("stylize_video", styled)):
        if not torch.isfinite(images).all() or images.shape[1:] != (
                SD_EXTRA_SIZE, SD_EXTRA_SIZE, 3):
            raise AssertionError("%s: images %s" % (name,
                                                    list(images.shape)))
    # 2 ControlNet training steps through the CLI, base frozen
    base_state = {k: v for k, v in app.module.state_dict().items()}
    trainer, sec = main_path("sd ControlNet train (bf16)", lambda: _cli(
        torch, ["--mode=train", "--tables=" + paths["sd_cn"],
                "--pretrained_model_name_or_path=" + sd_dir,
                "--epoch_num=1", "--learning_rate=%g" % LEARNING_RATE,
                "--logging_steps=1", "--random_seed=%d" % seed]
        + _sd_argv(True, "bfloat16", "enable_controlnet=true", batch=1,
                   image_size=SD_EXTRA_SIZE)))
    frozen = all(torch.equal(base_state[k], v.to(base_state[k].device))
                 for k, v in trainer.app.inner.module.state_dict().items())
    moved = trainer.global_step
    log("ControlNet training through the CLI: %d bf16 steps of 1 x %d² in "
        "%.3f s with load; losses %s; the base %s" % (
            moved, SD_EXTRA_SIZE, sec, " ".join(
                "%.5f" % r["loss"] for r in trainer.step_records),
            "bit for bit" if frozen else "CHANGED"))
    if not frozen or moved != 2:
        raise AssertionError("ControlNet training: %d steps, base frozen %s"
                             % (moved, frozen))
    del trainer, app, base_state
    torch.cuda.empty_cache()
    seconds["extras"] = time.perf_counter() - t0
    log("phase 18 seconds by part: %s; total %.1f" % (", ".join(
        "%s %.1f" % kv for kv in seconds.items()),
        time.perf_counter() - t_phase))
    log("phase 18 launches of the kernel runs: %s" % total)
    total["flash_attention_bwd_dkdv"] = total["flash_attention_bwd"]
    total["flash_attention_bwd_dq"] = total["flash_attention_bwd"]
    return total


ARTIST_BASE = {  # ARTIST-base: ARTISTConfig's text side (bert-base-chinese's
    # 21128 tokens, 32 of them, 256 codes), GPT-2 small's widths (vocabulary
    # 21128 + 16384) and taming-transformers' vqgan_imagenet_f16_16384
    # VQGAN (ch 128, ch_mult 1/1/2/2/4, 2 res blocks, embed_dim 256,
    # n_embed 16384; no attention blocks or quant_conv, as in the JAX
    # VQGAN); dropout 0
    "model_type": "artist", "text_vocab_size": 21128,
    "image_vocab_size": 16384, "image_token_length": 256, "text_length": 32,
    "codebook_dim": 256, "vq_channels": 128,
    "vq_channel_mult": [1, 1, 2, 2, 4], "vq_num_res_blocks": 2,
    "commitment_cost": 0.25,
    "gpt_config": {k: v for k, v in GPT2_SMALL.items()
                   if k not in ("model_type", "architectures", "vocab_size")
                   } | {"resid_pdrop": 0.0, "embd_pdrop": 0.0,
                        "attn_pdrop": 0.0},
}
ARTIST_DIR = "artist-base-random"
ARTIST_TEXT_LEN = 32          # --sequence_length: the captions' tokens
ARTIST_SIZE = 256             # pixels a side: 16 x 16 codes
ARTIST_BATCH, ARTIST_STEPS, ARTIST_PROMPTS = 8, 2, 2  # 4 and 4 until
# slice 17
I2T_VQ_STEPS = 3
# bf16 training, kernel run against plain run, every step: phase 15's
# bounds (S2S_LOSS_ATOL, S2S_GNORM_RTOL). The VQGAN's losses take no
# attention and are equal in both runs; the LM loss over 37512 ids moves
# by bf16 rounding through 12 layers, as phase 15's seq2seq losses do.
ARTIST_LOSS_ATOL = S2S_LOSS_ATOL
ARTIST_GNORM_RTOL = S2S_GNORM_RTOL
# f32 evaluate, kernel against plain: the mean of per-row LM losses of
# ~10 and VQ losses of ~1, each within ~1e-6 relative: bound 1e-4
# relative, phase 18's
ARTIST_EVAL_RTOL = SD_EVAL_RTOL
# TextCNN (default widths) and bloom-560m, the card's f32 forward (TF32
# off) against the same module on the CPU: summation orders differ, each
# op by ~1e-6 relative, through at most 24 pre-LN layers: bound 1e-4 of
# the output's largest magnitude
CARD_CPU_RTOL = 1e-4
BLOOM_TOKENS = (2, 64)


def make_artist_rows(workdir, cjk, seed):
    """The phase's tables from the seed: text2image training rows (a
    caption of 8-30 characters and a url-safe PNG of 256-320 pixels a
    side), prompts, and captioning rows (the PNG first) for
    enable_vqgan."""
    import numpy as np
    rng = np.random.RandomState(seed + 19)
    common = cjk[:3000]

    def caption():
        return "".join(rng.choice(common, rng.randint(8, 31)))

    def image():
        return _png_b64(rng, (int(rng.randint(256, 321)),
                              int(rng.randint(256, 321))), urlsafe=True)
    paths = {name: os.path.join(workdir, name + ".tsv")
             for name in ("t2i_train", "t2i_dev", "t2i_prompts",
                          "i2t_vq_train", "i2t_vq_dev")}
    with open(paths["t2i_train"], "w", encoding="utf-8") as f:
        for _ in range(ARTIST_BATCH * ARTIST_STEPS):
            f.write("%s\t%s\n" % (caption(), image()))
    with open(paths["t2i_train"], encoding="utf-8") as f, \
            open(paths["t2i_dev"], "w", encoding="utf-8") as g:
        g.writelines(f.readlines()[:ARTIST_BATCH])
    with open(paths["t2i_prompts"], "w", encoding="utf-8") as f:
        for _ in range(ARTIST_PROMPTS):
            f.write("%s\n" % caption())
    with open(paths["i2t_vq_train"], "w", encoding="utf-8") as f:
        for _ in range(ARTIST_BATCH * I2T_VQ_STEPS):
            f.write("%s\t%s\n" % (image(), caption()))
    with open(paths["i2t_vq_train"], encoding="utf-8") as f, \
            open(paths["i2t_vq_dev"], "w", encoding="utf-8") as g:
        g.writelines(f.readlines()[:ARTIST_PROMPTS])
    return paths


def make_artist_dir(torch, path, vocab_path, seed):
    """config.json (ARTIST_BASE), vocab.txt and the port's init of
    ARTISTModel from `seed` on the card as pytorch_model.bin. Returns
    (parameters of the GPT with its head, of the VQGAN with its codebook,
    the file's bytes)."""
    import shutil
    from easynlp_tpu_torch.modelzoo.models.artist import (ARTISTConfig,
                                                          ARTISTModel)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(ARTIST_BASE, f, indent=2)
    shutil.copy(vocab_path, os.path.join(path, "vocab.txt"))
    module = ARTISTModel(ARTISTConfig.from_pretrained(path), device="cuda")
    module.init_weights(torch.Generator(device="cuda").manual_seed(seed))
    n_gpt = sum(p.numel() for m in (module.gpt, module.lm_head)
                for p in m.parameters())
    n_vq = sum(p.numel() for p in module.parameters()) - n_gpt
    weights = os.path.join(path, "pytorch_model.bin")
    torch.save(module.state_dict(), weights)
    del module
    torch.cuda.empty_cache()
    return n_gpt, n_vq, os.path.getsize(weights)


def _artist_argv(app, use_kernel, dtype="bfloat16", udp="",
                 batch=ARTIST_BATCH):
    schema = ("image:str:1,text:str:1" if app == "image2text_generation"
              else "text:str:1,image:str:1")
    first, second = schema.replace(":str:1", "").split(",")
    return ["--app_name=" + app, "--device=cuda", "--dtype=" + dtype,
            "--sequence_length=%d" % ARTIST_TEXT_LEN,
            "--micro_batch_size=%d" % batch, "--input_schema=" + schema,
            "--first_sequence=" + first, "--second_sequence=" + second,
            "--use_flash_attention=%s" % ("auto" if use_kernel else "false"),
            "--user_defined_parameters=size=%d %s" % (ARTIST_SIZE, udp)]


def _top2_margin(torch, module, ids, mask, allowed):
    """The plain path's f32 top-2 margin of the next-token logits after
    ids [1, S] (key mask `mask`), over the vocabulary slice `allowed`."""
    from easynlp_tpu_torch.ops import attention as A
    A.set_kernel_override(False)
    try:
        with torch.inference_mode():
            logits = module.lm_step(ids, attention_mask=mask)["logits"]
        top2 = logits[0, -1, allowed].float().topk(2).values
    finally:
        A.set_kernel_override(None)
    return (top2[0] - top2[1]).item()


def phase_artist(torch, seed, workdir, cjk):
    """Phase 19: ARTIST-base (text2image_generation, and
    image2text_generation with enable_vqgan) at full width, the port's
    init from --seed written once as pytorch_model.bin, on synthetic 256²
    PNG rows: text2image 4 bf16 AdamW steps of 8 x (32 + 256) with and
    without the kernels (every loss and grad norm held to plain's; the
    kernel run writes the phase's one checkpoint), f32 --mode=evaluate
    (kernel vs plain), f32 greedy codes for 4 prompts through the app on
    the directory's init (code for code, or parting only at an f32 tie),
    top-k 100 sampled PNGs through the CLI and pipeline() on the
    checkpoint (byte for byte); enable_vqgan 3
    bf16 steps kernel vs plain (no checkpoint) and f32 greedy captions on
    the text2image checkpoint (the same tower) kernel vs plain; then
    TextCNN at its default widths and bloom-560m from AutoModel, an f32
    forward on the card against the same module on the CPU. Returns the
    kernel runs' launches by wrapper."""
    import numpy as np
    from easynlp_tpu_torch.appzoo.image2text_generation.vqgan_model import (
        VQGANImageTextDataset)
    from easynlp_tpu_torch.appzoo.text2image_generation.model import (
        TextImageGeneration)
    from easynlp_tpu_torch.modelzoo.models import auto
    from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.pipelines import pipeline
    log("== phase 19: ARTIST-base text2image and enable_vqgan captioning "
        "(GPT-2 small widths, f16/16384 VQGAN), TextCNN, bloom-560m")
    t_phase = time.perf_counter()
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")
    main_path, plain, total = _launch_counter(A, wrappers)
    layers = ARTIST_BASE["gpt_config"]["n_layer"]
    codes_n = ARTIST_BASE["image_token_length"]
    tv = ARTIST_BASE["text_vocab_size"]
    seconds = {}
    t0 = time.perf_counter()
    paths = make_artist_rows(workdir, cjk, seed)
    artist_dir = os.path.join(workdir, ARTIST_DIR)
    written0 = _written_gib()
    n_gpt, n_vq, nbytes = make_artist_dir(
        torch, artist_dir, os.path.join(workdir, MODEL_DIR, "vocab.txt"),
        seed)
    written1 = _written_gib()
    log("ARTIST-base directory: %d parameters (GPT and head %d, VQGAN and "
        "codebook %d), pytorch_model.bin %.3f GB (%s passed to write(2)); "
        "%d + %d training rows, %d prompts made from seed %d; %.3f s"
        % (n_gpt + n_vq, n_gpt, n_vq, nbytes / 1e9,
           "not measured" if written0 is None
           else "%.2f GiB" % (written1 - written0),
           ARTIST_BATCH * ARTIST_STEPS, ARTIST_BATCH * I2T_VQ_STEPS,
           ARTIST_PROMPTS, seed, time.perf_counter() - t0))
    seconds["directory"] = time.perf_counter() - t0

    def cli(tag, argv, use_kernel, want=None):
        run = (lambda: _cli(torch, argv))
        if use_kernel:
            return main_path(tag, run, want)
        try:
            return plain(tag, run)
        finally:
            A.set_kernel_override(None)  # the CLI set it from its flag

    def training(tag, app, table, ckpt, steps, udp=""):
        per_step = {"short_attention_fwd": layers * steps,
                    "short_attention_bwd": layers * steps,
                    "flash_attention_fwd": 0, "flash_attention_bwd": 0}
        runs = {True: main_path(tag + " train (bf16)", lambda: run_train(
            torch, artist_dir, table, None, ckpt, True, seed,
            common=_artist_argv(app, True, udp=udp)), per_step)}
        try:
            runs[False] = plain(tag + " train", lambda: run_train(
                torch, artist_dir, table, None, None, False, seed,
                common=_artist_argv(app, False, udp=udp)))
        finally:
            A.set_kernel_override(None)
        for use_kernel, run in runs.items():
            _check_train_run("%s %s" % (tag, use_kernel), run, steps)
        rec_k, rec_p = runs[True]["records"], runs[False]["records"]
        d_loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(rec_k,
                                                                rec_p))
        d_gnorm = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                      for a, b in zip(rec_k, rec_p))
        for use_kernel, run in runs.items():
            ms = [1e3 * r["seconds"] for r in run["records"]]
            log("%s train %-6s %d steps of %d x (%d + %d): step ms median "
                "%.3f (steps 2-%d; first %.3f), peak device memory %.3f GiB "
                "above the run's start, run %.3f s with load%s; losses %s; "
                "grad norms %s; launches a step: B1 %d, B2 %d"
                % (tag, "kernel" if use_kernel else "plain", len(ms),
                   ARTIST_BATCH, ARTIST_TEXT_LEN, codes_n,
                   statistics.median(ms[1:]), len(ms), ms[0],
                   run["peak_gib"], run["total_s"],
                   " and save" if use_kernel and ckpt else "",
                   " ".join("%.5f" % r["loss"] for r in run["records"]),
                   " ".join("%.4f" % r["grad_norm"] for r in run["records"]),
                   layers if use_kernel else 0, layers if use_kernel else 0))
        log("%s kernel vs plain training: max |d loss| per step %.3e "
            "(bound %.1e), max relative grad-norm gap %.3e (bound %.1e)"
            % (tag, d_loss, ARTIST_LOSS_ATOL, d_gnorm, ARTIST_GNORM_RTOL))
        if d_loss > ARTIST_LOSS_ATOL or d_gnorm > ARTIST_GNORM_RTOL:
            raise AssertionError("%s: kernel and plain training disagree "
                                 "(loss %.3e, grad norm %.3e)"
                                 % (tag, d_loss, d_gnorm))

    # -- text2image: train, evaluate -------------------------------------
    t0 = time.perf_counter()
    ckpt = os.path.join(workdir, "artist_ckpt")
    training("text2image", "text2image_generation", paths["t2i_train"],
             ckpt, ARTIST_STEPS)
    seconds["text2image train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    evals = {}
    for use_kernel in (True, False):
        argv = ["--mode=evaluate", "--tables=" + paths["t2i_dev"],
                "--checkpoint_dir=" + ckpt] + _artist_argv(
                    "text2image_generation", use_kernel, "float32")
        evals[use_kernel], sec = cli(
            "text2image evaluate (f32)", argv, use_kernel,
            {"short_attention_fwd": layers, "short_attention_bwd": 0,
             "flash_attention_fwd": 0, "flash_attention_bwd": 0})
        log("text2image evaluate %-6s %d rows (f32): %s in %.3f s with load"
            % ("kernel" if use_kernel else "plain", ARTIST_BATCH,
               ", ".join("%s %.6f" % kv for kv in evals[use_kernel]), sec))
    d_eval = abs(evals[True][0][1] - evals[False][0][1])
    log("text2image evaluate kernel vs plain: |d eval_loss| %.3e (bound "
        "%.0e relative)" % (d_eval, ARTIST_EVAL_RTOL))
    if d_eval > ARTIST_EVAL_RTOL * abs(evals[False][0][1]):
        raise AssertionError("text2image f32 evaluate: kernel and plain "
                             "differ by %.3e" % d_eval)
    seconds["text2image evaluate"] = time.perf_counter() - t0

    # -- text2image: f32 greedy codes, kernel against plain ---------------
    t0 = time.perf_counter()
    # on the directory's random init: the trained checkpoint's greedy codes
    # repeat the one or two codes that the random VQGAN gives every
    # training image (2 distinct in 1024 on an H100), so few decisions
    # would be held to plain's
    app = TextImageGeneration.from_pretrained(artist_dir,
                                              dtype=torch.float32)
    with open(paths["t2i_prompts"], encoding="utf-8") as f:
        prompts = [line.rstrip("\n") for line in f]
    enc = tokenizer_for(ckpt)(prompts, max_length=ARTIST_TEXT_LEN)
    ids = np.asarray(enc["input_ids"], np.int32)
    mask = np.asarray(enc["attention_mask"], np.int32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    codes, gen_s = {}, {}
    try:
        for use_kernel in (True, False):
            A.set_kernel_override(None if use_kernel else False)

            def greedy():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = app.generate(ids, mask, do_sample=False)
                torch.cuda.synchronize()
                gen_s[use_kernel] = time.perf_counter() - t1
                return out.cpu()
            try:
                codes[use_kernel] = (main_path(
                    "text2image greedy codes (f32)", greedy,
                    {"short_attention_fwd": layers * codes_n,
                     "short_attention_bwd": 0, "flash_attention_fwd": 0,
                     "flash_attention_bwd": 0}) if use_kernel
                    else plain("text2image greedy codes", greedy))
            finally:
                A.set_kernel_override(None)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    for use_kernel in (True, False):
        log("text2image greedy %-6s %d prompts x %d codes (f32): %.3f s a "
            "batch, %.3f ms per image code; B1 launches %d (%d a code: the "
            "prefill's and each decode step's %d layers)"
            % ("kernel" if use_kernel else "plain", ARTIST_PROMPTS, codes_n,
               gen_s[use_kernel], 1e3 * gen_s[use_kernel] / codes_n,
               layers * codes_n if use_kernel else 0,
               layers if use_kernel else 0, layers))

    def code_margin(i, j):
        seq = torch.cat([torch.from_numpy(ids[i:i + 1]).long(),
                         codes[False][i:i + 1, :j] + tv], dim=1).cuda()
        m = torch.cat([torch.from_numpy(mask[i:i + 1]),
                       torch.ones((1, j), dtype=torch.int32)], dim=1).cuda()
        return _top2_margin(torch, app.module, seq, m, slice(tv, None))
    same, ties = _same_or_tie("text2image greedy codes", codes[True].tolist(),
                              codes[False].tolist(), code_margin)
    n_distinct = len(np.unique(codes[True].numpy()))
    log("text2image f32 greedy codes, kernel vs plain: %d of %d rows code "
        "for code, %d parting at an f32 tie (top-2 margin <= %.0e); %d "
        "distinct codes" % (same, ARTIST_PROMPTS, ties, SERVE_F32_TIE,
                            n_distinct))
    if codes[True].shape != (ARTIST_PROMPTS, codes_n) or n_distinct < 2:
        raise AssertionError("text2image greedy codes: %s, %d distinct"
                             % (list(codes[True].shape), n_distinct))
    pixels = app.decode_images(codes[True])
    if pixels.shape != (ARTIST_PROMPTS, ARTIST_SIZE, ARTIST_SIZE, 3) \
            or not torch.isfinite(pixels).all():
        raise AssertionError("text2image decode: %s" % list(pixels.shape))
    del app, pixels
    torch.cuda.empty_cache()
    seconds["text2image greedy"] = time.perf_counter() - t0

    # -- text2image: sampled PNGs through the CLI and pipeline() ----------
    t0 = time.perf_counter()
    out = os.path.join(workdir, "t2i_pred.tsv")
    argv = ["--mode=predict", "--tables=" + paths["t2i_prompts"],
            "--input_schema=text:str:1", "--outputs=" + out,
            "--checkpoint_dir=" + ckpt, "--output_schema=gen_imgbase64"] + [
        a for a in _artist_argv("text2image_generation", True, "float32",
                                "top_k=100 seed=%d" % seed,
                                batch=ARTIST_PROMPTS)
        if not a.startswith("--input_schema")]
    manager, sec = cli("text2image predict (f32, top-k 100)", argv, True,
                       {"short_attention_fwd": layers * codes_n,
                        "short_attention_bwd": 0, "flash_attention_fwd": 0,
                        "flash_attention_bwd": 0})
    with open(out, encoding="utf-8") as f:
        pngs = [line.rstrip("\n").split("\t")[0] for line in f]
    sizes = {_png_array(p).shape for p in pngs}
    batch_s = manager.predictor.batch_seconds
    log("text2image predict %d prompts (f32, top-k 100, seed %d): %.3f s "
        "with load; %.3f s a batch of %d codes (codes and VQGAN decode), "
        "%.3f ms per image code; PNGs %s, %d distinct"
        % (len(pngs), seed, sec, statistics.median(batch_s), codes_n,
           1e3 * statistics.median(batch_s) / codes_n, sorted(sizes),
           len(set(pngs))))
    if sizes != {(ARTIST_SIZE, ARTIST_SIZE, 3)} or len(pngs) != \
            ARTIST_PROMPTS:
        raise AssertionError("text2image predict: %d PNGs of %s"
                             % (len(pngs), sorted(sizes)))
    pipe = pipeline("text2image_generation", model_path=ckpt,
                    dtype=torch.float32, sequence_length=ARTIST_TEXT_LEN,
                    batch_size=ARTIST_PROMPTS)
    pipe.predictor.generator.manual_seed(seed)
    rows = main_path("pipeline(text2image_generation) (f32)",
                     lambda: pipe(prompts))
    if [r["gen_imgbase64"] for r in rows] != pngs:
        raise AssertionError("pipeline(text2image_generation) differs from "
                             "--mode=predict")
    log("pipeline(\"text2image_generation\") on the checkpoint, seed %d: "
        "the CLI's %d PNGs byte for byte" % (seed, len(rows)))
    del pipe
    torch.cuda.empty_cache()
    seconds["text2image sample"] = time.perf_counter() - t0

    # -- image2text with enable_vqgan: train, greedy captions -------------
    t0 = time.perf_counter()
    training("image2text (enable_vqgan)", "image2text_generation",
             paths["i2t_vq_train"], None, I2T_VQ_STEPS,
             udp="enable_vqgan=true")
    caps = {}
    for use_kernel in (True, False):
        out = os.path.join(workdir, "i2t_vq_%s.tsv" % use_kernel)
        argv = ["--mode=predict", "--tables=" + paths["i2t_vq_dev"],
                "--outputs=" + out, "--checkpoint_dir=" + ckpt,
                "--output_schema=gen_text,generated_ids",
                "--append_cols=text"] + _artist_argv(
                    "image2text_generation", use_kernel, "float32",
                    "enable_vqgan=true", batch=ARTIST_PROMPTS)
        _, sec = cli("image2text enable_vqgan predict (f32)", argv,
                     use_kernel)
        with open(out, encoding="utf-8") as f:
            caps[use_kernel] = [[int(t) for t in line.split("\t")[1].split()]
                                for line in f]
        log("image2text enable_vqgan predict %-6s %d images (f32, greedy): "
            "%.3f s with load" % ("kernel" if use_kernel else "plain",
                                  len(caps[use_kernel]), sec))
    tower = TextImageGeneration.from_pretrained(ckpt, dtype=torch.float32)
    vq_codes = {}

    def caption_margin(i, j):
        if i not in vq_codes:
            ds = VQGANImageTextDataset(
                paths["i2t_vq_dev"], tokenizer_for(ckpt),
                max_seq_length=ARTIST_TEXT_LEN,
                input_schema="image:str:1,text:str:1",
                first_sequence="image", second_sequence="text",
                user_defined_parameters={"size": ARTIST_SIZE})
            pv = torch.from_numpy(ds[i]["pixel_values"][None]).cuda()
            with torch.inference_mode():
                vq_codes[i] = tower.module.tokenize_image(pv)[0].reshape(
                    1, -1)
        seq = torch.cat([vq_codes[i] + tv, torch.tensor(
            [caps[False][i][:j + 1]]).cuda()], dim=1)
        return _top2_margin(torch, tower.module, seq, torch.ones_like(seq),
                            slice(0, tv))
    # the rows hold BOS then the caption: a parting at row position j is
    # the (j - 1)-th generated token, after BOS and j - 1 tokens
    same, ties = _same_or_tie("enable_vqgan captions", caps[True],
                              caps[False], lambda i, j: caption_margin(
                                  i, j - 1))
    log("image2text enable_vqgan f32 captions, kernel vs plain: %d of %d "
        "rows token for token, %d parting at an f32 tie; %d distinct "
        "tokens" % (same, len(caps[True]), ties,
                    len({t for r in caps[True] for t in r[1:]})))
    del tower
    torch.cuda.empty_cache()
    seconds["image2text enable_vqgan"] = time.perf_counter() - t0

    # -- TextCNN and bloom-560m: the card against the CPU -----------------
    t0 = time.perf_counter()
    from easynlp_tpu_torch.modelzoo.models.bloom import BloomConfig
    from easynlp_tpu_torch.modelzoo.models.cnn import (TextCNNConfig,
                                                       TextCNNModel)
    rng = np.random.RandomState(seed + 20)
    b, s = BLOOM_TOKENS
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, config, key in (
                ("TextCNN", TextCNNConfig(), "pooler_output"),
                ("bloom-560m", BloomConfig(), "logits")):
            card = auto.AutoModel.from_config(config, device="cuda").eval()
            cpu = type(card)(config).eval()  # the card's weights, no init
            cpu.load_state_dict({k: v.cpu() for k, v in
                                 card.state_dict().items()})
            ids = rng.randint(0, config.vocab_size, (b, s))
            mask = np.ones((b, s), np.int64)
            mask[1, s // 2:] = 0   # a right-padded row
            n = sum(p.numel() for p in card.parameters())
            with torch.inference_mode():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                got = card(torch.from_numpy(ids).cuda(),
                           torch.from_numpy(mask).cuda())[key]
                torch.cuda.synchronize()
                card_s = time.perf_counter() - t1
                t1 = time.perf_counter()
                want = cpu(torch.from_numpy(ids), torch.from_numpy(mask))[key]
                cpu_s = time.perf_counter() - t1
            real = torch.from_numpy(mask).bool() if key == "logits" else \
                slice(None)
            err = (got.cpu() - want)[real].abs().max().item()
            scale = want[real].abs().max().item()
            log("%s (%d parameters) f32 forward of %d x %d tokens, %s %s: "
                "card %.3f s, CPU %.3f s; max |d| %.3e of max |x| %.3e "
                "(bound %.0e relative)" % (
                    name, n, b, s, key, list(got.shape), card_s, cpu_s, err,
                    scale, CARD_CPU_RTOL))
            if not torch.isfinite(got).all() or err > CARD_CPU_RTOL * scale:
                raise AssertionError("%s: the card's forward differs from "
                                     "the CPU's by %.3e" % (name, err))
            del card, cpu, got, want
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    seconds["TextCNN, BLOOM"] = time.perf_counter() - t0
    log("phase 19 seconds by part: %s; total %.1f" % (", ".join(
        "%s %.1f" % kv for kv in seconds.items()),
        time.perf_counter() - t_phase))
    log("phase 19 launches of the kernel runs: %s" % total)
    total["flash_attention_bwd_dkdv"] = total["flash_attention_bwd"]
    total["flash_attention_bwd_dq"] = total["flash_attention_bwd"]
    return total


# --------------------------------------------------------------------------
# phase 20: the device-parallel layer (torch.distributed)
# --------------------------------------------------------------------------

# the ranks' own checks: BERT-base's widths (N_LAYERS layers), GPT-2
# small's widths with Switch-MoE layers (Switch-Base-8: 8 experts, top-1,
# capacity factor 1.25; Fedus et al. 2021) cut to MOE_LAYERS layers, and
# glm-large's widths cut to PARALLEL_GLM_LAYERS of its 24 layers
PARALLEL_STEPS = 3
PARALLEL_BATCH, PARALLEL_SEQ = 16, SEQ_LEN
# the CLI ranks: text_classify train on BERT-base widths cut to 2 layers (a
# config-only model dir, so from_pretrained's seeded init; its f32 dp=2
# checkpoint is 0.37 GB), on each mesh of PARALLEL_CLI_MESHES
PARALLEL_CLI_LAYERS = 2
PARALLEL_CLI_DIR = "bert-base-chinese-random-2-layers"
PARALLEL_CLI_MESHES = ("dp=2", "sp=2", "tp=2")
RING_BATCH, RING_SEQ = 8, 512           # two 256-token chunks
MOE_EXPERTS, MOE_CAPACITY, MOE_LAYERS = 8, 1.25, 2
MOE_BATCH, MOE_SEQ = 4, 128
PARALLEL_GLM_LAYERS = 2   # 6 until slice 16
PARALLEL_TIMEOUT = 300
PARALLEL_DEVICE = "cuda"    # both ranks on device 0 of this type
# Tolerances of the ranks' checks, all f32 but the bf16 ring:
# - a CLI training run on a mesh against the one-rank CLI run on the same
#   global batches (AdamW at a constant lr): each step's loss is the mean
#   of the ranks' means (1e-5, sums in another order), grad norms within
#   1e-4 relative, and the parameters' displacement from their initial
#   values, D = p - p0, within PARALLEL_STEP_RTOL of the one-rank run's,
#   relative over all parameters (L2). A rank that skipped or halved an
#   update would move D by all or half of one update U; the rank reads U
#   from a one-rank run stopped a step earlier and fails unless |U| / 2
#   is above the bound;
# - logits of a split model (tensor or expert axis) against the whole one:
#   the same products summed in another order through 12 (6, 2) layers of
#   f32: 1e-4; the MoE aux loss 1e-6;
# - the f32 ring against one rank's attention(): the flash kernels per hop
#   against the short kernels, f32 sums in another order: the f32 kernels'
#   bounds, 2e-5 forward and 2e-5 + 1e-5 |g| backward;
# - the bf16 ring against the f32 twins on the same (bf16) inputs: each
#   hop's kernel meets the one-call bound (FLASH_FWD_RSS_BF16 and
#   FLASH_BWD_RSS_BF16 beside their derivations), and the ring adds one
#   bf16 rounding of each hop's result before the f32 merge (at most 2^-8
#   of it). With the hops' RSS terms summing to at most sqrt(n) R
#   (Cauchy-Schwarz over n hops) and the hops' results summing in absolute
#   value to at most T = sum_j |x_j y_j| (sum_k P_k |v_k| forward):
#   forward 1e-5 + 2^-8 |o| + 2^-8 T + 2.5 x 2^-8 sqrt(n) R; backward
#   n 1e-5 + 2^-8 T + 2.5 x 2^-8 sqrt(n) R.
PARALLEL_LOSS_ATOL, PARALLEL_GNORM_RTOL = 1e-5, 1e-4
PARALLEL_STEP_RTOL = 1e-3
PARALLEL_LOGITS_ATOL, PARALLEL_AUX_ATOL = 1e-4, 1e-6


def _parallel_bert(torch, seed, config, device):
    """SequenceClassification on BERT-base widths from the seed."""
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification, SequenceClassificationModule)
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    cfg = BertConfig(**config)
    module = SequenceClassificationModule(cfg, num_labels=2, device=device)
    module.init_weights(torch.Generator(device=device).manual_seed(seed))
    return SequenceClassification(module, cfg, device)


def _parallel_cli_data(workdir, seed):
    """The CLI ranks' files under workdir/parallel: the config-only
    BERT-base dir at PARALLEL_CLI_LAYERS layers (dropout off, so runs
    compare step by step), one.tsv (PARALLEL_STEPS global batches of BATCH
    rows of train.tsv), dp.tsv (the same rows placed so that two data
    ranks, each reading every second row and shuffling its half, step on
    one.tsv's global batches in one.tsv's order) and dev.tsv (N_DEV_ROWS
    further rows). Returns the directory."""
    import shutil
    import numpy as np
    d = os.path.join(workdir, "parallel")
    cut = os.path.join(d, PARALLEL_CLI_DIR)
    os.makedirs(cut)
    with open(os.path.join(cut, "config.json"), "w") as f:
        json.dump(dict(BERT_BASE_CHINESE,
                       num_hidden_layers=PARALLEL_CLI_LAYERS,
                       hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0), f, indent=2)
    for name in ("vocab.txt", "label_mapping.json"):
        shutil.copy(os.path.join(workdir, MODEL_DIR, name), cut)
    with open(os.path.join(workdir, "train.tsv"), encoding="utf-8") as f:
        lines = f.read().splitlines(True)
    n, per = PARALLEL_STEPS * BATCH, BATCH // 2
    rows, dev = lines[:n], lines[n:n + N_DEV_ROWS]

    def order(k):
        # the Trainer's DataLoader: epoch 0's order of k rows
        o = np.arange(k)
        np.random.RandomState(seed).shuffle(o)
        return o
    whole, half = order(n), order(n // 2)
    placed = [None] * n
    for t in range(PARALLEL_STEPS):
        for j in range(per):
            i = half[t * per + j]
            placed[2 * i] = rows[whole[t * BATCH + j]]
            placed[2 * i + 1] = rows[whole[t * BATCH + per + j]]
    for name, part in (("one.tsv", rows), ("dp.tsv", placed),
                       ("dev.tsv", dev)):
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            f.writelines(part)
    return d


def _parallel_cli_argv(d, tables, device, seed):
    """text_classify train flags of the CLI ranks' runs on d's files."""
    return ["--mode=train", "--app_name=text_classify",
            "--pretrained_model_name_or_path=" + os.path.join(
                d, PARALLEL_CLI_DIR),
            "--tables=" + ",".join(os.path.join(d, t) for t in tables),
            "--input_schema=id:str:1,sentence:str:1,label:str:1",
            "--first_sequence=sentence", "--label_name=label",
            "--sequence_length=%d" % SEQ_LEN,
            "--micro_batch_size=%d" % BATCH, "--dtype=float32",
            "--device=" + device, "--use_flash_attention=auto",
            "--optimizer_type=AdamW", "--learning_rate=%g" % LEARNING_RATE,
            "--lr_scheduler=constant", "--logging_steps=1",
            "--random_seed=%d" % seed, "--epoch_num=1"]


def _max_abs(torch, a, b):
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


# phase 22 (f), run by phase 20's ranks on their process group: the CLI's
# text_classify at PARALLEL_CLI_LAYERS layers with --remat=full and
# Adafactor together at dp=2 and tp=2, each alone at tp=2 (Adafactor at
# its lr, --remat=full under phase 20's AdamW), and LoRA at tp=2 trained
# PARALLEL_STEPS - 1 steps, saved (the one checkpoint), resumed for the
# last step and deleted. Each run meets phase 20's bounds against the
# one-rank run of its flags: losses P22_LOSS_RTOL (relative), the
# gradient norms PARALLEL_GNORM_RTOL and the weights' displacement
# PARALLEL_STEP_RTOL; under Adafactor the gradient norms after the first
# step meet P22_ADAFACTOR_GNORM_RTOL. Adafactor divides each gradient
# element by its row's and column's rms, so a row or column whose
# gradient is tiny (a unit whose activation saturates) takes a full step
# that carries the f32 rounding of its elements, which differs between
# two summation orders (a row-parallel layer's all-reduce against one
# process's sum): from identical gradient norms at the first step (6.4e-8
# apart) the tp=2 run's norms moved 3.5e-4 and 1.25e-3 from one rank's at
# steps 2 and 3 with the losses within 1e-6 (NVIDIA H100 80GB HBM3,
# 700.00 W; the dp=2 run 6.1e-6, AdamW's tp=2 run 1.3e-7)
P22_ADAFACTOR_GNORM_RTOL = 1e-2
P22_F_ADAFACTOR = ("--optimizer_type=Adafactor", "--learning_rate=1e-3")
P22_F_RUNS = (("--remat=full Adafactor",
               ("--remat=full",) + P22_F_ADAFACTOR, ("dp=2", "tp=2")),
              ("Adafactor", P22_F_ADAFACTOR, ("tp=2",)),
              ("--remat=full AdamW", ("--remat=full",), ("tp=2",)))
P22_F_LORA = ("--user_defined_parameters=" + LORA_UDP,
              "--learning_rate=1e-3")


def _p22_f(torch, rank, workdir, argv, cli, params, norm, check, count,
           dev):
    """Phase 22 (f) on phase 20's ranks (phase_parallel_rank's helpers):
    each run of P22_F_RUNS against this rank's own one-rank run of the
    same flags, losses within P22_LOSS_RTOL, the gradient norms within
    PARALLEL_GNORM_RTOL (after the first step under Adafactor,
    P22_ADAFACTOR_GNORM_RTOL) and the weights' displacement from their
    initial values within PARALLEL_STEP_RTOL (relative); LoRA's resumed
    last step against the one-rank run's third, losses and gradient norms
    as above."""
    import shutil
    import torch.distributed as dist
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.parallel import mesh as M

    def group_flags(spec):
        return ["--mesh=" + spec, "--num_processes=2",
                "--process_index=%d" % rank,
                "--coordinator_address=file://" + os.path.join(workdir,
                                                               "rdzv"),
                "--dist_backend=gloo"]

    def records(tr):
        return ([r["loss"] for r in tr.step_records],
                [r["grad_norm"] for r in tr.step_records])

    def close(tag, losses, gnorms, want, rel=None):
        dl = max(abs(a - b) / abs(b) for a, b in zip(losses, want[0]))
        dgs = [abs(a - b) / b for a, b in zip(gnorms, want[1])]
        dg = max(dgs)
        later = (P22_ADAFACTOR_GNORM_RTOL if "Adafactor" in tag
                 else PARALLEL_GNORM_RTOL)
        ok = (len(losses) == len(want[0]) and dl <= P22_LOSS_RTOL
              and dgs[0] <= PARALLEL_GNORM_RTOL
              and max(dgs[1:]) <= later
              and (rel is None or rel <= PARALLEL_STEP_RTOL))
        extra = {} if rel is None else {"displacement_rdiff": rel}
        check("(f) rank %d %s" % (rank, tag), ok, losses=losses,
              one_rank_losses=want[0], grad_norms=gnorms,
              one_rank_grad_norms=want[1], max_loss_rdiff=dl,
              loss_bound=P22_LOSS_RTOL, grad_norm_rdiffs=dgs,
              max_grad_norm_rdiff=dg,
              grad_norm_bounds=[PARALLEL_GNORM_RTOL, later],
              displacement_bound=PARALLEL_STEP_RTOL, **extra)
        log("phase 22 (f) rank %d %s: ok %s, losses %s, one rank %s, "
            "grad norms %s, one rank %s (rdiff %.2e)%s" % (
                rank, tag, ok, losses, want[0], gnorms, want[1], dg,
                "" if rel is None else ", displacement rdiff %.3e" % rel))
    p0 = None
    for kind, flags, meshes in P22_F_RUNS:
        M.set_global_mesh(None)
        one = cli(argv(("one.tsv",)) + list(flags))
        want = records(one)
        ref = params(one.app.module)
        del one
        for spec in meshes:
            t0 = time.perf_counter()
            tables = ("dp.tsv" if spec.startswith("dp") else "one.tsv",)
            tr = count("(f) %s %s" % (kind, spec), lambda: cli(
                argv(tables) + list(flags) + group_flags(spec)))
            got = sharding.full_state(tr.app.module, M.get_global_mesh())
            if p0 is None:
                from easynlp_tpu_torch.appzoo.sequence_classification.model \
                    import SequenceClassification
                p0 = params(SequenceClassification.from_pretrained(
                    os.path.join(workdir, PARALLEL_CLI_DIR),
                    dtype=torch.float32, device=dev, num_labels=2).module)
            moved = norm({k: ref[k] - p0[k] for k in p0})
            rel = norm({k: got[k] - ref[k] for k in p0}) / moved
            close("%s --mesh=%s" % (kind, spec), *records(tr), want, rel)
            del tr, got
            dist.barrier()
            log("phase 22 (f) rank %d %s --mesh=%s: %.1f s" % (
                rank, kind, spec, time.perf_counter() - t0))
    # LoRA at tp=2: PARALLEL_STEPS - 1 steps and a save, then a resume
    t0 = time.perf_counter()
    M.set_global_mesh(None)
    one = cli(argv(("one.tsv",)) + list(P22_F_LORA))
    want = records(one)
    del one
    ckpt = os.path.join(workdir, "ckpt_p22_lora")
    first = count("(f) lora tp=2", lambda: cli(
        argv(("one.tsv",)) + list(P22_F_LORA) + group_flags("tp=2") + [
            "--epoch_num=%r" % ((PARALLEL_STEPS - 1) / PARALLEL_STEPS),
            "--checkpoint_dir=" + ckpt]))
    head = records(first)
    del first
    dist.barrier()
    tail = count("(f) lora tp=2 resumed", lambda: cli(
        argv(("one.tsv",)) + list(P22_F_LORA) + group_flags("tp=2") + [
            "--resume_from_checkpoint=" + ckpt]))
    rest = records(tail)
    del tail
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    close("LoRA --mesh=tp=2, saved after %d steps and resumed" % (
        PARALLEL_STEPS - 1), head[0] + rest[0], head[1] + rest[1], want)
    log("phase 22 (f) rank %d LoRA tp=2 with a save and a resume: %.1f s"
        % (rank, time.perf_counter() - t0))


def phase_parallel_rank(torch, seed, rank, workdir):
    """One of phase 20's two `gloo` ranks on cuda:0. (1) The CLI: the
    one-rank text_classify runs this rank holds the others to, then
    text_classify train through the CLI's entry points on each mesh of
    PARALLEL_CLI_MESHES over the two ranks (--num_processes,
    --process_index, a file:// --coordinator_address,
    --dist_backend=gloo), each checked against the one-rank run; dp=2
    writes its checkpoint (the master alone). (2) Op-level checks on the
    same process group: each builds its mesh over the two ranks, runs the
    split model, and rank 0 holds it to the whole model on one rank
    (computed on rank 0 with no mesh). Writes the results and this rank's
    launches (mesh runs only) as JSON."""
    import numpy as np
    import torch.distributed as dist
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification)
    from easynlp_tpu_torch.modelzoo.models.glm.modeling_glm import (
        GLMConfig, GLMForConditionalGeneration)
    from easynlp_tpu_torch.modelzoo.models.gpt2 import (GPT2Config,
                                                        GPT2LMHeadModel)
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.parallel import comm, sharding
    from easynlp_tpu_torch.parallel import mesh as M
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    dev = torch.device(PARALLEL_DEVICE, 0)
    device_flag = "cuda:0" if dev.type == "cuda" else dev.type
    if dev.type == "cuda":
        torch.cuda.set_device(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")
    launches = dict.fromkeys(wrappers, 0)
    out = {"checks": {}, "seconds": {}}

    def count(tag, fn):
        """fn() with every launch count 0 just before it, read after."""
        for w in wrappers:
            getattr(A, w).launches = 0
        try:
            return fn()
        finally:
            got = {w: getattr(A, w).launches for w in wrappers}
            for w in wrappers:
                launches[w] += got[w]
            out.setdefault("launches_by_check", {})[tag] = got

    def check(name, ok, **values):
        out["checks"][name] = dict(values, ok=bool(ok))

    # 1. the CLI. This rank's own one-rank runs first (no process group):
    # the initial weights (from_pretrained's seeded init), PARALLEL_STEPS
    # steps with the dev set's evaluation, and one step fewer for U
    t0 = time.perf_counter()
    def argv(tables):
        return _parallel_cli_argv(workdir, tables, device_flag, seed)

    def cli(args_list):
        trainer = default_main_fn(initialize_easynlp(args_list=args_list))
        sync()
        return trainer

    def params(module):
        return {n: p.detach().clone() for n, p in module.named_parameters()}
    p0 = params(SequenceClassification.from_pretrained(
        os.path.join(workdir, PARALLEL_CLI_DIR), dtype=torch.float32,
        device=dev, num_labels=2).module)
    one = cli(argv(("one.tsv", "dev.tsv")))
    ref = {"losses": [r["loss"] for r in one.step_records],
           "grad_norms": [r["grad_norm"] for r in one.step_records],
           "params": params(one.app.module)}
    out["one_rank_eval"] = one.evaluator.evaluate(one.app)
    del one
    short = cli(argv(("one.tsv",)) + ["--epoch_num=%r" % (
        (PARALLEL_STEPS - 1) / PARALLEL_STEPS)])
    before_last = params(short.app.module)
    del short

    def norm(d):
        return sum(float(t.double().square().sum()) for t in d.values()) \
            ** 0.5
    moved = norm({k: ref["params"][k] - p0[k] for k in p0})
    half_update = 0.5 * norm({k: ref["params"][k] - before_last[k]
                              for k in p0}) / moved
    del before_last
    out["seconds"]["one-rank CLI runs"] = time.perf_counter() - t0
    for spec in PARALLEL_CLI_MESHES:
        t0 = time.perf_counter()
        tables = ("dp.tsv" if spec.startswith("dp") else "one.tsv",
                  "dev.tsv")
        flags = argv(tables) + [
            "--mesh=" + spec, "--num_processes=2",
            "--process_index=%d" % rank,
            "--coordinator_address=file://" + os.path.join(workdir,
                                                           "rdzv"),
            "--dist_backend=gloo"]
        if spec.startswith("dp"):
            flags.append("--checkpoint_dir=" + os.path.join(workdir,
                                                            "ckpt_dp"))
        tr = count("CLI " + spec, lambda: cli(flags))
        got = sharding.full_state(tr.app.module, M.get_global_mesh())
        losses = [r["loss"] for r in tr.step_records]
        gnorms = [r["grad_norm"] for r in tr.step_records]
        dl = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
        dg = max(abs(a - b) / b for a, b in zip(gnorms, ref["grad_norms"]))
        rel = norm({k: got[k] - ref["params"][k] for k in p0}) / moved
        dp_max = max(float((got[k] - ref["params"][k]).abs().max())
                     for k in p0)
        check("rank %d CLI text_classify train --mesh=%s, %d f32 steps" % (
            rank, spec, PARALLEL_STEPS),
            len(losses) == PARALLEL_STEPS and dl <= PARALLEL_LOSS_ATOL
            and dg <= PARALLEL_GNORM_RTOL and rel <= PARALLEL_STEP_RTOL
            and half_update > PARALLEL_STEP_RTOL,
            losses=losses, one_rank_losses=ref["losses"],
            max_loss_diff=dl, max_grad_norm_rdiff=dg,
            displacement_rdiff=rel, bound=PARALLEL_STEP_RTOL,
            halved_last_update_rdiff=half_update,
            max_abs_param_diff=dp_max)
        del tr, got
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
        out["seconds"]["CLI " + spec] = time.perf_counter() - t0
    del ref, p0
    _p22_f(torch, rank, workdir, argv, cli, params, norm, check, count, dev)
    # the op-level checks below run on the CLI's process group
    M.set_global_mesh(None)

    def on_mesh(tag, axes, fn):
        """fn() on a mesh of `axes`; its launches counted from 0."""
        M.set_global_mesh(M.build_mesh(axes, dev.type))
        try:
            return count(tag, fn)
        finally:
            M.set_global_mesh(None)
            sync()
            dist.barrier()

    def alone(fn):
        """fn() on rank 0 with no mesh (the reference); rank 1 waits."""
        M.set_global_mesh(None)
        res = fn() if rank == 0 else None
        sync()
        dist.barrier()
        return res

    bert = dict(BERT_BASE_CHINESE, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    rng = np.random.RandomState(seed + 30)
    ids = torch.from_numpy(rng.randint(
        1000, bert["vocab_size"], (PARALLEL_BATCH, PARALLEL_SEQ))).to(dev)
    mask = torch.ones_like(ids, dtype=torch.int32)
    mask[1, PARALLEL_SEQ // 2:] = 0
    batch = {"input_ids": ids, "attention_mask": mask}

    # 2. BERT-base tensor-parallel logits
    t0 = time.perf_counter()
    inputs = {k: batch[k][:8] for k in ("input_ids", "attention_mask")}

    def logits(split):
        app = _parallel_bert(torch, seed, bert, dev)
        if split:
            sharding.parallelize(app.module, M.get_global_mesh())
        app.module.eval()
        with torch.no_grad():
            return app.module(**inputs)["logits"]
    want = alone(lambda: logits(False))
    got = on_mesh("BERT tensor=2", {"tensor": 2}, lambda: logits(True))
    if rank == 0:
        d = float((got - want).abs().max())
        check("BERT-base tensor=2 logits", d <= PARALLEL_LOGITS_ATOL,
              max_abs_diff=d, bound=PARALLEL_LOGITS_ATOL)
    out["seconds"]["tp logits"] = time.perf_counter() - t0

    # 3. ring attention over sequence=2 at 8 x 512, f32 and bf16
    t0 = time.perf_counter()
    h, d_head = bert["num_attention_heads"], \
        bert["hidden_size"] // bert["num_attention_heads"]
    g = torch.Generator().manual_seed(seed + 31)
    full = [torch.randn(RING_BATCH, RING_SEQ, h, d_head, generator=g)
            for _ in range(4)]
    kv_mask = torch.ones(RING_BATCH, RING_SEQ, dtype=torch.int32)
    kv_mask[1, 300:] = 0
    kv_mask[2, :] = 0       # a fully masked row (ROADMAP C1)
    chunk = RING_SEQ // 2
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dev, dtype) for t in full)
        part = slice(rank * chunk, (rank + 1) * chunk)
        mine = [t[:, part].clone().requires_grad_() for t in (q, k, v)]

        def ring():
            comm.reset_staged_bytes()
            o = A.attention(*mine, kv_mask=kv_mask[:, part].to(dev),
                            impl="ring")
            o.backward(do[:, part].contiguous())
            group = M.axis_group("sequence")
            return [comm.all_gather(t, group, 1) for t in
                    (o.detach(), mine[0].grad, mine[1].grad, mine[2].grad)]
        got = on_mesh("ring %s" % str(dtype).split(".")[1],
                      {"sequence": 2}, ring)
        out.setdefault("staged_bytes", {})[str(dtype)] = dict(
            comm.STAGED_BYTES)
        if rank == 0:
            m = kv_mask.to(dev)
            q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
            if dtype == torch.float32:
                qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
                o_ref = A.attention(qq, kk, vv, kv_mask=m)
                o_ref.backward(do)
                refs = [o_ref.detach(), qq.grad, kk.grad, vv.grad]
                bounds = [torch.full_like(refs[0], ATOL_F32)] + [
                    BWD_ATOL_F32 + BWD_RTOL_F32 * r.abs() for r in refs[1:]]
            else:
                o32, lse = A.flash_attention_fwd_reference(q32, k32, v32, m)
                grads = A.flash_attention_bwd_reference(q32, k32, v32, m,
                                                        o32, lse, do32)
                refs = [o32] + list(grads)
                rss = [A.flash_attention_fwd_rss(q32, k32, v32, m)] + list(
                    A.flash_attention_bwd_rss(q32, k32, v32, m, o32, lse,
                                              do32))
                terms = _ring_abs_terms(torch, A, q32, k32, v32, m, o32,
                                        lse, do32)
                sq2 = 2 ** 0.5
                bounds = [1e-5 + 2 ** -8 * refs[0].abs() + 2 ** -8 * terms[0]
                          + FLASH_FWD_RSS_BF16 * sq2 * rss[0]]
                bounds += [2e-5 + 2 ** -8 * t + FLASH_BWD_RSS_BF16 * sq2 * r
                           for t, r in zip(terms[1:], rss[1:])]
            ratio = max(float(((a.float() - b.float()).abs() / c).max())
                        for a, b, c in zip(got, refs, bounds))
            errs = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, refs)]
            masked_mean = float((got[0][2].float() - v32[2].mean(0)).abs()
                                .max())
            check("ring sequence=2 %d x %d %s" % (
                RING_BATCH, RING_SEQ, str(dtype).split(".")[1]),
                ratio <= 1.0 and masked_mean <= 1e-2,
                max_abs_err_o_dq_dk_dv=errs, worst_err_over_bound=ratio,
                masked_row_vs_mean_v=masked_mean)
    out["seconds"]["ring"] = time.perf_counter() - t0

    # 4. GPT-2-small-width Switch-MoE over expert=2
    t0 = time.perf_counter()
    moe_cfg = dict(GPT2_SMALL, n_layer=MOE_LAYERS, num_experts=MOE_EXPERTS,
                   moe_top_k=1, expert_capacity_factor=MOE_CAPACITY,
                   resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    moe_ids = torch.from_numpy(rng.randint(
        0, moe_cfg["vocab_size"], (MOE_BATCH, MOE_SEQ))).to(dev)

    def moe(split):
        model = GPT2LMHeadModel(GPT2Config(**moe_cfg), device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
        model.eval()
        rows = moe_ids
        if split:
            sharding.parallelize(model, M.get_global_mesh())
            a, b = M.batch_sharding(MOE_BATCH)
            rows = moe_ids[a:b]
        with torch.no_grad():
            o = model(rows)
        lg = o["logits"].float()
        if split:
            lg = comm.all_gather(lg, M.axis_group(M.BATCH_AXES))
        return lg, float(o["moe_aux_loss"])
    want = alone(lambda: moe(False))
    got = on_mesh("MoE expert=2", {"expert": 2}, lambda: moe(True))
    if rank == 0:
        d = float((got[0] - want[0]).abs().max())
        da = abs(got[1] - want[1])
        check("GPT-2-small MoE %d experts top-1 expert=2 logits, aux" %
              MOE_EXPERTS, d <= PARALLEL_LOGITS_ATOL
              and da <= PARALLEL_AUX_ATOL, max_abs_diff=d, aux=got[1],
              one_rank_aux=want[1], aux_diff=da)
    out["seconds"]["moe"] = time.perf_counter() - t0

    # 5. glm-large widths, PARALLEL_GLM_LAYERS layers, tensor=2 logits
    t0 = time.perf_counter()
    glm_cfg = dict(GLM_LARGE, num_layers=PARALLEL_GLM_LAYERS,
                   embedding_dropout_prob=0.0, attention_dropout_prob=0.0,
                   output_dropout_prob=0.0)
    glm_ids = torch.from_numpy(rng.randint(
        0, glm_cfg["vocab_size"], (2, 128))).to(dev)

    def glm(split):
        model = GLMForConditionalGeneration(GLMConfig(**glm_cfg),
                                            device=dev)
        model.init_weights(torch.Generator(device=dev).manual_seed(seed))
        if split:
            sharding.parallelize(model, M.get_global_mesh())
        model.eval()
        with torch.no_grad():
            return model(glm_ids, prefix_lengths=torch.tensor(
                [64, 100], device=dev))["logits"].float()
    want = alone(lambda: glm(False))
    got = on_mesh("GLM tensor=2", {"tensor": 2}, lambda: glm(True))
    if rank == 0:
        d = float((got - want).abs().max())
        check("glm-large %d layers tensor=2 logits" % PARALLEL_GLM_LAYERS,
              d <= PARALLEL_LOGITS_ATOL, max_abs_diff=d)
    out["seconds"]["glm"] = time.perf_counter() - t0
    out["launches"] = launches
    out["written_gib"] = _written_gib()
    with open(os.path.join(workdir, "rank%d.json" % rank), "w") as f:
        json.dump(out, f)
    M.destroy()


def _ring_abs_terms(torch, A, q, k, v, mask, o, lse, do):
    """T of the bf16 ring's bound: per element of o, dq, dk, dv the sum of
    the absolute values of the terms it sums (sum_k P_k |v_k|; dS and P
    against |k|, |q|, |dO|), f32 from the f32 twins' P and dS."""
    scale = 1.0 / q.shape[-1] ** 0.5
    p, ds = A._flash_bwd_p_ds(q, k, v, mask, o, lse, do, False, scale)
    pa, dsa = p.abs(), ds.abs()
    return (torch.einsum("bhqk,bkhd->bqhd", pa, v.abs()),
            torch.einsum("bhqk,bkhd->bqhd", dsa, k.abs()),
            torch.einsum("bhqk,bqhd->bkhd", dsa, q.abs()),
            torch.einsum("bhqk,bqhd->bkhd", pa, do.abs()))


def _fsdp_world_one(torch, seed):
    """FSDP2 on the card: BERT-base text classification with every layer
    and the module under fully_shard over the fsdp axis of the running
    one-rank NCCL group, against the same module unsplit: the f32 loss and
    every gradient equal (a reduce-scatter over one rank copies)."""
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        BertLayer)
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.parallel.mesh import build_mesh
    import numpy as np
    dev = torch.device("cuda", 0)
    bert = dict(BERT_BASE_CHINESE, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    rng = np.random.RandomState(seed + 32)
    ids = torch.from_numpy(rng.randint(1000, bert["vocab_size"], (
        PARALLEL_BATCH, PARALLEL_SEQ))).to(dev)
    labels = torch.from_numpy(rng.randint(0, 2, (PARALLEL_BATCH,))).to(dev)
    mesh = build_mesh({"fsdp": 1}, "cuda")
    results = []
    for split in (False, True):
        app = _parallel_bert(torch, seed, bert, dev)
        if split:
            sharding.apply_fsdp(app.module, mesh, (BertLayer,))
        loss = app.loss_fn(app.module(input_ids=ids), {
            "label_ids": labels})["loss"]
        loss.backward()
        grads = {n: p.grad.full_tensor() if split else p.grad
                 for n, p in app.module.named_parameters()}
        results.append((float(loss), grads))
        del app
    (l0, g0), (l1, g1) = results
    dg = max(float((g0[k] - g1[k]).abs().max()) for k in g0)
    log("phase 20 (a) FSDP2 fully_shard at world 1 (NCCL), BERT-base f32 "
        "forward and backward of %d x %d: loss %.6f vs %.6f unsplit, max "
        "|gradient difference| %.3e" % (PARALLEL_BATCH, PARALLEL_SEQ, l1, l0,
                                        dg))
    if l0 != l1 or dg > 0:
        raise AssertionError("FSDP2 at world 1 changed the loss or the "
                             "gradients")


def _parallel_evaluate(torch, d, device):
    """--mode=evaluate of the dp=2 run's checkpoint in one process (no
    process group) on d's dev.tsv: the metrics, and the checkpoint's step
    count."""
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    ckpt = os.path.join(d, "ckpt_dp")
    with open(os.path.join(ckpt, "meta.json")) as f:
        step = json.load(f)["global_step"]
    results = default_main_fn(initialize_easynlp(args_list=[
        "--mode=evaluate", "--app_name=text_classify",
        "--tables=" + os.path.join(d, "dev.tsv"), "--checkpoint_dir=" + ckpt,
        "--input_schema=id:str:1,sentence:str:1,label:str:1",
        "--first_sequence=sentence", "--label_name=label",
        "--sequence_length=%d" % SEQ_LEN, "--micro_batch_size=%d" % BATCH,
        "--dtype=float32", "--device=" + device,
        "--use_flash_attention=auto"]))
    return [list(r) for r in results], step


def phase_parallel(torch, seed, workdir):
    """Phase 20: (a) BERT-base text_classify through the CLI with
    --mesh=dp=1 (an NCCL group of one rank) and without, 3 bf16 steps
    each, losses and weights bit for bit, and FSDP2 on BERT-base at world 1
    (_fsdp_world_one); (b) two `gloo` ranks on cuda:0
    (phase_parallel_rank): text_classify train through the CLI on
    --mesh=dp=2, sp=2 and tp=2 at BERT-base widths, each against one
    rank's run, then a one-process --mode=evaluate of the dp=2 checkpoint
    against the one-rank run's evaluation; BERT-base tensor=2 logits, the
    ring over sequence=2 at 8 x 512 in f32 and bf16 forward and backward,
    GPT-2-small-width Switch-MoE over expert=2 and glm-large at 6 layers
    over tensor=2, each against one rank. Returns the kernel launches of
    the mesh runs and the evaluate by kernel."""
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.parallel.mesh import destroy
    log("== phase 20: multi-GPU (torch.distributed): NCCL at world 1; two "
        "gloo ranks on cuda:0 through the CLI (dp=2, sp=2, tp=2) and at the "
        "op level (tp logits, ring sp, MoE ep, GLM tp); FSDP2 at world 1")
    t_phase = time.perf_counter()
    wrappers = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")
    main_path, _, total = _launch_counter(A, wrappers)
    model_dir = os.path.join(workdir, MODEL_DIR)
    train_tsv = os.path.join(workdir, "train.tsv")
    # (b)'s ranks start first and run beside (a): their times are the
    # ranks' own, and their start (importing torch, reaching the card)
    # overlaps (a)
    d = _parallel_cli_data(workdir, seed)
    env = dict(os.environ, OMP_NUM_THREADS="4")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--parallel-rank", str(r), "--parallel-dir", d], env=env,
        stdout=open(os.path.join(d, "rank%d.log" % r), "w"),
        stderr=subprocess.STDOUT) for r in range(2)]
    deadline = time.monotonic() + PARALLEL_TIMEOUT
    try:
        runs = {}
        for tag, extra in (("no mesh", []),
                           ("--mesh=dp=1", ["--mesh=dp=1"])):
            runs[tag] = main_path("phase 20 train %s" % tag,
                                  lambda: run_train(
                torch, model_dir, train_tsv, None, None, True, seed,
                common=_common_argv(True) + [
                    "--epoch_num=%g" % (PARALLEL_STEPS * BATCH / N_ROWS)]
                + extra, keep_trainer=True))
        _fsdp_world_one(torch, seed)
        destroy()
        a, b = runs["no mesh"], runs["--mesh=dp=1"]
        la = [r["loss"] for r in a["records"]]
        lb = [r["loss"] for r in b["records"]]
        pa = dict(a["trainer"].app.module.named_parameters())
        pb = dict(b["trainer"].app.module.named_parameters())
        same = la == lb and all(torch.equal(pa[k], pb[k]) for k in pa)
        log("phase 20 (a) %d bf16 steps with and without --mesh=dp=1 "
            "(NCCL, world 1): losses %s; weights and losses bit for bit: "
            "%s" % (len(la), " ".join("%.5f" % x for x in lb), same))
        if not same:
            raise AssertionError("--mesh=dp=1 changed the training run")
        del runs, a, b, pa, pb
        torch.cuda.empty_cache()
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(os.path.join(d, "rank%d.log" % r)) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError("phase 20 rank %d exited %s:\n%s" % (
                r, p.returncode, text[-4000:]))
    results = []
    for r in range(2):
        with open(os.path.join(d, "rank%d.json" % r)) as f:
            results.append(json.load(f))
    failed = []
    for res in results:
        for name, c in res["checks"].items():
            log("phase 20 (b) %s: %s" % (name, json.dumps(c)))
            if not c["ok"]:
                failed.append(name)
    for r, res in enumerate(results):
        log("phase 20 (b) rank %d: launches (mesh runs) %s by check %s; "
            "bytes staged through host memory under gloo (ring_shift, each "
            "way) %s; seconds %s; wchar (files, pipes and gloo's "
            "sockets) %s GiB" % (
                r, res["launches"], res["launches_by_check"],
                res["staged_bytes"], {k: round(v, 1) for k, v in
                                      res["seconds"].items()},
                res["written_gib"]))
        for w in wrappers:
            total[w] += res["launches"][w]
    for res in results:
        by = res["launches_by_check"]
        for dtype in ("float32", "bfloat16"):
            ring = by["ring " + dtype]
            if ring["flash_attention_fwd"] != 2 \
                    or ring["flash_attention_bwd"] != 2:
                failed.append("a rank's %s ring launched %s, want B3 and "
                              "B4/B5 twice (one a hop)" % (dtype, ring))
        # dp and tp attend by B1/B2 over whole sequences, sp by the ring's
        # B3 and B4/B5 over 64-token chunks
        for spec in PARALLEL_CLI_MESHES:
            got = by["CLI " + spec]
            ring = spec.startswith("sp")
            want = {"short_attention_fwd": not ring,
                    "short_attention_bwd": not ring,
                    "flash_attention_fwd": ring,
                    "flash_attention_bwd": ring}
            if any(bool(got[w]) != want[w] for w in wrappers):
                failed.append("a rank's CLI run on --mesh=%s launched %s"
                              % (spec, got))
    evaluated, step = main_path(
        "phase 20 (b) one-process evaluate of the dp=2 checkpoint",
        lambda: _parallel_evaluate(torch, d, "cuda"))
    want = results[0]["one_rank_eval"]
    worst = max(abs(a[1] - b[1]) for a, b in zip(evaluated, want))
    ckpt = os.path.join(d, "ckpt_dp")
    log("phase 20 (b) --mode=evaluate of the checkpoint two CLI ranks "
        "wrote on --mesh=dp=2 (global_step %d, %.3f GB of files), one "
        "process: %s; the one-rank run's evaluation %s; max difference "
        "%.3e" % (step, sum(os.path.getsize(os.path.join(ckpt, f))
                            for f in os.listdir(ckpt)) / 1e9,
                  evaluated, want, worst))
    if step != PARALLEL_STEPS or [a[0] for a in evaluated] \
            != [b[0] for b in want] or worst > 1e-6:
        failed.append("the dp=2 checkpoint evaluates to %s at step %d, the "
                      "one-rank run to %s" % (evaluated, step, want))
    if failed:
        raise AssertionError("phase 20 failed: %s" % failed)
    log("phase 20 seconds %.1f; launches of the mesh runs %s" % (
        time.perf_counter() - t_phase, total))
    total["flash_attention_bwd_dkdv"] = total["flash_attention_bwd"]
    total["flash_attention_bwd_dq"] = total["flash_attention_bwd"]
    return total


# --------------------------------------------------------------------------
# phase 21: GPT-2 under a tensor mesh (generation and serving)
# --------------------------------------------------------------------------

# GPT-2 small at full width and depth, f32, random weights from the seed;
# two gloo ranks on cuda:0 at tensor=2 (NCCL refuses two ranks on one
# device), each holding 6 of the 12 heads and half of every projection and
# of the (padded) vocabulary
TP_PROMPTS, TP_NEW_TOKENS = 8, 64
TP_PROMPT_LENGTHS = (64, 256)        # (a)'s prompts, left-padded to 256
TP_BEAMS = 4
TP_SPEC_DRAFTS, TP_SPEC_NGRAM, TP_SPEC_NEW_TOKENS = 8, 2, 32
TP_SERVE_NEW_TOKENS = (8, 24)        # (c)'s and (d)'s budgets
TP_DECODER_REQUESTS = 12             # (c): more requests than slots
TP_SLOTS, TP_CHUNK, TP_WINDOW, TP_BUCKET = 8, 16, 1024, 256
TP_SERVER_REQUESTS = 8               # (d): 4 greedy, 4 sampled
TP_TIMEOUT = 300
# the largest f32 logit difference a rank may show against one process
# (the row-parallel sums run in another order; 4.4e-6 read on an H100):
# above it the split is wrong, whatever tokens the rows give
TP_LOGITS_ATOL = 1e-4
TP_DEVICE = "cuda"    # both ranks on device 0 of this type


def _tp_inputs(seed):
    """The phase's requests from the seed (host lists): (a)'s prompts of
    64-256 tokens; (b)'s, phrases of 8-24 tokens repeated to 64-128
    tokens, so prompt lookup finds drafts; (c)'s 12 and (d)'s 8 requests
    for 8-24 tokens, every third (c) row and (d)'s last four sampled with
    seeds."""
    rng = random.Random(seed + 21)
    top = GPT2_SMALL["vocab_size"] - 1

    def prompt(lo, hi):
        return [rng.randrange(256, top) for _ in range(rng.randint(lo, hi))]
    spec = []
    for _ in range(TP_PROMPTS):
        phrase = prompt(8, 24)
        n = rng.randint(64, 128)
        spec.append((phrase * (n // len(phrase) + 1))[:n])

    def requests(n, sampled):
        return [dict(prompt_ids=prompt(16, TP_BUCKET),
                     max_new_tokens=rng.randint(*TP_SERVE_NEW_TOKENS),
                     do_sample=sampled(i), temperature=0.8, top_k=40,
                     top_p=0.95, seed=seed + i) for i in range(n)]
    return {"prompts": [prompt(*TP_PROMPT_LENGTHS)
                        for _ in range(TP_PROMPTS)],
            "spec": spec,
            "decoder": requests(TP_DECODER_REQUESTS, lambda i: i % 3 == 2),
            "server": requests(TP_SERVER_REQUESTS,
                               lambda i: i >= TP_SERVER_REQUESTS // 2)}


def _tp_model(torch, seed, device):
    """GPT-2 small, f32, dropout off, weights from the seed on `device`
    (the same bits in every process)."""
    from easynlp_tpu_torch.modelzoo.models.gpt2 import (GPT2Config,
                                                        GPT2LMHeadModel)
    cfg = GPT2Config(**dict(GPT2_SMALL, resid_pdrop=0.0, embd_pdrop=0.0,
                            attn_pdrop=0.0))
    model = GPT2LMHeadModel(cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.eval()


def _tp_workload(torch, model, inputs):
    """(a)-(d) on `model` (split over the running mesh, or whole), through
    the entry points a user calls: generate() greedy and with 4 beams;
    generate() speculative (prompt lookup, K 8, n-gram 2) and plain
    greedy for 32 tokens on the repeating prompts; DeviceContinuousDecoder
    over (c)'s
    12 requests; the /generate server (serve_tensor_parallel: the lead
    listens, another rank follows) over a ContinuousBatcher, (d)'s 8
    requests from 8 client threads. Returns the tokens by part, the
    prefill's last-position logits, ms per output token and each part's
    launches (B1 short forward, B3 flash forward), counted from 0."""
    import threading
    from easynlp_tpu_torch.modelzoo.generation_utils import (generate,
                                                             left_pad)
    from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns)
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.serving import (ContinuousBatcher,
                                           DeviceContinuousDecoder,
                                           serve_tensor_parallel)
    dev = model.transformer.wte.weight.device
    wrappers = ("short_attention_fwd", "flash_attention_fwd")
    out = {"tokens": {}, "ms_per_token": {}, "launches": {}}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def part(name, fn, n_tokens):
        for w in wrappers:
            getattr(A, w).launches = 0
        sync()
        t0 = time.perf_counter()
        tokens = fn()
        sync()
        seconds = time.perf_counter() - t0
        out["launches"][name] = {w: getattr(A, w).launches
                                 for w in wrappers}
        if tokens is not None:
            out["tokens"][name] = tokens
            out["ms_per_token"][name] = 1e3 * seconds / max(n_tokens(
                tokens), 1)

    def batch(prompts):
        ids, mask = left_pad(prompts, pad_token_id=0)
        return (torch.from_numpy(ids).to(dev, torch.long),
                torch.from_numpy(mask).to(dev), ids.shape[1])

    def rows(seqs, p):
        return seqs[:, p:].cpu().tolist()

    def count_rows(tokens):
        return sum(len(t) for t in tokens)

    ids, mask, p = batch(inputs["prompts"])
    total = p + TP_NEW_TOKENS
    prefill, decode = make_gpt2_generation_fns(model, total)
    with torch.inference_mode():
        greedy = []
        part("a greedy", lambda: rows(greedy.append(generate(
            prefill, decode, ids, mask, max_length=total,
            pad_token_id=0)) or greedy[0], p), count_rows)
        # the logits the two runs are held to: the prefill's last position
        # and, teacher-forced over (a)'s greedy output, every 8th new one
        hidden = model.transformer(greedy[0], attention_mask=torch.cat(
            [mask, torch.ones_like(greedy[0][:, p:], dtype=mask.dtype)],
            1))["last_hidden_state"]
        out["logits"] = torch.cat([
            prefill(ids, mask)[0][:, None],
            model.logits(hidden[:, p::8]).float()], 1).cpu()
        part("a beam", lambda: rows(generate(
            prefill, decode, ids, mask, max_length=total, pad_token_id=0,
            num_beams=TP_BEAMS), p), count_rows)
        sids, smask, sp = batch(inputs["spec"])
        stotal = sp + TP_SPEC_NEW_TOKENS
        sprefill, sdecode = make_gpt2_generation_fns(
            model, stotal, cache_slack=TP_SPEC_DRAFTS + 1)
        part("b speculative", lambda: rows(generate(
            sprefill, sdecode, sids, smask, max_length=stotal,
            pad_token_id=0, speculative="prompt_lookup",
            num_draft_tokens=TP_SPEC_DRAFTS, ngram_size=TP_SPEC_NGRAM), sp),
            count_rows)
        part("b greedy", lambda: rows(generate(
            sprefill, sdecode, sids, smask, max_length=stotal,
            pad_token_id=0), sp), count_rows)
    reqs = inputs["decoder"]
    dec = DeviceContinuousDecoder(model, max_slots=TP_SLOTS,
                                  max_length=TP_WINDOW,
                                  prompt_bucket=TP_BUCKET, pad_token_id=0,
                                  chunk_size=TP_CHUNK)
    keys = ("max_new_tokens", "do_sample", "temperature", "top_k", "top_p",
            "seed")
    part("c decoder", lambda: dec([r["prompt_ids"] for r in reqs], **{
        k: [r[k] for r in reqs] for k in keys}), count_rows)
    batcher = ContinuousBatcher(model, max_slots=TP_SLOTS,
                                max_length=TP_WINDOW,
                                prompt_buckets=(TP_BUCKET,), pad_token_id=0,
                                chunk_size=TP_CHUNK)

    def serve():
        server = serve_tensor_parallel(batcher, host="127.0.0.1", port=0)
        if server is None:   # a follower: it replayed the lead's plans
            return None
        got = [None] * len(inputs["server"])

        def client(i):
            got[i] = _post_generate(server.port, inputs["server"][i])
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(got))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        server.stop()
        bad = [g for g in got if g["status"] != 200]
        if bad:
            raise AssertionError("phase 21 (d) /generate failed: %s" % bad)
        return [g["ids"] for g in got]
    part("d /generate", serve, count_rows)
    out["plan_bytes"] = batcher.plan_bytes
    return out


def phase_tp_rank(torch, seed, rank, workdir):
    """One of phase 21's processes on cuda:0. Rank -1 is the one-process
    run: the whole model, the workload, its results in
    workdir/tp_one.pt. Ranks 0 and 1 are the gloo ranks: the process group
    and the tensor=2 mesh from the port's flags (initialize_easynlp with
    --mesh=tp=2, --num_processes, --process_index, a file://
    --coordinator_address, --dist_backend=gloo), parallelize, then, once
    the one-process run has written its results, the workload; each
    writes its results and the bytes staged through host memory to
    workdir/tp_rank<r>.pt."""
    from easynlp_tpu_torch.parallel import comm, sharding
    from easynlp_tpu_torch.parallel import mesh as M
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    device = "cuda:0" if TP_DEVICE == "cuda" else TP_DEVICE
    if rank < 0:
        args = initialize_easynlp(args_list=["--device=" + device])
        out = _tp_workload(torch, _tp_model(torch, seed, args.device),
                           _tp_inputs(seed))
        torch.save(out, os.path.join(workdir, "tp_one.tmp"))
        os.replace(os.path.join(workdir, "tp_one.tmp"),
                   os.path.join(workdir, "tp_one.pt"))
        return
    args = initialize_easynlp(args_list=[
        "--mesh=tp=2", "--num_processes=2", "--process_index=%d" % rank,
        "--coordinator_address=file://" + os.path.join(workdir, "rdzv21"),
        "--dist_backend=gloo", "--device=" + device])
    model = sharding.parallelize(_tp_model(torch, seed, args.device),
                                 M.get_global_mesh())
    go = os.path.join(workdir, "tp_one.pt")
    deadline = time.monotonic() + TP_TIMEOUT
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError("phase 21 rank %d: the one-process run "
                               "wrote nothing in %d s" % (rank, TP_TIMEOUT))
        time.sleep(0.1)
    comm.reset_staged_bytes()
    out = _tp_workload(torch, model, _tp_inputs(seed))
    out["staged_bytes"] = dict(comm.STAGED_BYTES)
    out["heads"] = model.cache_heads()
    torch.save(out, os.path.join(workdir, "tp_rank%d.pt" % rank))
    M.destroy()


def _tp_departure(torch, whole, prompt, want, got, request=None):
    """None where the token lists agree; else (the departing step, the
    one-process model's (whole()) top-2 margin there). For a sampled
    request the margin is that of its Gumbel-perturbed warped logits (the
    draw rowwise_warp_and_sample makes at that position)."""
    from easynlp_tpu_torch.modelzoo.generation_utils import (
        counter_uniform, rowwise_warp)
    if want == got:
        return None
    j = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    model = whole()
    with torch.inference_mode():
        dev = model.transformer.wte.weight.device
        ids = torch.tensor([list(prompt) + list(want[:j])], device=dev)
        logits = model(ids)["logits"][:, -1].float()
        if request is not None and request.get("do_sample"):
            def one(x, dtype):
                return torch.tensor([x], dtype=dtype, device=dev)
            logits = rowwise_warp(
                logits, one(request["temperature"], torch.float32),
                one(request["top_k"], torch.long),
                one(request["top_p"], torch.float32)) - torch.log(
                -torch.log(counter_uniform(
                    one(request["seed"], torch.long),
                    one(j, torch.long), logits.shape[-1])))
        top2 = logits[0].topk(2).values
    return j, (top2[0] - top2[1]).item()


def start_tp_ranks(seed, workdir):
    """Start phase 21's processes (phase_tp_rank) under workdir/tp21: the
    two ranks, which start their group, build and split the model and go
    once the one-process run (rank -1) has written its results. Started
    two phases early, all three run beside phases 19 and 20 (their times
    with them).
    Returns ([rank 0, rank 1, the one-process run], their directory)."""
    d = os.path.join(workdir, "tp21")
    os.makedirs(d)
    env = dict(os.environ, OMP_NUM_THREADS="4")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--tp-rank=%d" % r, "--tp-dir", d], env=env,
        stdout=open(os.path.join(d, "rank%d.log" % r), "w"),
        stderr=subprocess.STDOUT) for r in (0, 1, -1)]
    return procs, d


def phase_tp(torch, seed, workdir, ranks=None):
    """Phase 21: GPT-2 small (12 layers, 768 wide, 12 heads, 50257
    tokens) on two gloo ranks on cuda:0 at tensor=2 (phase_tp_rank),
    against the same weights in one process on the card (rank -1, which
    runs while the ranks start; they go when it is done): (a)
    generate() greedy and 4-beam over 8 prompts of 64-256 tokens, 64 new
    tokens; (b) speculative greedy (K 8, n-gram 2) on repeating prompts,
    against plain greedy and one process; (c) DeviceContinuousDecoder,
    12 requests in 8 slots over the 1024-slot window, greedy and seeded
    sampled rows; (d) /generate on rank 0 over the tensor group's
    ContinuousBatcher (rank 1 follows), 4 greedy and 4 sampled requests.
    Tokens must equal one process's on every rank; where a row departs,
    the departing step's top-2 margin (one process's model) must be below
    the largest logit difference between the runs (the prefill's and
    (a)'s greedy rows' teacher-forced logits). `ranks`: start_tp_ranks'
    processes where the caller started them earlier. Returns the ranks'
    B1/B3 launches (all four wrappers' keys)."""
    from easynlp_tpu_torch.ops import attention as A
    log("== phase 21: GPT-2 small under tensor=2 (two gloo ranks on "
        "cuda:0): generate greedy/beam, speculative, the device decoder, "
        "/generate; each against one process")
    t_phase = time.perf_counter()
    procs, d = ranks or start_tp_ranks(seed, workdir)
    deadline = time.monotonic() + TP_TIMEOUT
    inputs = _tp_inputs(seed)
    try:
        # the ranks go once the one-process run has written its results
        procs[2].wait(timeout=max(1.0, deadline - time.monotonic()))
        if procs[2].returncode == 0:
            for p in procs[:2]:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in zip((0, 1, -1), procs):
        with open(os.path.join(d, "rank%d.log" % r)) as f:
            text = f.read()
        if p.returncode != 0:
            raise AssertionError("phase 21 rank %d exited %s:\n%s" % (
                r, p.returncode, text[-4000:]))
    one = torch.load(os.path.join(d, "tp_one.pt"), weights_only=False)
    ranks = [torch.load(os.path.join(d, "tp_rank%d.pt" % r),
                        weights_only=False) for r in range(2)]
    model = []   # the one-process model, built where a row departs

    def whole():
        if not model:
            model.append(_tp_model(torch, seed, torch.device(TP_DEVICE, 0)))
        return model[0]
    diff = max(float((rk["logits"] - one["logits"]).abs().max())
               for rk in ranks)
    log("phase 21 heads a rank %s; largest logit difference against one "
        "process (f32, %s: the prefill's last position and every 8th "
        "position of (a)'s greedy rows, teacher-forced) %.3e" % (
            ranks[0]["heads"], "x".join(map(str, one["logits"].shape)),
            diff))
    log("phase 21 logit bound %.0e (f32)" % TP_LOGITS_ATOL)
    failed = []
    if not diff <= TP_LOGITS_ATOL:
        failed.append("largest logit difference %.3e > %.0e" % (
            diff, TP_LOGITS_ATOL))
    prompts = {"a greedy": inputs["prompts"], "a beam": inputs["prompts"],
               "b speculative": inputs["spec"], "b greedy": inputs["spec"],
               "c decoder": [r["prompt_ids"] for r in inputs["decoder"]],
               "d /generate": [r["prompt_ids"] for r in inputs["server"]]}
    requests = {"c decoder": inputs["decoder"],
                "d /generate": inputs["server"]}
    for name, want in one["tokens"].items():
        got = ranks[0]["tokens"][name]
        if name != "d /generate" and ranks[1]["tokens"][name] != got:
            failed.append("%s: the ranks returned different tokens" % name)
        departures = []
        for i, (w, g) in enumerate(zip(want, got)):
            req = requests.get(name, [None] * len(want))[i]
            dep = _tp_departure(torch, whole, prompts[name][i], w, g, req)
            if dep is not None:
                departures.append((i,) + dep)
                if dep[1] >= min(diff, TP_LOGITS_ATOL):
                    failed.append("%s row %d departs at step %d with a "
                                  "top-2 margin %.3e >= %.3e" % (
                                      name, i, dep[0], dep[1], diff))
        log("phase 21 %-14s tensor=2 vs one process: %d of %d rows equal "
            "token for token%s; ms per output token %.3f (one process "
            "%.3f, run beside the ranks' start; both beside phases 19-20 in the "
            "whole run); launches a rank %s" % (
                name, len(want) - len(departures), len(want),
                "".join("; row %d departs at step %d (margin %.3e)" % dep
                        for dep in departures),
                ranks[0]["ms_per_token"][name], one["ms_per_token"][name],
                [rk["launches"][name] for rk in ranks]))
    spec, greedy = one["tokens"]["b speculative"], one["tokens"]["b greedy"]
    if spec != greedy:
        failed.append("(b) speculative != greedy in one process")
    if ranks[0]["plan_bytes"] != ranks[1]["plan_bytes"] \
            or not ranks[0]["plan_bytes"]:
        failed.append("(d) plan bytes %s" % [rk["plan_bytes"]
                                            for rk in ranks])
    total = dict.fromkeys(("short_attention_fwd", "short_attention_bwd",
                           "flash_attention_fwd", "flash_attention_bwd"), 0)
    for r, rk in enumerate(ranks):
        got = {w: sum(v[w] for v in rk["launches"].values())
               for w in ("short_attention_fwd", "flash_attention_fwd")}
        for w, n in got.items():
            total[w] += n
        if not all(got.values()):
            failed.append("rank %d launched %s: want B1 and B3" % (r, got))
        log("phase 21 rank %d: B1/B3 launches %s; bytes staged through "
            "host memory (gloo copies CUDA tensors; each way) %s, plans "
            "%d" % (r, got, rk["staged_bytes"], rk["plan_bytes"]))
    if failed:
        raise AssertionError("phase 21 failed: %s" % failed)
    log("phase 21 seconds %.1f (gloo on one shared card: no number here "
        "is one for NCCL on two)" % (time.perf_counter() - t_phase))
    del model, A
    if TP_DEVICE == "cuda":
        torch.cuda.empty_cache()
    total["flash_attention_bwd_dkdv"] = total["flash_attention_bwd"]
    total["flash_attention_bwd_dq"] = total["flash_attention_bwd"]
    return total


# -- phase 22: every family under a tensor mesh, the Trainer on a mesh -----
# Published widths, depth cut as the earlier phases cut it; f32; weights
# from the seed. (f), BERT-base text_classify's --remat=full + Adafactor at
# dp=2 and tp=2 and LoRA at tp=2 with a save and a resume, runs in phase
# 20's ranks (phase_parallel_rank), which start its process group anyway.
P22_BART_LAYERS = 2          # + 2 decoder layers
P22_BART_DIR = "bart-base-random-2-layers"
P22_BART_STEPS = 3           # 3 x 8 rows of 1024 / 64 tokens
P22_BEAMS = 4
P22_T5 = dict(T5_BASE, num_layers=2, num_decoder_layers=2)
P22_T5_SHAPE = (8, 512, 64)  # rows, source, target tokens
P22_BLOOM = {"n_layer": 2}   # BloomConfig's defaults are bloom-560m's
P22_BLOOM_SHAPE = (4, 256)
P22_CLIP_LAYERS = 2          # each tower
P22_CLIP_ROWS = 16           # 224 x 224 images, 32-token captions
P22_ARTIST_LAYERS = 2
P22_ARTIST_ROWS = 2          # 256 x 256 images: 256 codes each
P22_ARTIST_CODES = 8         # greedy codes generated
P22_SD_TEXT_LAYERS = 2
P22_SD = dict(SD_V1, num_res_blocks=1, text_config=dict(
    SD_V1["text_config"], num_hidden_layers=P22_SD_TEXT_LAYERS))
P22_SD_ROWS, P22_SD_SIZE, P22_SD_STEPS = 2, 256, 2
P22_LOSS_RTOL = 1e-5
P22_TIMEOUT = 600
P22_DEVICE = "cuda"   # both ranks on device 0 of this type
P22_WRAPPERS = ("short_attention_fwd", "short_attention_bwd",
                "flash_attention_fwd", "flash_attention_bwd")


def _p22_bart_data(torch, seed, workdir):
    """Phase 22 (a)'s files under workdir/p22: phase 6's BART-base cut to
    P22_BART_LAYERS encoder and decoder layers, and P22_BART_STEPS x
    BART_BATCH rows of phase 6's training TSV."""
    d = os.path.join(workdir, "p22")
    os.makedirs(d, exist_ok=True)
    cut = os.path.join(d, P22_BART_DIR)
    depth_cut(torch, os.path.join(workdir, BART_MODEL_DIR), cut,
              P22_BART_LAYERS, "encoder_layers")
    with open(os.path.join(cut, "config.json")) as f:
        config = json.load(f)
    config["decoder_layers"] = P22_BART_LAYERS
    with open(os.path.join(cut, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    with open(os.path.join(workdir, "bart_train.tsv"), encoding="utf-8") as f:
        lines = f.read().splitlines(True)
    with open(os.path.join(d, "bart.tsv"), "w", encoding="utf-8") as f:
        f.writelines(lines[:P22_BART_STEPS * BART_BATCH])
    return d


def _p22_workload(torch, seed, d, rank):
    """Phase 22's parts (a)-(e) and (g) in this process: rank None is the
    one-process run, ranks 0 and 1 the gloo ranks (whose first part, the
    CLI, starts their group: initialize_easynlp with --mesh=tp=2,
    --num_processes, --process_index, a file:// --coordinator_address,
    --dist_backend=gloo). Each part's model is built from the seed on the
    card, split over the rank's mesh (parallel/sharding.parallelize), and
    run through the entry points a user calls; its launches are counted
    from 0. Returns {part: results}."""
    import numpy as np
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.parallel import mesh as M
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    dev = torch.device(P22_DEVICE, 0)
    out = {"launches": {}, "seconds": {}}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def part(name, mesh_axes, fn):
        """fn() on a mesh of mesh_axes over the two ranks (none in one
        process), its launches counted from 0."""
        if rank is not None and mesh_axes is not None:
            M.set_global_mesh(M.build_mesh(mesh_axes, dev.type))
        for w in P22_WRAPPERS:
            getattr(A, w).launches = 0
        t0 = time.perf_counter()
        try:
            out[name] = fn()
            sync()
        finally:
            out["launches"][name] = {w: getattr(A, w).launches
                                     for w in P22_WRAPPERS}
            out["seconds"][name] = time.perf_counter() - t0
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    def mesh():
        m = M.get_global_mesh()
        return m if m is not None and m.world_size > 1 else None

    def gen(s):
        return torch.Generator(device=dev).manual_seed(seed + s)

    def grad_norm(module):
        grads = {n: p.grad for n, p in module.named_parameters()
                 if p.grad is not None}
        if mesh() is not None:
            grads = sharding.full_state(module, mesh(), grads)
        return float(torch.stack([g.float().norm() for g in grads.values()])
                     .norm())

    # (a) BART-base through the CLI at tp=2, then 4-beam generate
    def bart():
        argv = ["--mode=train", "--app_name=sequence_generation",
                "--tables=" + os.path.join(d, "bart.tsv"),
                "--pretrained_model_name_or_path=" + os.path.join(
                    d, P22_BART_DIR),
                "--epoch_num=1", "--learning_rate=%g" % BART_LR,
                "--optimizer_type=AdamW", "--logging_steps=1",
                "--random_seed=%d" % seed, "--device=" + (
                    "cuda:0" if dev.type == "cuda" else dev.type),
                "--dtype=float32", "--sequence_length=%d" % BART_SEQ_LEN,
                "--micro_batch_size=%d" % BART_BATCH,
                "--input_schema=id:str:1,article:str:1,summary:str:1",
                "--first_sequence=article", "--second_sequence=summary",
                "--use_flash_attention=auto"]
        if rank is not None:
            argv += ["--mesh=tp=2", "--num_processes=2",
                     "--process_index=%d" % rank,
                     "--coordinator_address=file://" + os.path.join(
                         d, "rdzv22"), "--dist_backend=gloo"]
        trainer = default_main_fn(initialize_easynlp(args_list=argv))
        from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
            encoder_decoder_generate)
        rng = np.random.RandomState(seed + 22)
        ids = torch.tensor(rng.randint(4, BART_BASE["vocab_size"],
                                       (BART_BATCH, BART_SEQ_LEN)),
                           device=dev)
        mask = torch.ones_like(ids, dtype=torch.int32)
        mask[1::2, BART_SEQ_LEN // 2:] = 0   # half the rows padded
        model = trainer.app.module.eval()
        with torch.inference_mode():
            tokens = encoder_decoder_generate(
                model, ids, mask, max_length=BART_TARGET_TOKENS,
                num_beams=P22_BEAMS)
        return {"losses": [r["loss"] for r in trainer.step_records],
                "grad_norms": [r["grad_norm"] for r in trainer.step_records],
                "tokens": tokens.cpu().tolist(),
                "heads": model.model.encoder.layers[0].self_attn.num_heads}
    part("a BART-base", None, bart)

    def lm_step(model, forward, loss_of):
        """(logits-like output, loss, whole gradient norm, loss after one
        SGD step of 1e-3): forward() -> output, loss_of(output) -> loss."""
        got = forward()
        loss = loss_of(got)
        loss.backward()
        gn = grad_norm(model)
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.sub_(1e-3 * p.grad)
                    p.grad = None
            again = float(loss_of(forward()))
        return got, float(loss.detach()), gn, again

    # (b) T5-base: logits and one step at 8 x 512 / 64
    def t5():
        from easynlp_tpu_torch.modelzoo.models.t5 import (
            T5Config, T5ForConditionalGeneration)
        cfg = T5Config(**P22_T5)
        model = T5ForConditionalGeneration(cfg, device=dev)
        model.init_weights(gen(1))
        sharding.parallelize(model, mesh())
        b, s, t = P22_T5_SHAPE
        rng = np.random.RandomState(seed + 23)
        src = torch.tensor(rng.randint(2, cfg.vocab_size, (b, s)),
                           device=dev)
        tgt = torch.tensor(rng.randint(2, cfg.vocab_size, (b, t)),
                           device=dev)

        def forward():
            return model(src, torch.ones_like(src), tgt)["logits"]

        def loss_of(logits):
            return torch.nn.functional.cross_entropy(
                logits[:, :-1].float().flatten(0, 1), tgt[:, 1:].flatten())
        logits, loss, gn, again = lm_step(model, forward, loss_of)
        return {"logits": logits[:, ::8].detach().cpu(), "loss": loss,
                "grad_norm": gn, "loss_after_step": again}
    part("b T5-base", {"tensor": 2}, t5)

    # (c) bloom-560m: logits at 4 x 256
    def bloom():
        from easynlp_tpu_torch.modelzoo.models.bloom.modeling_bloom import (
            BloomConfig, BloomForCausalLM)
        cfg = BloomConfig(**P22_BLOOM)
        model = BloomForCausalLM(cfg, device=dev)
        model.init_weights(gen(2))
        sharding.parallelize(model, mesh())
        b, s = P22_BLOOM_SHAPE
        rng = np.random.RandomState(seed + 24)
        ids = torch.tensor(rng.randint(3, cfg.vocab_size, (b, s)),
                           device=dev)
        mask = torch.ones_like(ids)
        mask[1, s // 2:] = 0
        with torch.inference_mode():
            logits = model.eval()(ids, mask)["logits"]
        return {"logits": logits[:, ::16].cpu()}
    part("c bloom-560m", {"tensor": 2}, bloom)

    # (d) Chinese-CLIP ViT-B/16 and its text tower: one step
    def clip():
        from easynlp_tpu_torch.appzoo.clip.model import CLIPApp
        from easynlp_tpu_torch.modelzoo.models.clip import CLIPConfig
        c = dict(CHINESE_CLIP_B16)
        c["vision_config"] = dict(CLIP_VISION,
                                  num_hidden_layers=P22_CLIP_LAYERS)
        c["text_config"] = dict(c["text_config"],
                                num_hidden_layers=P22_CLIP_LAYERS)
        cfg = CLIPConfig(**{k: v for k, v in c.items()
                            if k != "model_type"})
        module = CLIPApp.build_module(cfg, dtype=torch.float32, device=dev)
        module.init_weights(gen(3))
        sharding.parallelize(module, mesh())
        app = CLIPApp(module, cfg, dev)
        rng = np.random.RandomState(seed + 25)
        n, s = P22_CLIP_ROWS, CLIP_TEXT_LEN
        batch = {"input_ids": torch.tensor(rng.randint(
                     1, cfg.text_config.vocab_size, (n, s)), device=dev),
                 "attention_mask": torch.ones((n, s), dtype=torch.int64,
                                              device=dev),
                 "token_type_ids": torch.zeros((n, s), dtype=torch.int64,
                                               device=dev),
                 "pixel_values": torch.tensor(
                     rng.rand(n, CLIP_VISION["image_size"],
                              CLIP_VISION["image_size"], 3),
                     dtype=torch.float32, device=dev)}

        def forward():
            return app.forward(batch)
        got, loss, gn, again = lm_step(
            module, forward, lambda o: app.loss_fn(o, batch)["loss"])
        return {"logits": got["logits_per_text"].detach().cpu(),
                "loss": loss, "grad_norm": gn, "loss_after_step": again}
    part("d CLIP ViT-B/16", {"tensor": 2}, clip)

    # (e) ARTIST-base: one step and greedy codes
    def artist():
        from easynlp_tpu_torch.appzoo.text2image_generation.model import (
            TextImageGeneration)
        from easynlp_tpu_torch.modelzoo.models.artist.modeling_artist import (
            ARTISTConfig)
        c = {k: v for k, v in ARTIST_BASE.items() if k != "model_type"}
        c["gpt_config"] = dict(c["gpt_config"], n_layer=P22_ARTIST_LAYERS)
        cfg = ARTISTConfig(**c)
        module = TextImageGeneration.build_module(cfg, dtype=torch.float32,
                                                  device=dev)
        module.init_weights(gen(4))
        sharding.parallelize(module, mesh())
        app = TextImageGeneration(module, cfg, dev)
        rng = np.random.RandomState(seed + 26)
        n, s = P22_ARTIST_ROWS, ARTIST_TEXT_LEN
        batch = {"input_ids": torch.tensor(rng.randint(
                     1, cfg.text_vocab_size, (n, s)), device=dev),
                 "attention_mask": torch.ones((n, s), dtype=torch.int64,
                                              device=dev),
                 "pixel_values": torch.tensor(
                     rng.rand(n, ARTIST_SIZE, ARTIST_SIZE, 3) * 2 - 1,
                     dtype=torch.float32, device=dev)}
        codes = []

        def forward():
            o = app.forward(batch)
            codes.append(o["image_codes"].cpu())
            return o
        got, loss, gn, again = lm_step(
            module, forward, lambda o: app.loss_fn(o, batch)["loss"])
        module.eval()
        cfg.image_token_length = P22_ARTIST_CODES
        greedy = app.generate(batch["input_ids"], batch["attention_mask"],
                              do_sample=False)
        return {"logits": got["logits"][:, ::16].detach().cpu(),
                "codes": codes[0].tolist(), "loss": loss, "grad_norm": gn,
                "loss_after_step": again, "greedy": greedy.cpu().tolist()}
    part("e ARTIST-base", {"tensor": 2}, artist)

    # (g) the SD v1 UNet: make_train_loss steps through the Trainer at dp=2
    def unet():
        from easynlp_tpu_torch.appzoo.latent_diffusion.model import (
            LatentDiffusion, LDMConfig)
        from easynlp_tpu_torch.core.trainer import Trainer
        from easynlp_tpu_torch.utils.arguments import parse_args
        cfg = LDMConfig(**{k: v for k, v in P22_SD.items()
                           if k != "model_type"})
        module = LatentDiffusion.build_module(cfg, dtype=torch.float32,
                                              device=dev)
        module.init_weights(gen(5))
        app = LatentDiffusion(module, cfg, dev)
        world = 1 if rank is None else 2
        args = parse_args(args_list=[
            "--dtype=float32", "--logging_steps=1000",
            "--micro_batch_size=%d" % P22_SD_ROWS,
            "--learning_rate=1e-5", "--lr_scheduler=constant",
            "--random_seed=%d" % seed, "--num_processes=%d" % world,
            "--process_index=%d" % (rank or 0)])

        class Rows:
            def __len__(self):
                return P22_SD_ROWS * P22_SD_STEPS // world
        trainer = Trainer(app, Rows(), args=args)
        rng = np.random.RandomState(seed + 27)
        lo, hi = M.batch_sharding(P22_SD_ROWS)
        metrics = []
        for _ in range(P22_SD_STEPS):
            ids = rng.randint(1, cfg.text_config.vocab_size,
                              (P22_SD_ROWS, SD_TEXT_LEN))
            pixels = rng.rand(P22_SD_ROWS, P22_SD_SIZE, P22_SD_SIZE, 3) \
                * 2 - 1
            batch = {"input_ids": torch.tensor(ids[lo:hi], device=dev),
                     "attention_mask": torch.ones_like(torch.tensor(
                         ids[lo:hi], device=dev)),
                     "pixel_values": torch.tensor(pixels[lo:hi],
                                                  dtype=torch.float32,
                                                  device=dev)}
            names, values = trainer._train_step(batch)
            metrics.append(dict(zip(names, values.tolist())))
        return {"losses": [m["loss"] for m in metrics],
                "grad_norms": [m["grad_norm"] for m in metrics]}
    part("g SD v1 UNet", {"data": 2}, unet)
    if rank is not None:
        M.destroy()
    return out


def phase_p22_rank(torch, seed, rank, workdir):
    """One of phase 22's processes on cuda:0: rank -1 the one-process run,
    which writes workdir/p22_one.pt; ranks 0 and 1 the gloo ranks, which
    start once it is written and write workdir/p22_rank<r>.pt."""
    if P22_DEVICE == "cuda":
        torch.cuda.set_device(0)
        # f32 convolutions in f32: cuDNN's TF32 rounds (g)'s UNet and
        # VAE convolutions to 10-bit mantissas, differently for the ranks'
        # one row than for the one process's two
        torch.backends.cudnn.allow_tf32 = False
    if rank < 0:
        out = _p22_workload(torch, seed, workdir, None)
        torch.save(out, os.path.join(workdir, "p22_one.tmp"))
        os.replace(os.path.join(workdir, "p22_one.tmp"),
                   os.path.join(workdir, "p22_one.pt"))
        return
    go = os.path.join(workdir, "p22_one.pt")
    deadline = time.monotonic() + P22_TIMEOUT
    while not os.path.exists(go):
        if time.monotonic() > deadline:
            raise TimeoutError("phase 22 rank %d: the one-process run "
                               "wrote nothing in %d s" % (rank, P22_TIMEOUT))
        time.sleep(0.1)
    out = _p22_workload(torch, seed, workdir, rank)
    torch.save(out, os.path.join(workdir, "p22_rank%d.pt" % rank))


def start_p22_ranks(torch, seed, workdir):
    """Phase 22's files (_p22_bart_data) and processes (phase_p22_rank):
    the one-process run (rank -1) and the two ranks, which go once it is
    done. Returns ([rank 0, rank 1, rank -1], their directory)."""
    d = _p22_bart_data(torch, seed, workdir)
    env = dict(os.environ, OMP_NUM_THREADS="4")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--seed", str(seed),
         "--p22-rank=%d" % r, "--p22-dir", d], env=env,
        stdout=open(os.path.join(d, "rank%d.log" % r), "w"),
        stderr=subprocess.STDOUT) for r in (0, 1, -1)]
    return procs, d


def phase_p22(torch, seed, workdir, ranks=None):
    """Phase 22: every family the JAX package annotates under a tensor
    mesh, and the Trainer on a mesh, at published widths with depth cut,
    f32, on two gloo ranks on cuda:0 against one process (phase_p22_rank):
    (a) BART-base (2 + 2 layers) sequence_generation train through the CLI
    at --mesh=tp=2, 3 steps of 8 x 1024 / 64, then 4-beam generate on 8
    sources of 1024 tokens; (b) T5-base (2 + 2): logits and one step at 8
    x 512 / 64; (c) bloom-560m (2 layers): logits at 4 x 256; (d)
    Chinese-CLIP ViT-B/16 and its text tower (2 layers each): one step at
    16 x 224^2; (e) ARTIST-base (2 GPT layers): one step at 2 x 256^2 and
    8 greedy codes; (g) the SD v1 UNet (num_res_blocks 1, a 2-layer text
    tower): 2 make_train_loss steps of 2 x 256^2 at dp=2 through the
    Trainer. (f) runs in phase 20. Logits within TP_LOGITS_ATOL, losses
    within P22_LOSS_RTOL, gradient norms within PARALLEL_GNORM_RTOL, tokens
    and codes equal.
    Returns the ranks' launches by wrapper."""
    log("== phase 22: BART, T5, BLOOM, CLIP, ARTIST under tensor=2 and the "
        "UNet's diffusion loss at data=2 (two gloo ranks on cuda:0), each "
        "against one process")
    t_phase = time.perf_counter()
    procs, d = ranks or start_p22_ranks(torch, seed, workdir)
    deadline = time.monotonic() + P22_TIMEOUT
    try:
        procs[2].wait(timeout=max(1.0, deadline - time.monotonic()))
        if procs[2].returncode == 0:
            for p in procs[:2]:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in zip((0, 1, -1), procs):
        if p.returncode != 0:
            with open(os.path.join(d, "rank%d.log" % r)) as f:
                text = f.read()
            raise AssertionError("phase 22 rank %d exited %s:\n%s" % (
                r, p.returncode, text[-4000:]))
    one = torch.load(os.path.join(d, "p22_one.pt"), weights_only=False)
    ranks = [torch.load(os.path.join(d, "p22_rank%d.pt" % r),
                        weights_only=False) for r in range(2)]
    failed = []

    def rel(a, b):
        return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))
    for name in sorted(one["launches"]):
        want = one[name]
        notes = []
        for r, rk in enumerate(ranks):
            got = rk[name]
            # losses within P22_LOSS_RTOL, gradient norms within
            # PARALLEL_GNORM_RTOL (phase 20's bound), both relative
            for key in ("losses", "loss", "loss_after_step", "grad_norms",
                        "grad_norm"):
                if key not in want:
                    continue
                pair = (got[key], want[key]) if isinstance(want[key], list) \
                    else ([got[key]], [want[key]])
                e = rel(*pair)
                notes.append("%s rdiff %.2e" % (key, e))
                if not e <= (PARALLEL_GNORM_RTOL if "grad" in key
                             else P22_LOSS_RTOL):
                    failed.append("%s rank %d %s %s vs %s" % (
                        name, r, key, got[key], want[key]))
            if "logits" in want:
                e = float((got["logits"] - want["logits"]).abs().max())
                notes.append("logit diff %.3e" % e)
                if not e <= TP_LOGITS_ATOL:
                    failed.append("%s rank %d logits differ by %.3e" % (
                        name, r, e))
            for key in ("tokens", "codes", "greedy"):
                if key in want:
                    same = sum(a == b for a, b in zip(got[key], want[key]))
                    notes.append("%s %d/%d rows equal" % (key, same,
                                                          len(want[key])))
                    if got[key] != want[key]:
                        failed.append("%s rank %d: %s differ" % (name, r,
                                                                  key))
        log("phase 22 %-16s %s; launches a rank %s; seconds one %.1f, "
            "ranks %s" % (name, "; ".join(notes[:len(notes) // 2]),
                          [rk["launches"][name] for rk in ranks],
                          one["seconds"][name],
                          ["%.1f" % rk["seconds"][name] for rk in ranks]))
    heads = ranks[0]["a BART-base"]["heads"]
    if heads != BART_BASE["encoder_attention_heads"] // 2:
        failed.append("(a) %d heads a rank" % heads)
    total = dict.fromkeys(P22_WRAPPERS, 0)
    for r, rk in enumerate(ranks):
        for launches in rk["launches"].values():
            for w, n in launches.items():
                total[w] += n
    for w, n in total.items():
        if not n:
            failed.append("no %s launch on the ranks" % w)
    if failed:
        raise AssertionError("phase 22 failed: %s" % failed)
    log("phase 22 B1-B5 launches over both ranks %s; %d heads a rank in "
        "(a); seconds %.1f; written so far (wchar) %s" % (
            total, heads, time.perf_counter() - t_phase,
            "%.2f GiB" % (_written_gib() or 0.0)))
    if P22_DEVICE == "cuda":
        torch.cuda.empty_cache()
    total["flash_attention_bwd_dkdv"] = total["flash_attention_bwd"]
    total["flash_attention_bwd_dq"] = total["flash_attention_bwd"]
    return total


def _dtype_key(key):
    """A (..., dtype) key as text ("...|bfloat16") and back."""
    import torch
    if isinstance(key, str):
        *rest, dtype = key.split("|")
        return tuple(rest) + (getattr(torch, dtype),)
    return "|".join(key[:-1] + (str(key[-1]).split(".")[1],))


def _written_gib():
    """GiB this process has passed to write(2) so far (/proc/self/io's
    wchar: its files, checkpoints above all, and its pipes and sockets;
    write_bytes reads 0 on the card's machine), or None where the kernel
    does not count it. The card's machine caps the disk writes of a run
    at 45 GiB."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split()[1]) / 2 ** 30
    except OSError:
        pass
    return None


def phase_kernel_in_child(seed):
    """Phase 2 in a process of its own, which writes (worst, timings) as
    JSON: its ~26 profiler sessions then leave this process's profiler
    fresh for the phases after it (on an H100 the 36th profiler session of
    one process has recorded no device kernel). Where every session of one
    check recorded none (ProfilerLost: the child exits PROFILE_LOST_RC),
    the whole phase runs once more in a fresh child, which must pass every
    check again."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kernels_") as d:
        path = os.path.join(d, "kernels.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--seed",
               str(seed), "--kernels-json", path]
        rc = subprocess.run(cmd, timeout=900).returncode
        if rc == PROFILE_LOST_RC:
            log("phase 2: the profiler recorded no device kernel in a check; "
                "running phase 2 again in a fresh process")
            rc = subprocess.run(cmd, timeout=900).returncode
        if rc:
            raise subprocess.CalledProcessError(rc, cmd)
        with open(path) as f:
            data = json.load(f)
    worst = {name: {_dtype_key(k): v for k, v in cases.items()}
             for name, cases in data["worst"].items()}
    return worst, {_dtype_key(k): v for k, v in data["timings"].items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--kernels-json", help=argparse.SUPPRESS)
    parser.add_argument("--parallel-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--parallel-dir", help=argparse.SUPPRESS)
    parser.add_argument("--tp-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--tp-dir", help=argparse.SUPPRESS)
    parser.add_argument("--p22-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--p22-dir", help=argparse.SUPPRESS)
    parser.add_argument(
        "--only", choices=("2", "19", "20", "21", "22"),
        help="run phase 0, the build and this phase alone (phase 19 on a "
        "vocabulary of its own), to iterate on it; the full run is the "
        "smoke test")
    cli = parser.parse_args()
    seed = cli.seed

    import torch
    # the port itself: outside a checkout this fails before anything prints
    import easynlp_tpu_torch.appzoo.api  # noqa: F401
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 2
    if cli.parallel_rank is not None:  # one of phase 20's ranks
        phase_parallel_rank(torch, seed, cli.parallel_rank, cli.parallel_dir)
        return 0
    if cli.tp_rank is not None:  # one of phase 21's ranks
        phase_tp_rank(torch, seed, cli.tp_rank, cli.tp_dir)
        return 0
    if cli.p22_rank is not None:  # one of phase 22's processes
        phase_p22_rank(torch, seed, cli.p22_rank, cli.p22_dir)
        return 0
    phase_device(torch)
    if cli.kernels_json:  # phase 2 alone, for phase_kernel_in_child
        try:
            worst, timings = phase_kernel(torch, seed)
        except ProfilerLost as e:
            print("chip_smoke: %s" % e, file=sys.stderr)
            return PROFILE_LOST_RC
        with open(cli.kernels_json, "w") as f:
            json.dump({"worst": {name: {_dtype_key(k): v
                                        for k, v in cases.items()}
                                 for name, cases in worst.items()},
                       "timings": {_dtype_key(k): v
                                   for k, v in timings.items()}}, f)
        return 0
    build_s = phase_build()
    if cli.only:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            if cli.only == "2":
                phase_kernel_in_child(seed)
            elif cli.only == "20":
                tokens, cjk = _vocab()
                make_model_dir(torch, os.path.join(workdir, MODEL_DIR),
                               seed)
                make_tsv(os.path.join(workdir, "train.tsv"), cjk, seed + 1)
                phase_parallel(torch, seed, workdir)
            elif cli.only == "21":
                phase_tp(torch, seed, workdir)
            elif cli.only == "22":
                # phase 6's BART-base directory and TSV, which (a) cuts
                model_dir = os.path.join(workdir, BART_MODEL_DIR)
                make_bart_model_dir(torch, model_dir, seed)
                from easynlp_tpu_torch.modelzoo.models.gpt2 import (
                    GPT2Tokenizer)
                make_bart_tsv(os.path.join(workdir, "bart_train.tsv"),
                              GPT2Tokenizer.from_pretrained(model_dir),
                              seed + 5, BART_BATCH * BART_STEPS)
                phase_p22(torch, seed, workdir)
            else:
                tokens, cjk = _vocab()
                os.makedirs(os.path.join(workdir, MODEL_DIR))
                with open(os.path.join(workdir, MODEL_DIR, "vocab.txt"), "w",
                          encoding="utf-8") as f:
                    f.write("\n".join(tokens) + "\n")
                phase_artist(torch, seed, workdir, cjk)
        log("chip_smoke --only %s: passed; card: %s" % (cli.only,
                                                       card_line()))
        return 0
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
        launches, bart_run = phase_bart(torch, seed, workdir)
        seconds["6 BART train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_bart_predict(torch, seed, workdir)
        seconds["7 BART predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_encoder_apps(torch, seed, workdir, cjk)
        seconds["8 encoder apps"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_serving(torch, seed, workdir)
        seconds["9 GPT-2 /generate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_prediction_server(torch, workdir)
        seconds["10 PredictionServer"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mlm_launches = phase_mlm(torch, seed, workdir)
        seconds["11 MLM pretraining"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        apps2_launches = phase_encoder_apps2(torch, seed, workdir, cjk)
        seconds["12 encoder apps 2, optimizers"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        options_launches = phase_trainer_options(torch, seed, workdir,
                                                 bart_run)
        seconds["13 trainer options, KD, PET, MetaKD, LoRA"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        knowledge_launches = phase_knowledge(torch, seed, workdir, cjk)
        seconds["14 knowledge models"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        s2s_launches = phase_seq2seq(torch, seed, workdir, cjk)
        seconds["15 T5, mT5, Pegasus, Randeng, GPT-2 evaluate, dialogue"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        s11_launches = phase_slice11(torch, seed, workdir)
        seconds["16 speculative, int8, GLM"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mm_launches = phase_multimodal(torch, seed, workdir, cjk)
        seconds["17 CLIP, captioning"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sd_launches = phase_diffusion(torch, seed, workdir, cjk)
        seconds["18 latent diffusion"] = time.perf_counter() - t0
        # phase 21's and 22's processes start now: their work overlaps
        # phases 19 and 20
        tp_ranks = start_tp_ranks(seed, workdir)
        p22_ranks = start_p22_ranks(torch, seed, workdir)
        try:
            t0 = time.perf_counter()
            artist_launches = phase_artist(torch, seed, workdir, cjk)
            seconds["19 ARTIST, TextCNN, BLOOM"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            parallel_launches = phase_parallel(torch, seed, workdir)
            seconds["20 multi-GPU"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tp_launches = phase_tp(torch, seed, workdir, tp_ranks)
        except BaseException:
            for p in tp_ranks[0] + p22_ranks[0]:
                p.kill()
                p.wait()
            raise
        seconds["21 GPT-2 under tensor=2"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p22_launches = phase_p22(torch, seed, workdir, p22_ranks)
        seconds["22 families under tensor=2, Trainer on a mesh"] = \
            time.perf_counter() - t0
    log("phase seconds: %s" % ", ".join("%s %.1f" % kv
                                        for kv in seconds.items()))
    written = _written_gib()
    log("bytes this process wrote (wchar): %s" % (
        "not measured" if written is None else "%.2f GiB" % written))

    log("kernel build %.3f s" % build_s)
    log("BERT training step, median of runs: %.3f ms with the kernels, %.3f "
        "ms plain" % (1e3 * ms_k, 1e3 * ms_p))
    log("card: %s" % card_line())
    entries = []
    for name, (wrapper, source, replaces) in KERNELS.items():
        case = KERNEL_LINE_CASE[name]
        t = timings[(name, case, torch.bfloat16)]
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[name] + mlm_launches.get(wrapper, 0)
            + apps2_launches.get(wrapper, 0)
            + options_launches.get(wrapper, 0)
            + knowledge_launches.get(wrapper, 0)
            + s2s_launches[name] + s11_launches[name]
            + mm_launches[name] + sd_launches[name]
            + artist_launches[name] + parallel_launches[name]
            + tp_launches[name] + p22_launches[name],
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
