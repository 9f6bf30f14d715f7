"""Multi-head attention for the PyTorch port: one `attention()` entry over
hand-written CUDA kernels and plain PyTorch paths.

Counterpart of easynlp_tpu/ops/attention.py, with the same contract:
q [B,Sq,H,D], k/v [B,Skv,H,D] (or heads-major with layout='bhsd'), a
[B,Skv] or [1,Skv] key mask, causal masking with q_offset = Skv - Sq, and an
additive bias that forces the plain path.

Paths:

1. `attention_reference` mirrors the JAX attention_reference, including its
   bf16 score cast and the stop-gradient on the row max, so autograd through
   it gives jax.grad's gradients. It serves an additive bias, head dims the
   kernels do not take, and every call under --use_flash_attention=false.
2. `ShortAttention` is the whole-sequence path for Skv <= 512, an
   autograd.Function over two kernels: `short_attention_fwd`
   (csrc/short_attention_fwd.cu, the port of `_short_fwd_kernel`) and
   `short_attention_bwd` (csrc/short_attention_bwd.cu, the port of
   `_short_bwd_kernel`). A CPU tensor takes their plain twins
   `short_attention_fwd_reference` and `short_attention_bwd_reference`.
3. `FlashAttention` is the blocked path for any Skv, an autograd.Function
   over `flash_attention_fwd` (csrc/flash_attention_fwd.cu, the port of
   `_fwd_kernel`: O and the f32 LSE) and `flash_attention_bwd`
   (csrc/flash_attention_bwd.cu, the port of `_bwd_dkdv_kernel` and
   `_bwd_dq_kernel`). A CPU tensor takes `flash_attention_fwd_reference`
   and `flash_attention_bwd_reference`. It serves Skv > 512, with or
   without a gradient (BART's encoder and cross-attention, GPT-2 past 512
   keys).

Routes on a card, a rule on dtype and shape (the kernels' head comments
state the same): f32 takes the CUDA-core walks everywhere, the only ones
that meet the f32 twins' 2e-5 bound. bf16 takes `mma.sync` tensor-core
kernels everywhere: the short forward (`_short_fwd_route`; up to 64 query
rows a block, skipping key tiles the mask hides); the flash forward at
every Sq (decode included: PERF.md); the short backward in one block per
(b, h) for Sq, Skv <= SHORT_BWD_ONE_BLOCK_LEN and through the flash
backward's passes above (`_short_bwd_route`); the flash backward always.

The JAX package routes BERT lengths below 256 to XLA on a TPU and reaches
its flash kernel only from Skv = 8192. Those windows are TPU tunings, so
here every Skv <= 512 takes the short kernels on a card and every longer
one the flash kernels; the card's own thresholds come from its
measurements (PERF.md). Ring attention is not ported yet (ROADMAP A24).
"""

import ctypes
import math

import torch

NEG_INF = -1e30
# a row whose LSE is below this saw no visible key (its LSE is -1e30)
MASKED_ROW_LSE = 0.5 * NEG_INF
SHORT_MAX_KV_LEN = 512
MAX_HEAD_DIM = 128
# bf16 short backward calls with Sq and Skv at most this take the one-block
# tensor-core kernel (code 1 of csrc/short_attention_bwd.cu); larger ones
# the flash backward's tensor-core passes (code 2).
SHORT_BWD_ONE_BLOCK_LEN = 128

# --use_flash_attention true|false (wired by utils/initializer.py):
# False sends every call to attention_reference; None (auto) and True take
# the kernel paths where they apply.
_KERNEL_OVERRIDE = None

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHERS = {}


def set_kernel_override(value):
    """value: True or None (kernel paths where they apply) or False (plain
    attention_reference everywhere)."""
    global _KERNEL_OVERRIDE
    _KERNEL_OVERRIDE = value


def use_kernels():
    return _KERNEL_OVERRIDE is not False


def attention_reference(q, k, v, kv_mask=None, causal=False, scale=None,
                        bias=None):
    """q [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask [B|1,Skv], bias [B,H,Sq,Skv].
    Mirrors easynlp_tpu.ops.attention.attention_reference."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if kv_mask is not None:
        logits = logits.masked_fill(kv_mask[:, None, None, :] == 0, NEG_INF)
    if causal:
        logits = logits.masked_fill(_causal_hidden(q.shape[1], k.shape[1],
                                                   q.device), NEG_INF)
    if q.dtype == torch.bfloat16:
        # as in the JAX reference: the max-subtracted scores pass through
        # bf16, and no gradient flows through the max (stop_gradient there)
        logits = logits - logits.amax(dim=-1, keepdim=True).detach()
        logits = logits.to(torch.bfloat16)
    probs = torch.softmax(logits.float(), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def _causal_hidden(sq, skv, device):
    """[Sq,Skv] bool, True where key k lies after query q + (Skv - Sq)."""
    qi = torch.arange(sq, device=device)[:, None] + (skv - sq)
    ki = torch.arange(skv, device=device)[None, :]
    return ki > qi


def _hidden_keys(kv_mask, sq, skv, causal, device):
    """[B|1,1,Sq,Skv] bool, True where a key is masked or causally hidden."""
    hidden = (kv_mask == 0)[:, None, None, :]
    if causal:
        hidden = hidden | _causal_hidden(sq, skv, device)
    return hidden


def _short_probs(q, k, hidden, scale):
    """f32 [B,H,Sq,Skv] probabilities over the real Skv keys only (no
    padding, so a fully masked row averages over the real keys, as
    attention_reference does). The max is detached, as JAX's is."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(hidden, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def short_attention_fwd_reference(q, k, v, kv_mask, causal=False, scale=None):
    """Plain PyTorch twin of the forward kernel: the JAX `_short_probs` + P.V
    in f32 from the given inputs. P stays f32, as in the kernel's f32 route;
    its bf16 route rounds each unnormalised probability to bf16 before P.V
    (the bound beside flash_attention_fwd_rss). Output in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    hidden = _hidden_keys(kv_mask, q.shape[1], k.shape[1], causal, q.device)
    p = _short_probs(q, k, hidden, scale)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def short_attention_bwd_reference(q, k, v, kv_mask, o, do, causal=False,
                                  scale=None):
    """Plain PyTorch twin of the backward kernel, in f32: P recomputed from
    q and k, dV = P^T dO, dP = dO V^T, delta = rowsum(dO * O),
    dS = P * (dP - delta) * scale zeroed at every masked or causally hidden
    key, dQ = dS K, dK = dS^T Q. This is jax.grad of attention_reference: a
    fully masked row gets dq = 0 and gives no dk (the JAX short kernel does
    not zero dS there, ROADMAP C7). Returns (dq, dk, dv) in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    hidden = _hidden_keys(kv_mask, q.shape[1], k.shape[1], causal, q.device)
    p = _short_probs(q, k, hidden, scale)
    do32 = do.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v.float())
    delta = (do32 * o.float()).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - delta) * scale).masked_fill(hidden, 0.0)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_fwd_reference(q, k, v, kv_mask, causal=False,
                                  scale=None):
    """Plain PyTorch twin of the flash forward kernel, in f32 from the given
    inputs: (O in q's dtype [B,Sq,H,D], LSE f32 [B,H,Sq]), LSE the logsumexp
    of the masked, scaled scores.

    A fully masked row (every key masked or causally hidden) follows
    attention_reference: O is the mean of V over the real Skv keys, and its
    scores are all -1e30, so its LSE is -1e30 + log(Skv) in exact
    arithmetic, which f32 rounds to -1e30. A backward that forms
    P = exp(s - LSE) from it gets weight 1 for every key of such a row, not
    1/Skv (flash_attention_bwd does not)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    hidden = _hidden_keys(kv_mask, q.shape[1], k.shape[1], causal, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(hidden, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype), lse


def flash_attention_fwd_rss(q, k, v, kv_mask, causal=False, scale=None):
    """The root-sum-square of the terms that make up each element of O in
    flash_attention_fwd_reference, f32 [B,Sq,H,D]: sqrt(sum_k (P_k v_k)^2)
    with P the normalised probabilities. The bf16 tensor-core forwards
    (flash and short) round each unnormalised probability to bf16 before
    P V (the normalisation is a common factor of the row), so their error
    is a sum of those terms each moved by at most 2^-8 of itself; its
    spread scales with this (chip_smoke.py and tests/test_torch_kernels.py
    state the bound)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    hidden = _hidden_keys(kv_mask, q.shape[1], k.shape[1], causal, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s.masked_fill(hidden, NEG_INF), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p * p, v.float().square()).sqrt()


def _flash_bwd_p_ds(q, k, v, kv_mask, o, lse, do, causal, scale):
    """f32 P and dS [B,H,Sq,Skv] of the flash backward twin."""
    skv = k.shape[1]
    hidden = _hidden_keys(kv_mask, q.shape[1], skv, causal, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(hidden, NEG_INF)
    lse = lse.float()[..., None]
    p = torch.where(lse < MASKED_ROW_LSE, 1.0 / skv, torch.exp(s - lse))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    ds = (p * (dp - delta) * scale).masked_fill(hidden, 0.0)
    return p, ds


def flash_attention_bwd_reference(q, k, v, kv_mask, o, lse, do,
                                  causal=False, scale=None):
    """Plain PyTorch twin of the flash backward kernel, in f32 from the
    given inputs: P = exp(s - LSE) from the forward's LSE [B,H,Sq],
    dV = P^T dO, dP = dO V^T, delta = rowsum(dO * O),
    dS = P * (dP - delta) * scale zeroed at every masked or causally hidden
    key, dQ = dS K, dK = dS^T Q. A fully masked row (LSE below
    MASKED_ROW_LSE: its LSE is -1e30) takes P = 1/Skv at every key, as
    attention_reference gives it, not exp(0) = 1 (ROADMAP C10): dq = 0,
    no dk, dO/Skv to every key's dv. Returns (dq, dk, dv) in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p, ds = _flash_bwd_p_ds(q, k, v, kv_mask, o, lse, do, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_rss(q, k, v, kv_mask, o, lse, do, causal=False,
                            scale=None):
    """The root-sum-square of the terms that make up each gradient of
    flash_attention_bwd_reference, f32 (dq, dk, dv): sqrt(sum_k (dS K)^2)
    per element of dq, sqrt(sum_q (dS Q)^2) of dk, sqrt(sum_q (P dO)^2) of
    dv. The bf16 kernels round each P and dS to bf16 before the sum, so
    their error is a sum of those terms each perturbed by at most 2^-8 of
    itself; its spread scales with this (chip_smoke.py and
    tests/test_torch_kernels.py state the bound)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    p, ds = _flash_bwd_p_ds(q, k, v, kv_mask, o, lse, do, causal, scale)
    ds2 = ds * ds
    dv = torch.einsum("bhqk,bqhd->bkhd", p * p, do.float().square())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds2, k.float().square())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds2, q.float().square())
    return dq.sqrt(), dk.sqrt(), dv.sqrt()


def _check_args(name, q, k, v, kv_mask, max_kv_len=None):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("%s takes 4-D q/k/v [B,S,H,D]" % name)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if k.shape != (b, skv, h, d) or v.shape != k.shape:
        raise ValueError("q %s, k %s, v %s: batch, heads and head dim must "
                         "agree" % (tuple(q.shape), tuple(k.shape),
                                    tuple(v.shape)))
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("%s takes float32 or bfloat16 q/k/v of one dtype, "
                         "got %s/%s/%s" % (name, q.dtype, k.dtype, v.dtype))
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError("head dim %d: the kernel takes a multiple of 8 up "
                         "to %d" % (d, MAX_HEAD_DIM))
    if skv < 1:
        raise ValueError("Skv=%d: %s needs at least one key" % (skv, name))
    if max_kv_len is not None and skv > max_kv_len:
        raise ValueError("Skv=%d: %s takes 1..%d keys"
                         % (skv, name, max_kv_len))
    if kv_mask.dim() != 2 or kv_mask.shape[1] != skv \
            or kv_mask.shape[0] not in (1, b):
        raise ValueError("kv_mask %s: expected [%d,%d] or [1,%d]"
                         % (tuple(kv_mask.shape), b, skv, skv))
    if kv_mask.dtype not in (torch.int32, torch.bool):
        raise ValueError("kv_mask dtype %s: expected int32 or bool"
                         % kv_mask.dtype)
    if len({q.device, k.device, v.device, kv_mask.device}) != 1:
        raise ValueError("q, k, v and kv_mask must share one device")
    _check_rows(q=q, k=k, v=v)


def _check_rows(**tensors):
    vec = 16 // next(iter(tensors.values())).element_size()
    for name, t in tensors.items():
        if t.stride(3) != 1:
            raise ValueError("%s: the head dim must be contiguous" % name)
        if t.data_ptr() % 16 or any(x % vec for x in _strides(t)):
            raise ValueError("%s: the kernel reads 16-byte rows; the data "
                             "pointer and the batch/seq/head strides must be "
                             "16-byte aligned" % name)


def _strides(t):
    """(batch, seq, head) element strides, in the launcher's order, with 0
    for a dim of size 1 (never stepped over, so its stride does not
    matter)."""
    return [x if n > 1 else 0 for n, x in zip(t.shape[:3], t.stride()[:3])]


def _launcher(name, n_pointers, n_strides):
    """The ctypes launcher `easynlp_<name>` of csrc/<name>.cu: n_pointers
    pointers, dtype + B/H/Sq/Skv/D, n_strides int64 strides, causal, scale,
    stream."""
    if name not in _LAUNCHERS:
        from easynlp_tpu_torch import kernels
        fn = getattr(kernels.load(name), "easynlp_" + name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_pointers + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * n_strides
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
        _LAUNCHERS[name] = fn
    return _LAUNCHERS[name]


def _cuda_mask(kv_mask, b):
    """(int32 mask with a contiguous key dim, its batch stride: 0 when one
    row serves the whole batch)."""
    if kv_mask.dtype != torch.int32 or kv_mask.stride(1) != 1:
        kv_mask = kv_mask.to(torch.int32).contiguous()
    return kv_mask, (kv_mask.stride(0) if kv_mask.shape[0] == b and b > 1
                     else 0)


def short_attention_fwd(q, k, v, kv_mask, causal=False, scale=None):
    """Whole-sequence attention forward (the port of the TPU kernel
    `_short_fwd_kernel`).

    q [B,Sq,H,D], k/v [B,Skv,H,D] with any strides whose head dim is
    contiguous (BERT's projection views and bhsd tensors transposed to this
    shape both qualify without a copy); kv_mask [B,Skv] or [1,Skv], int32 or
    bool. Returns [B,Sq,H,D] in q's dtype; when q is dense the output takes
    q's memory layout. A CUDA tensor launches csrc/short_attention_fwd.cu
    (and counts it in `short_attention_fwd.launches`) on the route
    `_short_fwd_route` picks: f32 on the CUDA cores, bf16 on the tensor
    cores. A CPU tensor takes the plain twin.
    """
    _check_args("short_attention_fwd", q, k, v, kv_mask, SHORT_MAX_KV_LEN)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError(
            "short_attention_fwd is the bare forward kernel and records no "
            "gradient; call attention() or ShortAttention.apply, whose "
            "backward is short_attention_bwd")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return short_attention_fwd_reference(q, k, v, kv_mask, causal, scale)
    if q.device.type != "cuda":
        raise ValueError("short_attention_fwd runs on cpu or cuda, got %s"
                         % q.device)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if b > 65535 or h > 65535:
        raise ValueError("B=%d, H=%d: the launch grid takes at most 65535 of "
                         "each" % (b, h))
    out = torch.empty_like(q, memory_format=torch.preserve_format)
    if out.numel() == 0:
        return out
    kv_mask, mask_sb = _cuda_mask(kv_mask, b)
    launch = _launcher("short_attention_fwd", 5, 13)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_mask.data_ptr(), out.data_ptr(),
                    _short_fwd_route(q.dtype), b, h, sq, skv, d,
                    *_strides(q), *_strides(k), *_strides(v),
                    *_strides(out), mask_sb, int(bool(causal)),
                    float(scale), stream)
    if rc != 0:
        raise RuntimeError("short_attention_fwd launch failed: CUDA error %d "
                           "(B=%d Sq=%d Skv=%d H=%d D=%d %s)"
                           % (rc, b, sq, skv, h, d, q.dtype))
    short_attention_fwd.launches += 1
    return out


short_attention_fwd.launches = 0


def short_attention_bwd(q, k, v, kv_mask, o, do, causal=False, scale=None):
    """Gradients of the whole-sequence attention (the port of the TPU kernel
    `_short_bwd_kernel`): (dq, dk, dv) in q's dtype and q/k/v's layouts.

    q/k/v/kv_mask as for short_attention_fwd; o is the forward's output and
    do its gradient, both [B,Sq,H,D] with a contiguous head dim. A CUDA
    tensor launches csrc/short_attention_bwd.cu (counted once in
    `short_attention_bwd.launches`) on the route `_short_bwd_route` picks:
    f32, the three CUDA-core passes; bf16 with Sq, Skv <=
    SHORT_BWD_ONE_BLOCK_LEN, one tensor-core block per (b, h); larger bf16,
    the flash backward's tensor-core passes after an LSE pass. A CPU tensor
    takes the plain twin short_attention_bwd_reference."""
    _check_args("short_attention_bwd", q, k, v, kv_mask, SHORT_MAX_KV_LEN)
    _check_grad_args("short_attention_bwd", q, o, do)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return short_attention_bwd_reference(q, k, v, kv_mask, o, do, causal,
                                             scale)
    if q.device.type != "cuda":
        raise ValueError("short_attention_bwd runs on cpu or cuda, got %s"
                         % q.device)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if b > 65535 or h > 65535:
        raise ValueError("B=%d, H=%d: the launch grid takes at most 65535 of "
                         "each" % (b, h))
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.preserve_format)
                  for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    route = _short_bwd_route(q.dtype, sq, skv)
    # f32 scratch the kernels write: route 0 the row max, 1/(sum of exp) and
    # delta, route 2 the LSE, delta and each 128-row chunk's masked-row dO
    # sum [B,H,ceil(Sq/128),D]; route 1 none
    n_stats = {0: 3 * sq, 1: 0, 2: 2 * sq + -(-sq // 128) * d}[route]
    stats = torch.empty(b * h * n_stats, dtype=torch.float32,
                        device=q.device)
    kv_mask, mask_sb = _cuda_mask(kv_mask, b)
    launch = _launcher("short_attention_bwd", 10, 25)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_mask.data_ptr(), o.data_ptr(), do.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                    stats.data_ptr(), route, b, h, sq, skv, d,
                    *_strides(q), *_strides(k), *_strides(v), *_strides(o),
                    *_strides(do), *_strides(dq), *_strides(dk),
                    *_strides(dv), mask_sb, int(bool(causal)), float(scale),
                    stream)
    if rc != 0:
        raise RuntimeError("short_attention_bwd launch failed: CUDA error %d "
                           "(B=%d Sq=%d Skv=%d H=%d D=%d %s)"
                           % (rc, b, sq, skv, h, d, q.dtype))
    short_attention_bwd.launches += 1
    return dq, dk, dv


short_attention_bwd.launches = 0


def _short_fwd_route(dtype):
    """csrc/short_attention_fwd.cu's route (its dtype code): 0 f32 on the
    CUDA cores (the only walk that meets the f32 twin's 2e-5 bound); 1 bf16
    on the tensor cores."""
    return 0 if dtype == torch.float32 else 1


def _short_bwd_route(dtype, sq, skv):
    """csrc/short_attention_bwd.cu's route (its dtype code): 0 f32 on the
    CUDA cores; 1 bf16 in one tensor-core block per (b, h); 2 bf16 through
    the flash backward's tensor-core passes."""
    if dtype == torch.float32:
        return 0
    return 1 if max(sq, skv) <= SHORT_BWD_ONE_BLOCK_LEN else 2


def flash_attention_fwd(q, k, v, kv_mask, causal=False, scale=None):
    """Blocked attention forward for any Skv (the port of the TPU kernel
    `_fwd_kernel`): (O [B,Sq,H,D] in q's dtype, LSE f32 [B,H,Sq]).

    q [B,Sq,H,D], k/v [B,Skv,H,D] with any strides whose head dim is
    contiguous (GPT-2's fused-projection views and a per-layer KV cache
    qualify without a copy); kv_mask [B,Skv] or [1,Skv], int32 or bool;
    causal masking with q_offset = Skv - Sq. A CUDA tensor launches
    csrc/flash_attention_fwd.cu (and counts it in
    `flash_attention_fwd.launches`): f32 on the CUDA cores, bf16 on the
    tensor cores. A CPU tensor takes the plain twin
    flash_attention_fwd_reference. It records no gradient: FlashAttention
    pairs it with flash_attention_bwd."""
    _check_args("flash_attention_fwd", q, k, v, kv_mask)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError(
            "flash_attention_fwd is the bare forward kernel and records no "
            "gradient; call attention() or FlashAttention.apply, whose "
            "backward is flash_attention_bwd")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, kv_mask, causal, scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_fwd runs on cpu or cuda, got %s"
                         % q.device)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if b > 65535 or h > 65535:
        raise ValueError("B=%d, H=%d: the launch grid takes at most 65535 of "
                         "each" % (b, h))
    out = torch.empty_like(q, memory_format=torch.preserve_format)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    kv_mask, mask_sb = _cuda_mask(kv_mask, b)
    launch = _launcher("flash_attention_fwd", 6, 13)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_mask.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    _DTYPE_CODES[q.dtype], b, h, sq, skv, d,
                    *_strides(q), *_strides(k), *_strides(v),
                    *_strides(out), mask_sb, int(bool(causal)),
                    float(scale), stream)
    if rc != 0:
        raise RuntimeError("flash_attention_fwd launch failed: CUDA error %d "
                           "(B=%d Sq=%d Skv=%d H=%d D=%d %s)"
                           % (rc, b, sq, skv, h, d, q.dtype))
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def _check_grad_args(name, q, o, do):
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError("%s: o %s and do %s must have q's shape %s"
                         % (name, tuple(o.shape), tuple(do.shape),
                            tuple(q.shape)))
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("%s: o (%s) and do (%s) must have q's dtype %s"
                         % (name, o.dtype, do.dtype, q.dtype))
    if o.device != q.device or do.device != q.device:
        raise ValueError("%s: o and do must be on q's device" % name)
    _check_rows(o=o, do=do)


def flash_attention_bwd(q, k, v, kv_mask, o, lse, do, causal=False,
                        scale=None):
    """Gradients of the blocked attention (the port of the TPU kernels
    `_bwd_dkdv_kernel` and `_bwd_dq_kernel`): (dq, dk, dv) in q's dtype and
    q/k/v's layouts.

    q/k/v/kv_mask as for flash_attention_fwd; o and lse are its outputs
    (lse f32 [B,H,Sq]) and do the gradient of o, [B,Sq,H,D] with a
    contiguous head dim. A CUDA tensor launches the three kernels of
    csrc/flash_attention_bwd.cu (counted once in
    `flash_attention_bwd.launches`); a CPU tensor takes the plain twin
    flash_attention_bwd_reference."""
    _check_args("flash_attention_bwd", q, k, v, kv_mask)
    _check_grad_args("flash_attention_bwd", q, o, do)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError("lse %s %s on %s: expected float32 [%d,%d,%d] on "
                         "q's device" % (tuple(lse.shape), lse.dtype,
                                         lse.device, b, h, sq))
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, kv_mask, o, lse, do,
                                             causal, scale)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd runs on cpu or cuda, got %s"
                         % q.device)
    if b > 65535 or h > 65535:
        raise ValueError("B=%d, H=%d: the launch grid takes at most 65535 of "
                         "each" % (b, h))
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.preserve_format)
                  for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk, dv
    # delta [B,H,Sq], then the sum of dO over each 128-row chunk's fully
    # masked rows [B,H,ceil(Sq/128),D]: written by the kernel's pre-pass
    scratch = torch.empty(b * h * (sq + -(-sq // 128) * d),
                          dtype=torch.float32, device=q.device)
    lse = lse.contiguous()
    kv_mask, mask_sb = _cuda_mask(kv_mask, b)
    launch = _launcher("flash_attention_bwd", 11, 25)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    kv_mask.data_ptr(), o.data_ptr(), do.data_ptr(),
                    lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                    dv.data_ptr(), scratch.data_ptr(), _DTYPE_CODES[q.dtype],
                    b, h, sq, skv, d,
                    *_strides(q), *_strides(k), *_strides(v), *_strides(o),
                    *_strides(do), *_strides(dq), *_strides(dk),
                    *_strides(dv), mask_sb, int(bool(causal)), float(scale),
                    stream)
    if rc != 0:
        raise RuntimeError("flash_attention_bwd launch failed: CUDA error %d "
                           "(B=%d Sq=%d Skv=%d H=%d D=%d %s)"
                           % (rc, b, sq, skv, h, d, q.dtype))
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class ShortAttention(torch.autograd.Function):
    """Whole-sequence attention with its own backward, as the JAX custom VJP
    `_short_attention` (attention.py:608-653): the forward kernel, then the
    backward kernel from the saved q, k, v, mask and output. Saving the
    output costs nothing in BERT: the output projection keeps the same
    tensor for its own backward."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        o = short_attention_fwd(q, k, v, kv_mask, causal, scale)
        ctx.save_for_backward(q, k, v, kv_mask, o)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o = ctx.saved_tensors
        dq, dk, dv = short_attention_bwd(q, k, v, kv_mask, o,
                                         _kernel_ready(do), ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None, None


class FlashAttention(torch.autograd.Function):
    """Blocked attention with its own backward, as the JAX custom VJP
    `_flash_attention` (attention.py:425): the forward kernel, saving q, k,
    v, the mask, O and the f32 LSE, then the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, kv_mask, causal, scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, o, lse,
                                         _kernel_ready(do), ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None, None


def _kernel_ready(t):
    """t itself when the kernel can read it in place, else a dense copy."""
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and not any(
            s % (16 // t.element_size()) for s in _strides(t)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def attention(q, k, v, kv_mask=None, causal=False, scale=None, bias=None,
              impl="auto", layout="bshd"):
    """Public MHA entry: q [B,Sq,H,D], k/v [B,Skv,H,D], kv_mask [B,Skv] or
    [1,Skv]. layout='bhsd' takes and returns heads-major [B,H,S,D] tensors.

    impl: 'auto' (for a head dim and dtype the kernels take: the short path
    for Skv <= 512, the flash path above it, with or without a gradient;
    attention_reference otherwise), 'short' (the short path or an error),
    'flash' (the flash path or an error), 'reference'. 'ring' is not ported
    yet. An additive `bias` forces the reference path."""
    if impl == "ring":
        raise NotImplementedError(
            "attention(impl='ring') is not ported yet (ROADMAP A24)")
    if impl not in ("auto", "short", "flash", "reference"):
        raise ValueError("unknown attention impl %r" % impl)
    if layout == "bhsd":
        out = attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), kv_mask=kv_mask, causal=causal,
                        scale=scale, bias=bias, impl=impl)
        return out.transpose(1, 2)
    if layout != "bshd":
        raise ValueError("unknown layout %r" % layout)
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if kv_mask is None:
        kv_mask = torch.ones((k.shape[0], k.shape[1]), dtype=torch.int32,
                             device=k.device)
    if bias is not None or impl == "reference":
        return attention_reference(q, k, v, kv_mask=kv_mask, causal=causal,
                                   scale=scale, bias=bias)
    auto = (impl == "auto" and use_kernels() and d % 8 == 0
            and d <= MAX_HEAD_DIM and q.dtype in _DTYPE_CODES)
    if impl == "short" or (auto and k.shape[1] <= SHORT_MAX_KV_LEN):
        return ShortAttention.apply(_kernel_ready(q), _kernel_ready(k),
                                    _kernel_ready(v), kv_mask, causal, scale)
    if impl == "flash" or auto:
        return FlashAttention.apply(_kernel_ready(q), _kernel_ready(k),
                                    _kernel_ready(v), kv_mask, causal, scale)
    return attention_reference(q, k, v, kv_mask=kv_mask, causal=causal,
                               scale=scale)
