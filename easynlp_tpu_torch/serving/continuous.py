"""Continuous batching for decoder-only generation serving, in PyTorch.

Counterpart of easynlp_tpu/serving/continuous.py. Requests JOIN and LEAVE
the decode batch mid-flight: the device always steps a fixed [SLOTS]-wide
batch, while the host scheduler admits waiting prompts into freed slots
between chunks. Slot state lives in fixed [SLOTS, T, H, D] cache tensors
per layer; an admit prefills a bucket of prompts in one batch and writes
their rows into the slots, and a decode step writes each slot's new token
at its own index (modeling_gpt2.py's per-slot cache path).

Decoder-only (GPT-2), token-id API; greedy or per-request sampling
(temperature / top-k / top-p / seed). Token n of a sampled request draws
from a counter-based stream keyed by (seed, n) (generation_utils.
rowwise_warp_and_sample), so a sampled output is a pure function of
(prompt, seed): independent of slot assignment, chunk boundaries,
co-tenants, and of which of the two decoders runs it. Greedy outputs equal
standalone greedy decoding of the prompt.

The JAX package compiles the decode chunk and the admit into jitted
programs; here they are eager PyTorch over the port's kernels (B1 for the
bucketed prefill, B3 for decode past 512 cache slots, B1 below). The
thread batcher keeps `pipeline_depth` dispatches in flight: each chunk's
tokens come back through a non-blocking copy into pinned memory and a CUDA
event, so chunk k + 1 is enqueued before chunk k is read.
DeviceContinuousDecoder drives the same admit and chunk functions
synchronously (PyTorch has no while_loop to compile); its speculative
variant runs verify rounds of [SLOTS, K+1] tokens over the per-slot chunk
path (modeling_gpt2.py), drafts from each slot's own token history.

Under a tensor mesh (a model that parallel/sharding.parallelize split over
`tensor`) every tensor rank holds its heads of the slot caches and runs the
same forwards, whose collectives join the ranks. DeviceContinuousDecoder
needs nothing more: each rank runs the same deterministic schedule on the
same host data and reads the same tokens back. The thread batcher's
schedule depends on when requests arrive, so the group's first rank (the
lead) owns the queue and the schedule: each scheduler pass it sends its
plan (the admits' prompt ids, slots and sampling parameters, the chunk's
active slots and budgets, or stop) to the other ranks over a host-side
gloo group before it dispatches, and they replay it through the same
_admit_rows and _decode_chunk calls (`follow()`). Every wait has a limit:
a follower's wait for the next plan ends after PLAN_TIMEOUT_S seconds
(the lead sends an empty plan each HEARTBEAT_S seconds while idle), the
model's
collectives end at their process group's timeout, and a rank whose process
ends fails the others' pending collectives at once (gloo closes the
connection), so the lead fails its pending requests instead of hanging.
"""

import pickle
import queue
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from easynlp_tpu_torch.modelzoo.generation_utils import (
    left_pad,
    rowwise_warp_and_sample,
)
from easynlp_tpu_torch.modelzoo.models.gpt2.modeling_gpt2 import KVCache
from easynlp_tpu_torch.modelzoo.speculative import (
    prompt_lookup_drafts_rowwise,
)
from easynlp_tpu_torch.parallel.mesh import host_group
from easynlp_tpu_torch.utils.logger import logger

# end-of-stream sentinel for _Pending.stream_q (distinct from any token id
# or exception instance)
_STREAM_END = object()
# the kernels a serving model runs, built before the first request
SERVING_KERNELS = ("short_attention_fwd", "flash_attention_fwd")
# a tensor group's plan channel: a follower's longest wait for the next
# plan, and how often an idle lead sends an empty one
PLAN_TIMEOUT_S, HEARTBEAT_S = 60.0, 1.0


def build_kernels(device):
    """Build (or load from build/kernels/) the attention kernels on a CUDA
    device, so no request pays nvcc inside its timeout. A build failure
    raises here, before the server starts."""
    from easynlp_tpu_torch.ops.attention import use_kernels
    if torch.device(device).type == "cuda" and use_kernels():
        from easynlp_tpu_torch import kernels
        kernels.load_all(SERVING_KERNELS)


class _Pending:
    __slots__ = ("ids", "max_new_tokens", "event", "tokens", "slot",
                 "index0", "dispatched", "error", "do_sample", "temperature",
                 "top_k", "top_p", "seed", "stream_q", "cancelled",
                 "_close_lock", "submitted", "first_token")

    def __init__(self, ids, max_new_tokens, do_sample=False, temperature=1.0,
                 top_k=0, top_p=1.0, seed=0, stream=False):
        self.ids = ids
        self.max_new_tokens = max_new_tokens
        self.do_sample = bool(do_sample)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.event = threading.Event()
        self.tokens: List[int] = []
        self.slot = -1
        self.index0 = 0
        # decode steps sent to the device (>= len(tokens) while results
        # are in flight): budget gating keys off this so the pipelined
        # scheduler never over-dispatches past max_new_tokens
        self.dispatched = 0
        self.error: Optional[BaseException] = None
        # streaming consumers read tokens as the scheduler commits them;
        # the queue carries token ids, then _STREAM_END (or the failure
        # exception) exactly once
        self.stream_q: Optional[queue.Queue] = queue.Queue() if stream \
            else None
        self.cancelled = False
        # push() and close() both take this lock, so a token is either
        # committed before the request resolves or dropped, and exactly one
        # terminal item ends the stream, after every token
        self._close_lock = threading.Lock()
        # host clock at submit and at the first committed token (TTFT)
        self.submitted = time.perf_counter()
        self.first_token = None

    def result(self, timeout=None) -> List[int]:
        if not self.event.wait(timeout):
            raise TimeoutError("generation did not complete in time")
        if self.error is not None:
            raise RuntimeError("generation failed") from self.error
        return self.tokens

    def push(self, tok: int):
        """Commit one generated token (scheduler thread only). The check
        and the append are one step under the close lock: a token is
        dropped once the request resolved (a cancel-before-admit race can
        close() first), so the caller's result() list never grows after it
        returned and no token follows the stream's end. (The JAX package
        checks outside the lock, ROADMAP C6.)"""
        with self._close_lock:
            if self.event.is_set():
                return
            if not self.tokens:
                self.first_token = time.perf_counter()
            self.tokens.append(tok)
            if self.stream_q is not None:
                self.stream_q.put(tok)

    def close(self, error: Optional[BaseException] = None):
        """Resolve the request: wake result() waiters and terminate the
        token stream. Idempotent and thread-safe: the first close wins, so
        a request finished by the scheduler is not re-failed by a racing
        stop()/_fail_all, and exactly one terminal item reaches the
        stream."""
        with self._close_lock:
            if self.event.is_set():
                return
            if error is not None and self.error is None:
                self.error = error
            self.event.set()
            if self.stream_q is not None:
                self.stream_q.put(self.error if self.error is not None
                                  else _STREAM_END)

    def cancel(self):
        """Abandon the request: the scheduler retires its slot at the next
        pass instead of decoding to budget. No-op once resolved; the
        handle resolves with whatever tokens were committed. A request
        still QUEUED resolves here, immediately and empty."""
        self.cancelled = True
        if self.slot < 0:
            self.close()

    def iter_tokens(self, timeout=None):
        """Yield token ids as the batcher commits them (requires
        submit(..., stream=True)). `timeout` bounds the wait for EACH
        token; raises RuntimeError if generation failed mid-stream."""
        if self.stream_q is None:
            raise ValueError(
                "request was not submitted with stream=True")
        while True:
            try:
                item = self.stream_q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    "no token produced within the stream timeout") from None
            if item is _STREAM_END:
                return
            if isinstance(item, BaseException):
                raise RuntimeError("generation failed") from item
            yield item


# placeholder for empty slots when gathering per-slot decode params: plain
# greedy, position 0; its row is inactive so the values never matter
_GREEDY_DEFAULTS = _Pending([], 0)


def _to_device(values, dtype, device):
    """A small host list as a tensor on `device`. On a card the copy goes
    through pinned memory without blocking, so it queues behind the
    dispatches in flight instead of waiting for them."""
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _Fetch:
    """A device tensor on its way to the host: on a card, a non-blocking
    copy into pinned memory and an event recorded after it; numpy() waits
    for that event only."""

    def __init__(self, t):
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def numpy(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _prefill_prefix(model, prefix_ids):
    """One-time KV prefill of a shared prompt prefix: (k, v), per layer
    [1, P0, H, D] in the model's compute dtype, to broadcast across slots."""
    device = model.transformer.wte.weight.device
    p0 = len(prefix_ids)
    pids = torch.tensor([prefix_ids], dtype=torch.long, device=device)
    pmask = torch.ones((1, p0), dtype=torch.int32, device=device)
    with torch.inference_mode():
        cache = model.init_cache(1, p0)
        cache.mask = pmask
        out = model.transformer(pids, attention_mask=pmask, cache=cache)
    return out["cache"].k, out["cache"].v


class _SlotState:
    """The fixed-slot decode state: per-layer k, v [SLOTS, T, H, D] (H this
    rank's heads), mask [SLOTS, T] int32, the write index [SLOTS] and the
    last token [SLOTS] (int64)."""

    def __init__(self, model, slots, t, pad, device):
        c = model.config
        shape = (slots, t, *model.cache_heads())
        self.k = [torch.zeros(shape, dtype=model.dtype, device=device)
                  for _ in range(c.n_layer)]
        self.v = [torch.zeros(shape, dtype=model.dtype, device=device)
                  for _ in range(c.n_layer)]
        self.mask = torch.zeros((slots, t), dtype=torch.int32, device=device)
        self.index = torch.zeros((slots,), dtype=torch.long, device=device)
        self.last = torch.full((slots,), pad, dtype=torch.long, device=device)


class ContinuousBatcher:
    """Slot-based continuous decode over a GPT2LMHeadModel.

    submit() returns a handle whose .result() blocks for the generated ids;
    a background thread steps the shared batch while slots are occupied.
    start=False builds the batcher without its thread (DeviceContinuous-
    Decoder drives it synchronously).

    On a tensor mesh (module docstring) every rank of the tensor group
    builds the batcher with the same arguments (collective: it makes the
    plan group). The lead (`is_lead`, the group's first rank) takes
    submits and runs the scheduler thread; every other rank calls
    `follow()`, which replays the lead's plans until the lead stops.
    """

    def __init__(self, model, max_slots=4, max_length=128,
                 prompt_buckets=(16, 32, 64), eos_token_id=None,
                 pad_token_id=0, chunk_size=8, pipeline_depth=2,
                 shared_prefix=None, fill_window=False, start=True):
        """shared_prefix: token ids of a batcher-wide shared prompt prefix
        (a system prompt). Its KV is prefilled ONCE here and reused by every
        request: submit() then takes only the per-request SUFFIX, admits
        prefill just the suffix at position offset len(prefix), and outputs
        are token-exact vs submitting prefix+suffix to a prefix-less batcher.
        The prefix KV rows are written into each slot at admit time, so
        slot reuse needs no invalidation.

        chunk_size: decode steps per dispatch; joins and retirements happen
        at chunk boundaries, and slots that hit EOS / their budget / the
        cache end deactivate inside the chunk. pipeline_depth: dispatches
        in flight before the oldest result is read (1 = dispatch, then
        wait). fill_window: a request may write the KV window's last slot
        (the JAX device decoder's rule); by default it retires one slot
        short of it (the JAX thread batcher's rule, ROADMAP C14)."""
        self.model = model
        self.device = model.transformer.wte.weight.device
        self.slots = int(max_slots)
        self.max_length = int(max_length)
        self.chunk = max(1, int(chunk_size))
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.prefix = [int(x) for x in (shared_prefix or [])]
        self._p0 = len(self.prefix)
        self.buckets = tuple(sorted(b for b in prompt_buckets
                                    if self._p0 + b < max_length))
        if not self.buckets:
            raise ValueError("need at least one prompt bucket with "
                             "prefix_len + bucket < max_length")
        self.eos = eos_token_id
        self.pad = pad_token_id
        # a request retires once index0 + its tokens reach this
        self._window_end = self.max_length - (0 if fill_window else 1)
        build_kernels(self.device)
        self._state = _SlotState(model, self.slots, self.max_length,
                                 pad_token_id, self.device)
        self._bidx = torch.arange(self.slots, device=self.device)
        self._prefix_kv = (_prefill_prefix(model, self.prefix)
                           if self._p0 else None)
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._occupants: List[Optional[_Pending]] = [None] * self.slots
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._dead: Optional[BaseException] = None
        self._thread = None
        # the tensor group's plan channel (thread batcher on a mesh only)
        self._plan_group, self._lead_rank = None, None
        self.is_lead = True
        self.plan_bytes = 0
        self._last_plan = 0.0
        mesh = getattr(model, "parallel_mesh", None)
        if start and mesh is not None and mesh.size("tensor") > 1:
            self._plan_group = host_group(mesh, "tensor", PLAN_TIMEOUT_S)
            self._lead_rank = mesh.ranks("tensor")[0]
            self.is_lead = mesh.rank == self._lead_rank
        if start and self.is_lead:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    # -- host scheduling ------------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens=32, do_sample=False,
               temperature=1.0, top_k=0, top_p=1.0, seed=0,
               stream=False) -> _Pending:
        """Queue one request. Sampling is per-request: its tokens are a pure
        function of (prompt, seed). `stream=True` also exposes tokens
        through `handle.iter_tokens()` as the scheduler commits them."""
        if not self.is_lead:
            raise RuntimeError("submit to the tensor group's lead rank; "
                               "this rank follows its plans (follow())")
        ids = list(int(x) for x in prompt_ids)
        # fail loudly rather than silently truncate: truncation would break
        # the token-exactness guarantee (output == standalone greedy decode)
        if len(ids) > self.buckets[-1]:
            raise ValueError(
                "prompt length %d exceeds the largest prompt bucket %d; "
                "construct the batcher with a larger prompt_buckets entry"
                % (len(ids), self.buckets[-1]))
        req = _Pending(ids, max_new_tokens, do_sample=do_sample,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       seed=seed, stream=stream)
        if self._dead is not None:
            # scheduler already crashed: fail fast instead of letting the
            # caller block until its result() timeout
            req.close(self._dead)
            return req
        self._queue.put(req)
        # re-check AFTER enqueue: a crash between the check above and the
        # put() would otherwise strand this request past _fail_all's drain
        if self._dead is not None:
            self._fail_all(self._dead)
        self._wake.set()
        return req

    def __call__(self, prompt_ids, max_new_tokens=32):
        return self.submit(prompt_ids, max_new_tokens).result(timeout=600)

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        stopped = RuntimeError("batcher stopped")
        # a stopped scheduler is dead to later submits too
        if self._dead is None:
            self._dead = stopped
        self._fail_all(stopped)

    def _fail_all(self, exc: BaseException):
        """Resolve every in-flight and queued request with an error so no
        caller blocks forever on a dead scheduler."""
        for slot, req in enumerate(self._occupants):
            if req is not None:
                self._occupants[slot] = None
                req.close(exc)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.close(exc)

    def _bucket(self, n):
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    # -- device functions -----------------------------------------------------

    @staticmethod
    def _sampling_lists(reqs, positions):
        """Per-row sampling parameters (host lists, as a plan carries
        them) for rowwise_warp_and_sample."""
        return dict(do_sample=[r.do_sample for r in reqs],
                    temperature=[r.temperature for r in reqs],
                    top_k=[r.top_k for r in reqs],
                    top_p=[r.top_p for r in reqs],
                    seeds=[r.seed for r in reqs], positions=list(positions))

    _SAMPLING_DTYPES = dict(do_sample=torch.bool, temperature=torch.float32,
                            top_k=torch.long, top_p=torch.float32,
                            seeds=torch.long, positions=torch.long)

    def _sampling_args(self, lists):
        """The sampling lists as tensors on the device (None: greedy)."""
        if lists is None:
            return None
        return {k: _to_device(v, self._SAMPLING_DTYPES[k], self.device)
                for k, v in lists.items()}

    def _pick(self, logits, sampling, positions=None):
        if sampling is None:
            return torch.argmax(logits, dim=-1)
        kw = dict(sampling)
        if positions is not None:
            kw["positions"] = positions
        return rowwise_warp_and_sample(logits, **kw)

    def _admit_rows(self, p, ids, mask, sidx, valid, sampling=None):
        """Batched prefill + slot insertion: SLOTS same-bucket prompts
        prefill as one [SLOTS, p] batch and their KV/mask/index/last rows
        are written into the shared state at `sidx`, `valid` gating the
        padding rows (their `sidx` entries are the UNUSED slot numbers, so
        no slot is written twice; they write back the current values).
        Returns the first tokens [SLOTS] on the device (position 0 of each
        request's stream)."""
        model, st = self.model, self._state
        slots, t, p0 = self.slots, self.max_length, self._p0
        pb = p0 + p  # prefilled row extent: shared prefix + this bucket
        cache = model.init_cache(slots, pb)
        positions = None
        if p0:
            # suffix prefill over [prefix KV; suffix]: queries write at
            # offset p0 and see the prefix through the cache mask; positions
            # are absolute (the prefix occupies 0..p0-1)
            pk, pv = self._prefix_kv
            for layer in range(len(cache.k)):
                cache.k[layer][:, :p0] = pk[layer]
                cache.v[layer][:, :p0] = pv[layer]
            cache.index = p0
            cache.mask = torch.cat(
                [torch.ones((slots, p0), dtype=torch.int32,
                            device=self.device), mask], dim=1)
            positions = p0 + (mask.long().cumsum(-1) - 1).clamp(min=0)
        else:
            cache.mask = mask
        out = model.transformer(ids, attention_mask=mask,
                                position_ids=positions, cache=cache)
        logits = model.logits(out["last_hidden_state"][:, -1]).float()
        first = self._pick(logits, sampling)
        vk = valid[:, None, None, None]
        for layer in range(len(st.k)):
            for full, new in ((st.k[layer], cache.k[layer]),
                              (st.v[layer], cache.v[layer])):
                full[sidx, :pb] = torch.where(vk, new.to(full.dtype),
                                              full[sidx, :pb])
        full_mask = torch.zeros((slots, t), dtype=torch.int32,
                                device=self.device)
        full_mask[:, :pb] = cache.mask
        st.mask[sidx] = torch.where(valid[:, None], full_mask, st.mask[sidx])
        st.index[sidx] = torch.where(valid, torch.full_like(st.index, pb),
                                     st.index[sidx])
        st.last[sidx] = torch.where(valid, first, st.last[sidx])
        return first

    def _decode_chunk(self, active, remaining, sampling=None):
        """`chunk` decode steps over all slots; returns the tokens [chunk,
        SLOTS] on the device. `remaining` is each slot's outstanding token
        budget, so in-chunk deactivation mirrors the host's retirement
        conditions (EOS / budget / cache end). Sampling rows draw position
        `positions` of their stream, advancing per active step."""
        model, st = self.model, self._state
        t, pad, eos = self.max_length, self.pad, self.eos
        pos = None if sampling is None else sampling["positions"]
        toks = []
        for _ in range(self.chunk):
            tokens = st.last[:, None]
            # the row's count of real tokens so far, before the new slot
            positions = st.mask.sum(dim=-1, keepdim=True)
            st.mask[self._bidx, st.index] = active.to(torch.int32)
            cache = KVCache(st.k, st.v, st.mask, st.index)
            out = model.transformer(tokens, position_ids=positions,
                                    cache=cache)
            logits = model.logits(out["last_hidden_state"][:, -1]).float()
            picked = self._pick(logits, sampling, pos)
            nxt = torch.where(active, picked, pad)
            st.index = torch.where(active, st.index + 1, st.index)
            remaining = remaining - active.to(remaining.dtype)
            still = active & (remaining > 0) & (st.index < t - 1)
            if eos is not None:
                still = still & (nxt != eos)
            st.last = torch.where(active, nxt, st.last)
            if pos is not None:
                pos = pos + active.to(pos.dtype)
            active = still
            toks.append(nxt)
        return torch.stack(toks)

    # -- the scheduler --------------------------------------------------------

    def _admit_wave(self, wave):
        """Plan the admits of a list of (req, slot) pairs: one dispatch per
        prompt bucket represented in the wave, no host sync: the first
        tokens come back through the pipelined result stream, consumed in
        dispatch order with the chunk results. Slot occupancy and budgets
        update here, at dispatch time. Returns [(plan op, group)]."""
        by_bucket = {}
        for req, slot in wave:
            by_bucket.setdefault(self._bucket(len(req.ids)), []).append(
                (req, slot))
        planned = []
        for p, group in by_bucket.items():
            taken = [slot for _, slot in group]
            spare = [s for s in range(self.slots) if s not in taken]
            sidx = taken + spare[:self.slots - len(taken)]
            valid = [True] * len(taken) + [False] * (self.slots - len(taken))
            rows = [req.ids for req, _ in group]
            rows += [rows[0]] * (self.slots - len(rows))
            ids, mask = left_pad(rows, pad_token_id=self.pad, length=p)
            sampling = None
            if any(req.do_sample for req, _ in group):
                reqs = [req for req, _ in group]
                reqs += [reqs[0]] * (self.slots - len(reqs))
                sampling = self._sampling_lists(reqs, [0] * self.slots)
            for req, slot in group:
                self._occupants[slot] = req
                req.slot = slot
                req.index0 = self._p0 + p
                req.dispatched = 1  # the prefill's first token
            planned.append((("admit", p, ids, mask, sidx, valid, sampling),
                            list(group)))
        return planned

    def _run_op(self, op):
        """Dispatch one plan op on the device: an admit returns the first
        tokens [SLOTS], a chunk the tokens [chunk, SLOTS] (on the device)."""
        dev = self.device
        if op[0] == "admit":
            _, p, ids, mask, sidx, valid, sampling = op
            return self._admit_rows(
                p, _to_device(ids, torch.long, dev),
                _to_device(mask, torch.int32, dev),
                _to_device(sidx, torch.long, dev),
                _to_device(valid, torch.bool, dev),
                self._sampling_args(sampling))
        _, active, remaining, sampling = op
        return self._decode_chunk(_to_device(active, torch.bool, dev),
                                  _to_device(remaining, torch.long, dev),
                                  self._sampling_args(sampling))

    # -- the tensor group's plans -------------------------------------------

    def _publish(self, ops):
        """The lead sends one pass's plan (a list of ops, or "stop") to the
        group before dispatching it; an empty plan only as a heartbeat."""
        if self._plan_group is None:
            return
        now = time.monotonic()
        if not ops and now - self._last_plan < HEARTBEAT_S:
            return
        self._last_plan = now
        data = pickle.dumps(ops)
        self.plan_bytes += len(data)
        size = torch.tensor([len(data)], dtype=torch.long)
        dist.broadcast(size, self._lead_rank, group=self._plan_group)
        dist.broadcast(torch.frombuffer(bytearray(data), dtype=torch.uint8),
                       self._lead_rank, group=self._plan_group)

    def _receive(self):
        size = torch.zeros(1, dtype=torch.long)
        dist.broadcast(size, self._lead_rank, group=self._plan_group)
        data = torch.empty(int(size[0]), dtype=torch.uint8)
        dist.broadcast(data, self._lead_rank, group=self._plan_group)
        self.plan_bytes += int(size[0])
        return pickle.loads(data.numpy().tobytes())

    def follow(self):
        """A follower's loop (every tensor rank but the lead): replay the
        lead's plans until it sends stop. A wait past PLAN_TIMEOUT_S, a
        failed dispatch or a lost peer raises; ending the process then
        fails the lead's pending collectives, and so its requests."""
        if self._plan_group is None or self.is_lead:
            raise RuntimeError("follow() runs on a tensor group's other "
                               "ranks (the lead schedules)")
        with torch.inference_mode():
            while True:
                ops = self._receive()
                if ops == "stop":
                    return
                for op in ops:
                    self._run_op(op)

    def _consume_admit(self, first, group):
        first = first.numpy()  # one wait for the whole bucket group
        for i, (req, slot) in enumerate(group):
            if self._occupants[slot] is not req:
                continue
            first_tok = int(first[i])
            req.push(first_tok)
            if (self.eos is not None and first_tok == self.eos) \
                    or req.max_new_tokens <= 1:
                self._finish(slot)

    def _finish(self, slot: int):
        req = self._occupants[slot]
        self._occupants[slot] = None
        if req is not None:
            req.close()

    def _run(self):
        # any error (a kernel that fails, OOM) is fatal for the loop: the
        # slot state may be half written, so fail every pending request
        # loudly instead of hanging their callers. Grad mode is per thread:
        # inference_mode is entered here, in the scheduler's own thread.
        try:
            with torch.inference_mode():
                inflight = deque()
                while not self._stop.is_set():
                    if not self._schedule_once(inflight):
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()
            self._publish("stop")
        except Exception as exc:  # the thread's boundary: tell the waiters
            logger.exception("continuous batcher: the scheduler failed")
            self._dead = exc
            self._fail_all(exc)
            try:  # the followers stop too, where the channel still works
                self._publish("stop")
            except Exception:  # noqa: BLE001 - a lost peer; already failing
                pass

    def _consume(self, item):
        """Apply one in-flight result. Chunk tokens go to the requests
        occupying the slots AT DISPATCH TIME (`snapshot`); a slot
        retired-then-refilled since then fails the identity check and the
        stale rows are skipped."""
        kind = item[0]
        if kind == "admit":
            self._consume_admit(item[1], item[2])
            return
        _, toks, snapshot = item
        toks = toks.numpy()  # [chunk, SLOTS]: the only per-chunk wait
        for k in range(toks.shape[0]):
            for slot in range(self.slots):
                req = snapshot[slot]
                if req is None or self._occupants[slot] is not req:
                    continue
                if len(req.tokens) >= req.max_new_tokens:
                    continue  # stale over-dispatch past an EOS'd budget
                tok = int(toks[k, slot])
                req.push(tok)
                # host mirrors the slot write index: index0 + steps taken
                done = (self.eos is not None and tok == self.eos) \
                    or len(req.tokens) >= req.max_new_tokens \
                    or req.index0 + len(req.tokens) >= self._window_end
                if done:
                    self._finish(slot)

    def _schedule_once(self, inflight):
        """One scheduler pass: retire cancelled occupants, admit waiting
        requests into free slots, dispatch one decode chunk, consume results
        down to the pipeline depth. Returns False when there was nothing to
        do. Up to `pipeline_depth` dispatches stay in flight, so bookkeeping
        passed to a later dispatch is up to depth-1 chunks stale: budgets
        never over-run (gating keys off `dispatched`, the steps sent), and a
        slot whose EOS the host has not consumed yet is re-stepped, its
        extra tokens dropped by _consume's identity and budget checks."""
        for slot, req in enumerate(self._occupants):
            if req is not None and req.cancelled:
                self._finish(slot)
        wave = []
        for slot in range(self.slots):
            if self._occupants[slot] is not None:
                continue
            req = None
            while req is None:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req.cancelled:
                    # cancelled before admission: resolve empty, never
                    # spend a prefill on it
                    req.close()
                    req = None
            if req is None:
                break
            wave.append((req, slot))
        planned = self._admit_wave(wave) if wave else []
        active_flags = [
            req is not None and req.dispatched < req.max_new_tokens
            and req.index0 + req.dispatched < self._window_end
            for req in self._occupants]
        if any(active_flags):
            remaining = [(req.max_new_tokens - req.dispatched) if is_a else 0
                         for req, is_a in zip(self._occupants, active_flags)]
            occ = [req if req is not None else _GREEDY_DEFAULTS
                   for req in self._occupants]
            sampling = None
            if any(req.do_sample for req, is_a in zip(occ, active_flags)
                   if is_a):
                # stream position of each slot's next token = steps sent
                # for its request so far (prefill = position 0)
                sampling = self._sampling_lists(
                    occ, [r.dispatched for r in occ])
            snapshot = [req if is_a else None for req, is_a
                        in zip(self._occupants, active_flags)]
            for req, is_a in zip(self._occupants, active_flags):
                if is_a:
                    req.dispatched = min(req.dispatched + self.chunk,
                                         req.max_new_tokens)
            planned.append((("chunk", active_flags, remaining, sampling),
                            snapshot))
        ops = [op for op, _ in planned]
        self._publish(ops)
        for op, owners in planned:
            inflight.append((op[0], _Fetch(self._run_op(op)), owners))
        if not any(active_flags) and not inflight:
            return bool(wave)
        # drain down to the pipeline depth; when every occupant has
        # exhausted its dispatch budget, drain fully to learn the outcomes
        limit = self.pipeline_depth if any(active_flags) else 0
        while len(inflight) > limit:
            self._consume(inflight.popleft())
        return True


class DeviceContinuousDecoder:
    """Continuous batching for offline / batch generation: the whole
    request set is known up front.

    The JAX package runs the workload inside one jitted lax.while_loop. The
    port drives the same admit and chunk functions as ContinuousBatcher,
    synchronously in the caller's thread (pipeline depth 1): a freed slot
    is refilled at the next chunk boundary. Same guarantees: greedy
    outputs equal standalone greedy decoding, and sampled outputs equal
    the thread batcher's for the same (prompt, seed). As the JAX device
    decoder, it lets a request fill the window's last slot, which the
    thread batcher does only with fill_window=True (ROADMAP C14).

    speculative=(ngram_size, num_draft_tokens): prompt-lookup speculative
    decoding for greedy calls, as the JAX decoder's: each round drafts K
    tokens per slot from the slot's own committed history (an [SLOTS, T]
    id buffer on the device, the shared prefix included), verifies
    [last, d_1..d_K] in ONE [SLOTS, K+1] forward (per-slot chunk writes
    and the per-row causal bias) and commits the longest draft prefix the
    model's greedy choices agree with, plus one token: token-exact vs the
    plain decoder. A slot retires when fewer than K+1 cache entries
    remain past its index; calls with a sampled request take the plain
    decoder. Each round reads back once (the slots' active flags, which
    decide admission and the loop's end). `last_spec_stats` holds the
    last speculative call's verify_rounds, tokens_committed_in_rounds and
    read_backs.
    """

    def __init__(self, model, max_slots=8, max_length=128,
                 prompt_bucket=32, eos_token_id=None, pad_token_id=0,
                 chunk_size=16, speculative=None, shared_prefix=None):
        self.prefix = [int(x) for x in (shared_prefix or [])]
        self._p0 = len(self.prefix)
        if self._p0 + prompt_bucket >= max_length:
            raise ValueError("prefix_len + prompt_bucket must stay below "
                             "max_length")
        self.slots = int(max_slots)
        self.max_length = int(max_length)
        self.bucket = int(prompt_bucket)
        self.eos, self.pad = eos_token_id, pad_token_id
        self.spec = None
        if speculative is not None:
            ngram, k = (int(x) for x in speculative)
            if k < 1 or ngram < 1:
                raise ValueError("speculative=(ngram_size, num_draft_tokens)"
                                 " needs both >= 1, got %r" % (speculative,))
            if self._p0 + self.bucket + k + 1 >= self.max_length:
                raise ValueError(
                    "speculative verify needs K+1 free cache entries past "
                    "the (shared prefix +) prompt bucket")
            self.spec = (ngram, k)
        self.last_spec_stats = None
        self._engine = ContinuousBatcher(
            model, max_slots=max_slots, max_length=max_length,
            prompt_buckets=(self.bucket,), eos_token_id=eos_token_id,
            pad_token_id=pad_token_id, chunk_size=chunk_size,
            pipeline_depth=1, shared_prefix=shared_prefix,
            fill_window=True, start=False)

    def __call__(self, prompts, max_new_tokens, do_sample=False,
                 temperature=1.0, top_k=0, top_p=1.0, seed=0):
        """prompts: list of token-id lists (each <= prompt_bucket);
        max_new_tokens and the sampling params are an int/scalar or a
        per-request list. Returns a list of generated-token lists (EOS
        included, as in ContinuousBatcher)."""
        n = len(prompts)
        if n == 0:
            return []

        def per_req(x, cast):
            return ([cast(x)] * n if np.isscalar(x)
                    else [cast(v) for v in x])

        budgets = per_req(max_new_tokens, int)
        ds = per_req(do_sample, bool)
        temp = per_req(temperature, float)
        tk = per_req(top_k, int)
        tp = per_req(top_p, float)
        seeds = per_req(seed, int)
        for ids in prompts:
            if len(ids) > self.bucket:
                raise ValueError(
                    "prompt length %d exceeds prompt_bucket %d"
                    % (len(ids), self.bucket))
            if self._p0 and not len(ids):
                raise ValueError(
                    "with shared_prefix each request still needs >= 1 "
                    "suffix token (the admit forward reads its first-token "
                    "logits from the last suffix position)")
        spec = self.spec is not None and not any(ds)
        # a verify round writes K+1 entries, so a slot retires K early
        g = min(max(max(budgets), 1),
                self.max_length - 1 - (self.spec[1] if spec else 0))
        if spec:
            return self._speculative(prompts, [min(b, g) for b in budgets],
                                     g)
        self.last_spec_stats = None
        reqs = [_Pending([int(x) for x in ids], min(b, g), do_sample=d,
                         temperature=te, top_k=k, top_p=p, seed=s)
                for ids, b, d, te, k, p, s
                in zip(prompts, budgets, ds, temp, tk, tp, seeds)]
        engine = self._engine
        for req in reqs:
            if req.max_new_tokens <= 0:
                req.close()  # no token asked for: never admitted
            else:
                engine._queue.put(req)
        inflight = deque()
        with torch.inference_mode():
            while not all(req.event.is_set() for req in reqs):
                if not engine._schedule_once(inflight):
                    raise RuntimeError("the decoder stalled with requests "
                                       "unresolved")
        return [list(req.tokens) for req in reqs]

    def _speculative(self, prompts, budgets, g):
        """The speculative loop (the JAX decoder's _build_spec): admit the
        next requests into the free slots, run one verify round over every
        slot, read the active flags back; until no request waits and no
        slot is active."""
        engine, st = self._engine, self._engine._state
        dev, s_n, t = engine.device, self.slots, self.max_length
        ngram, kd = self.spec
        eos, pad = self.eos, self.pad
        p0, pb = self._p0, self._p0 + self.bucket
        n = len(prompts)
        sink = n  # scatter-sink row of out
        bidx = torch.arange(s_n, device=dev)
        cidx = torch.arange(kd + 1, device=dev)
        ids_buf = torch.full((s_n, t), pad, dtype=torch.long, device=dev)
        if p0:
            ids_buf[:, :p0] = torch.tensor(self.prefix, device=dev)
        st.index = torch.zeros_like(st.index)
        st.mask.zero_()
        out = torch.full((n + 1, g), pad, dtype=torch.long, device=dev)
        written = torch.zeros((n + 1,), dtype=torch.long, device=dev)
        active = torch.zeros((s_n,), dtype=torch.bool, device=dev)
        remaining = torch.zeros((s_n,), dtype=torch.long, device=dev)
        produced = torch.zeros_like(remaining)
        slot_req = torch.full((s_n,), sink, dtype=torch.long, device=dev)
        rounds = torch.zeros((), dtype=torch.long, device=dev)
        committed = torch.zeros_like(rounds)
        budget_t = _to_device(budgets + [0], torch.long, dev)
        active_host, next_req, read_backs = [False] * s_n, 0, 0
        with torch.inference_mode():
            while next_req < n or any(active_host):
                free = [i for i in range(s_n) if not active_host[i]]
                if free and next_req < n:
                    taken = free[:n - next_req]
                    reqi = list(range(next_req, next_req + len(taken)))
                    next_req += len(taken)
                    spare = [i for i in range(s_n) if i not in taken]
                    sidx = taken + spare[:s_n - len(taken)]
                    rows = [list(prompts[r]) for r in reqi]
                    rows += [rows[0]] * (s_n - len(rows))
                    ids, mask = left_pad(rows, pad_token_id=pad,
                                         length=self.bucket)
                    ids = _to_device(ids, torch.long, dev)
                    first = engine._admit_rows(
                        self.bucket, ids, _to_device(mask, torch.int32, dev),
                        _to_device(sidx, torch.long, dev),
                        _to_device([True] * len(taken)
                                   + [False] * (s_n - len(taken)),
                                   torch.bool, dev))
                    sl = _to_device(taken, torch.long, dev)
                    rq = _to_device(reqi, torch.long, dev)
                    first = first[:len(taken)]
                    budget = budget_t[rq]
                    has_tok = budget >= 1
                    out[torch.where(has_tok, rq, sink), 0] = torch.where(
                        has_tok, first, pad)
                    written[rq] = budget.clamp(max=1)
                    still = has_tok & (budget > 1) & (pb + kd + 1 <= t)
                    if eos is not None:
                        still = still & (first != eos)
                    ids_buf[sl, p0:pb] = ids[:len(taken)]
                    active[sl] = still
                    remaining[sl] = budget - 1
                    produced[sl] = budget.clamp(max=1)
                    slot_req[sl] = rq
                self._spec_round(st, ids_buf, active, remaining, produced,
                                 slot_req, out, written, rounds, committed,
                                 bidx, cidx, sink, g)
                active_host = active.tolist()  # the round's one read-back
                read_backs += 1
        self.last_spec_stats = {
            "verify_rounds": int(rounds),
            "tokens_committed_in_rounds": int(committed),
            "read_backs": read_backs}
        out, written = out[:n].cpu().numpy(), written[:n].cpu().numpy()
        return [out[i, :written[i]].tolist() for i in range(n)]

    def _spec_round(self, st, ids_buf, active, remaining, produced,
                    slot_req, out, written, rounds, committed, bidx, cidx,
                    sink, g):
        """One verify round over every slot, in place: drafts, the
        [SLOTS, K+1] forward, acceptance, the commits into the slot state,
        the id buffer and `out`. Retired and empty slots ride along with
        nothing committed (their writes land in slots an admit
        overwrites)."""
        model, t = self._engine.model, self.max_length
        ngram, kd = self.spec
        eos, pad = self.eos, self.pad
        index = torch.where(active, st.index, 0)
        last = st.last
        seq_m = ids_buf.clone()
        seq_m[bidx, index] = last
        val_m = st.mask.clone()
        val_m[bidx, index] = 1
        drafts = prompt_lookup_drafts_rowwise(seq_m, val_m, index + 1, kd,
                                              ngram, pad).long()
        chunk_toks = torch.cat([last[:, None], drafts], dim=1)   # [S, K+1]
        positions = torch.where(
            active[:, None], st.mask.sum(dim=-1, keepdim=True), 0) \
            + cidx[None, :]
        pos = index[:, None] + cidx[None, :]
        mk = st.mask.clone()
        mk[bidx[:, None], pos] = active[:, None].to(torch.int32)
        o = model.transformer(chunk_toks, position_ids=positions,
                              cache=KVCache(st.k, st.v, mk, index))
        gt = torch.argmax(model.logits(o["last_hidden_state"]).float(),
                          dim=-1)                                 # [S, K+1]
        # the longest draft prefix agreeing with the greedy stream
        match = (drafts == gt[:, :kd]).to(torch.int32)
        acc = torch.cumprod(match, dim=1).sum(dim=1)
        n_new = torch.minimum(acc + 1, remaining)
        if eos is not None:
            # stop at the first committed EOS, inclusive
            is_eos = gt == eos
            first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
            n_new = torch.where(is_eos.any(dim=1) & (first_eos + 1 <= n_new),
                                first_eos + 1, n_new)
        n_new = torch.where(active, n_new, 0)
        commit = cidx[None, :] < n_new[:, None]                  # [S, K+1]
        st.mask.scatter_(1, pos, commit.to(torch.int32))
        ids_buf.scatter_(1, pos, torch.where(
            commit, chunk_toks, torch.gather(ids_buf, 1, pos)))
        st.index = torch.where(active, index + n_new, st.index)
        st.last = torch.where(active, torch.gather(
            gt, 1, (n_new - 1).clamp(min=0)[:, None])[:, 0], last)
        remaining -= n_new
        still = active & (remaining > 0) & (index + n_new + kd + 1 <= t)
        if eos is not None:
            still = still & (st.last != eos)
        rows = torch.where(commit, slot_req[:, None], sink)
        cols = (produced[:, None] + cidx[None, :]).clamp(0, g - 1)
        out[rows, cols] = torch.where(commit, gt, pad)
        produced += n_new
        written[slot_req] = produced
        rounds += active.any().to(torch.long)
        committed += n_new.sum()
        active.copy_(still)

