"""Ranks for the port's multi-process CPU tests (tests/test_torch_*.py).

`run_ranks(task, world, workdir, payload, mesh)` starts `world` fresh
Python processes, each a `gloo` rank on the CPU that meets the others
through a file:// rendezvous under `workdir`, lays `mesh` ({axis: size})
over them, runs `TASKS[task](payload)` and saves what it returns under
`workdir`. With device="cuda" every rank runs on cuda:0 (gloo on CUDA
tensors). The processes import torch and the port only (no JAX). Each
group has a time limit: past it every rank is killed and the call raises,
so a test fails rather than hangs. Returns the ranks' results in rank
order.
"""

import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys
sys.path[:0] = [%r, %r]
import torch_parallel_workers as w
w.child(%r, int(sys.argv[1]), %d, %r)
"""


def run_ranks(task, world, workdir, payload=None, mesh=None, timeout=90,
              device="cpu"):
    os.makedirs(workdir, exist_ok=True)
    torch.save({"payload": payload, "mesh": mesh or {"data": world},
                "device": device}, os.path.join(workdir, "payload.pt"))
    code = _CHILD % (REPO, os.path.join(REPO, "tests"), task, world,
                     workdir)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    logs = [open(os.path.join(workdir, "rank%d.log" % r), "w")
            for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env, cwd=REPO)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise TimeoutError("%s on %d ranks passed its %d s limit:\n%s"
                           % (task, world, timeout, _tail(workdir, world)))
    finally:
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError("%s: ranks %s failed:\n%s"
                           % (task, failed, _tail(workdir, world)))
    return [torch.load(os.path.join(workdir, "out%d.pt" % r),
                       weights_only=False) for r in range(world)]


def _tail(workdir, world):
    out = []
    for r in range(world):
        with open(os.path.join(workdir, "rank%d.log" % r)) as f:
            out.append("--- rank %d\n%s" % (r, f.read()[-3000:]))
    return "\n".join(out)


def child(task, rank, world, workdir):
    import torch.distributed as dist

    from easynlp_tpu_torch.parallel import mesh as M
    torch.set_num_threads(1)
    spec = torch.load(os.path.join(workdir, "payload.pt"),
                      weights_only=False)
    global DEVICE, WORKDIR
    WORKDIR = workdir
    DEVICE = torch.device(spec["device"], 0)
    if DEVICE.type == "cuda":
        torch.cuda.set_device(DEVICE)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rdzv"),
        rank=rank, world_size=world)
    M.set_global_mesh(M.build_mesh(spec["mesh"], DEVICE.type))
    try:
        out = TASKS[task](spec["payload"])
        torch.save(out, os.path.join(workdir, "out%d.pt" % rank))
    finally:
        M.destroy()


DEVICE = torch.device("cpu")
WORKDIR = None


def _t(a, **kw):
    return torch.tensor(a, device=DEVICE, **kw)


def _chunk(t, dim=1):
    """This rank's chunk of t along dim over the sequence group."""
    from easynlp_tpu_torch.parallel.mesh import axis_index, axis_size
    n, r = axis_size("sequence"), axis_index("sequence")
    return t.chunk(n, dim=dim)[r]


# ------------------------------------------------------------------ tasks

def ring(cases):
    """Ring attention on this rank's chunks, for each case: the output and
    the gradients of q, k, v for the case's dO."""
    from easynlp_tpu_torch.ops import attention as A
    from easynlp_tpu_torch.ops.attention import attention
    out = []
    for p in cases:
        q, k, v = (_chunk(_t(p[n])).requires_grad_()
                   for n in ("q", "k", "v"))
        mask = _chunk(_t(p["mask"]))
        o = attention(q, k, v, kv_mask=mask, causal=p["causal"],
                      impl="ring")
        o.backward(_chunk(_t(p["do"])))
        out.append({k: t.cpu() for k, t in (
            ("out", o.detach()), ("dq", q.grad), ("dk", k.grad),
            ("dv", v.grad))})
    out.append({"launches": {w: getattr(A, w).launches for w in (
        "flash_attention_fwd", "flash_attention_bwd")}})
    return out


def _batch_rows(batch, micro, accum):
    """This rank's rows of a global batch: its block of every micro-batch
    over the batch axes, as JAX places each micro-batch over the mesh."""
    from easynlp_tpu_torch.parallel.mesh import (data_parallel_rank,
                                                 data_parallel_size)
    dp, i = data_parallel_size(), data_parallel_rank()
    per = micro // dp
    idx = [j * micro + i * per + r for j in range(accum) for r in range(per)]
    return {k: torch.as_tensor(v[idx]) for k, v in batch.items()}


class _Rows:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


def bert_step(p):
    """One Trainer step of text classification on this rank's rows; the
    metrics and the full parameters after it."""
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification, SequenceClassificationModule)
    from easynlp_tpu_torch.core.trainer import Trainer
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.parallel.mesh import (data_parallel_size,
                                                 get_global_mesh)
    from easynlp_tpu_torch.utils.arguments import parse_args
    config = BertConfig(**p["config"])
    module = SequenceClassificationModule(config, num_labels=2)
    module.load_state_dict({k: _t(v) for k, v in p["state"].items()})
    app = SequenceClassification(module, config, "cpu")
    args = parse_args(args_list=["--dtype=float32", "--logging_steps=1000"])
    for k, v in p["args"].items():
        setattr(args, k, v)
    # each rank's loader holds its 1/dp of the rows, as the api slices
    # them: the schedule's t_total is the one-process run's
    trainer = Trainer(app, _Rows(p["rows"] // data_parallel_size()),
                      args=args)
    batch = _batch_rows(p["batch"], args.micro_batch_size,
                        args.gradient_accumulation_steps)
    metrics = []
    for _ in range(p.get("steps", 1)):
        names, values = trainer._train_step(batch)
        metrics.append(dict(zip(names, values.tolist())))
    full = sharding.full_state(module, get_global_mesh())
    return {"metrics": metrics, "params": full}


def bert_ema_resume(p):
    """Two Trainer steps with --ema_decay on the running mesh and a save
    (every rank gathers, the master writes), then a Trainer on a tensor=2
    mesh resumed from that checkpoint: the full EMA shadow before the save
    and after the resume, and the full resumed parameters."""
    import torch.distributed as dist

    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification, SequenceClassificationModule)
    from easynlp_tpu_torch.core.trainer import Trainer
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    from easynlp_tpu_torch.parallel import mesh as M
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.utils.arguments import parse_args

    def trainer(*flags):
        config = BertConfig(**p["config"])
        module = SequenceClassificationModule(config, num_labels=2)
        module.init_weights(torch.Generator().manual_seed(0))
        args = parse_args(args_list=[
            "--dtype=float32", "--logging_steps=1000",
            "--micro_batch_size=%d" % p["micro"], "--ema_decay=0.9",
            "--num_processes=%d" % dist.get_world_size(),
            "--process_index=%d" % dist.get_rank(), *flags])
        app = SequenceClassification(module, config, "cpu")
        return Trainer(app, _Rows(p["rows"] // M.data_parallel_size()),
                       args=args)

    def full(tr, tensors=None):
        return sharding.full_state(tr.app.module, tr.mesh, tensors)

    tr = trainer("--checkpoint_dir=" + p["ckpt"])
    batch = _batch_rows(p["batch"], p["micro"], 1)
    for _ in range(2):
        tr._train_step(batch)
    saved = full(tr, dict(zip(tr.param_names, tr.ema_state["shadow"])))
    tr.save_checkpoint()
    tr._join_pending_save()
    dist.barrier()
    M.set_global_mesh(M.build_mesh({"tensor": 2}))
    tr = trainer("--resume_from_checkpoint=" + p["ckpt"])
    return {"saved": saved, "params": full(tr),
            "resumed": full(tr, dict(zip(tr.param_names,
                                         tr.ema_state["shadow"])))}


def bert_forward(p):
    """The classification module's logits and last hidden state over the
    whole batch on the mesh (tensor or sequence axis)."""
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassificationModule)
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.parallel.mesh import get_global_mesh
    config = BertConfig(**p["config"])
    module = SequenceClassificationModule(config,
                                          num_labels=p.get("num_labels", 2))
    module.load_state_dict({k: _t(v) for k, v in p["state"].items()})
    sharding.parallelize(module, get_global_mesh())
    module.eval()
    with torch.no_grad():
        out = module.backbone(_t(p["input_ids"]),
                              attention_mask=_t(p["attention_mask"]))
        logits = module(_t(p["input_ids"]),
                        attention_mask=_t(p["attention_mask"]))["logits"]
    return {"logits": logits, "hidden": out["last_hidden_state"],
            "pooled": out["pooler_output"]}


def glm_forward(p):
    from easynlp_tpu_torch.modelzoo.models.glm.modeling_glm import (
        GLMConfig, GLMForConditionalGeneration)
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.parallel.mesh import get_global_mesh
    model = GLMForConditionalGeneration(GLMConfig(**p["config"]))
    model.load_state_dict({k: _t(v) for k, v in p["state"].items()})
    sharding.parallelize(model, get_global_mesh())
    model.eval()
    with torch.no_grad():
        out = model(_t(p["input_ids"]), position_ids=_t(p["position_ids"]),
                    block_position_ids=_t(p["block_position_ids"]),
                    prefix_lengths=_t(p["prefix_lengths"]))
    return {"logits": out["logits"]}


def moe_forward(p):
    """GPT-2 with Switch-MoE layers, experts split over the expert axis
    and the batch over the batch axes: the whole batch's logits and the
    aux loss."""
    from easynlp_tpu_torch.modelzoo.models.gpt2 import (GPT2Config,
                                                        GPT2LMHeadModel)
    from easynlp_tpu_torch.parallel import comm, sharding
    from easynlp_tpu_torch.parallel.mesh import (BATCH_AXES, axis_group,
                                                 batch_sharding,
                                                 get_global_mesh)
    model = GPT2LMHeadModel(GPT2Config(**p["config"]))
    model.load_state_dict({k: _t(v) for k, v in p["state"].items()})
    sharding.parallelize(model, get_global_mesh())
    model.eval()
    ids = _t(p["input_ids"])
    start, stop = batch_sharding(ids.shape[0])
    with torch.no_grad():
        out = model(ids[start:stop])
    logits = comm.all_gather(out["logits"], axis_group(BATCH_AXES))
    return {"logits": logits, "aux": out["moe_aux_loss"]}


def gpt2_forward(p):
    """GPT-2's logits over the whole batch on the mesh (on a sequence
    axis the ring: each rank runs its tokens)."""
    from easynlp_tpu_torch.modelzoo.models.gpt2 import (GPT2Config,
                                                        GPT2LMHeadModel)
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.parallel.mesh import get_global_mesh
    model = GPT2LMHeadModel(GPT2Config(**p["config"])).eval()
    model.load_state_dict({k: _t(v) for k, v in p["state"].items()})
    sharding.parallelize(model, get_global_mesh())
    with torch.no_grad():
        out = model(_t(p["input_ids"]),
                    attention_mask=_t(p["attention_mask"]))
    return {"logits": out["logits"]}


def gpipe_run(p):
    """gpipe over the group of the mesh axis p["axis"] (its stages): this
    rank's stage is its slab of the stacked two-layer MLP; outputs and the
    slab's gradients of mean(y ** 2), and the gradient of x."""
    from easynlp_tpu_torch.parallel.mesh import (axis_group, axis_index,
                                                 axis_size)
    from easynlp_tpu_torch.parallel.pipeline import gpipe
    axis = p["axis"]
    n, r = axis_size(axis), axis_index(axis)
    names = ("w1", "b1", "w2", "b2")
    slab = [_t(p["params"][k]).chunk(n)[r].clone().requires_grad_()
            for k in names]

    def stage(params, x):
        w1, b1, w2, b2 = params
        for i in range(w1.shape[0]):
            x = torch.tanh(x @ w1[i] + b1[i]) @ w2[i] + b2[i]
        return x

    x = _t(p["x"]).requires_grad_()
    y = gpipe(stage, slab, x, p["microbatches"], group=axis_group(axis))
    (y ** 2).mean().backward()
    return {"y": y.detach(), "dx": x.grad,
            "grads": {k: t.grad for k, t in zip(names, slab)}}


def vocab_ce(cases):
    """vocab_parallel_cross_entropy on this rank's (padded) columns, for
    each case: the loss and the whole logits' gradient."""
    from easynlp_tpu_torch.ops.fused_ce import vocab_parallel_cross_entropy
    from easynlp_tpu_torch.parallel import comm
    from easynlp_tpu_torch.parallel.mesh import (axis_group, axis_index,
                                                 axis_size)
    n, r = axis_size("tensor"), axis_index("tensor")
    out = []
    for p in cases:
        logits = _t(p["logits"])
        v = logits.shape[1]
        per = -(-v // n)
        padded = torch.cat([logits, logits.new_zeros(logits.shape[0],
                                                     per * n - v)], 1)
        local = padded.chunk(n, dim=1)[r].clone().requires_grad_()
        loss = vocab_parallel_cross_entropy(local, _t(p["labels"]),
                                            vocab_size=v)
        loss.backward()
        grad = comm.all_gather(local.grad, axis_group("tensor"),
                               dim=1)[:, :v]
        out.append({"loss": loss.detach(), "grad": grad})
    return out


def _tp_gpt2(p):
    """GPT-2 from the payload's config and state, split over the mesh."""
    from easynlp_tpu_torch.modelzoo.models.gpt2 import (GPT2Config,
                                                        GPT2LMHeadModel)
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.parallel.mesh import get_global_mesh
    model = GPT2LMHeadModel(GPT2Config(**p["config"])).eval().to(DEVICE)
    model.load_state_dict({k: _t(v) for k, v in p["state"].items()})
    return sharding.parallelize(model, get_global_mesh())


def gpt2_tp_decoding(p):
    """GPT-2 split over the mesh: its logits and gathered parameters, then
    each of p["generate"]'s generate() calls ({name: (max_length, slack,
    kwargs)}; `shared` drops the per-row speculative chunk), those of
    p["refused"] ({name: (max_length, kwargs)}: the tokens, or the
    ValueError's message where generate() refuses the call), the device
    decoder over p["decoder"] and the thread batcher's requests
    p["batcher"] (submitted on the tensor group's lead; the others
    follow). Returns {name: result}."""
    from easynlp_tpu_torch.modelzoo.generation_utils import generate
    from easynlp_tpu_torch.modelzoo.models.gpt2.generation import (
        make_gpt2_generation_fns)
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.parallel.mesh import get_global_mesh
    from easynlp_tpu_torch.serving.continuous import (
        ContinuousBatcher, DeviceContinuousDecoder)
    from easynlp_tpu_torch.ops import attention as A
    model = _tp_gpt2(p)
    out = {}
    wrappers = ("short_attention_fwd", "flash_attention_fwd")
    for w in wrappers:
        getattr(A, w).launches = 0
    with torch.no_grad():
        if "input_ids" in p:
            out["logits"] = model(_t(p["input_ids"]), attention_mask=_t(
                p["attention_mask"]))["logits"].cpu()
            out["params"] = {k: v.cpu() for k, v in sharding.full_state(
                model, get_global_mesh()).items()}
            out["local_shapes"] = {k: tuple(v.shape)
                                   for k, v in model.named_parameters()}
        for name, (max_length, slack, kw) in p.get("generate", {}).items():
            kw = dict(kw)
            prefill, decode = make_gpt2_generation_fns(model, max_length,
                                                       cache_slack=slack)
            if kw.pop("shared", False):
                del decode.chunk_rowwise
            if "row_seeds" in kw:
                kw["row_seeds"] = _t(kw["row_seeds"])
            out[name] = generate(prefill, decode, _t(kw.pop("ids")),
                                 _t(kw.pop("mask")), max_length=max_length,
                                 **kw).cpu()
        for name, (max_length, kw) in p.get("refused", {}).items():
            kw = dict(kw)
            prefill, decode = make_gpt2_generation_fns(model, max_length)
            if "row_seeds" in kw:
                kw["row_seeds"] = _t(kw["row_seeds"])
            try:
                out[name] = generate(prefill, decode, _t(kw.pop("ids")),
                                     _t(kw.pop("mask")),
                                     max_length=max_length, **kw).cpu()
            except ValueError as exc:
                out[name] = str(exc)
    out["launches"] = {w: getattr(A, w).launches for w in wrappers}
    if "decoder" in p:
        d = p["decoder"]
        dec = DeviceContinuousDecoder(model, **d["init"])
        out["decoder"] = dec(d["prompts"], **d["call"])
    if "batcher" in p:
        b = p["batcher"]
        batcher = ContinuousBatcher(model, **b["init"])
        if batcher.is_lead:
            handles = [batcher.submit(ids, **kw) for ids, kw in b["requests"]]
            out["batcher"] = [h.result(timeout=60) for h in handles]
            batcher.stop()
        else:
            batcher.follow()
        out["plan_bytes"] = batcher.plan_bytes
    return out


def gpt2_tp_follower_fails(p):
    """The thread batcher on a tensor group whose follower fails at its
    second decode chunk: the follower ends its process (after writing its
    result); the lead's requests must fail, not hang."""
    from easynlp_tpu_torch.serving.continuous import ContinuousBatcher
    model = _tp_gpt2(p)
    batcher = ContinuousBatcher(model, **p["init"])
    if not batcher.is_lead:
        calls = []
        chunk = batcher._decode_chunk

        def failing(*args):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("injected follower failure")
            return chunk(*args)

        batcher._decode_chunk = failing
        try:
            batcher.follow()
            err = None
        except RuntimeError as exc:
            err = str(exc)
        rank = torch.distributed.get_rank()
        torch.save({"error": err}, os.path.join(WORKDIR, "out%d.pt" % rank))
        os._exit(0)  # the process ends: the lead's collectives fail now
    start = time.monotonic()
    handles = [batcher.submit(ids, **kw) for ids, kw in p["requests"]]
    errors = []
    for h in handles:
        try:
            h.result(timeout=60)
            errors.append(None)
        except RuntimeError as exc:
            errors.append(repr(exc.__cause__))
    batcher.stop()
    return {"errors": errors, "seconds": time.monotonic() - start}


def several(jobs):
    """Several tasks on one group, in turn: [(task, payload), ...] -> their
    results (one process start for checks that share a mesh)."""
    return [TASKS[task](payload) for task, payload in jobs]


TASKS = {"ring": ring, "bert_step": bert_step, "bert_forward": bert_forward,
         "bert_ema_resume": bert_ema_resume,
         "glm_forward": glm_forward, "moe_forward": moe_forward,
         "gpt2_forward": gpt2_forward, "gpt2_tp_decoding": gpt2_tp_decoding,
         "gpt2_tp_follower_fails": gpt2_tp_follower_fails,
         "gpipe": gpipe_run, "vocab_ce": vocab_ce, "several": several}
