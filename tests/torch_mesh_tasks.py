"""Rank tasks for tests/test_torch_tp_families.py and
tests/test_torch_mesh_trainer.py, run by torch_parallel_workers.run_ranks
under the names 'mesh_cases' and 'trainer_jobs'. They import torch and the
port only (no JAX); `build` and `run_case` also give the tests their
one-process runs of the same cases.

A case is a dict:
  ctor      'module:Class' of the port module, or of an app whose
            build_module makes it (with app=True the app wraps it and
            its forward takes the inputs as a batch);
  config    ('module:ConfigClass', kwargs);
  setup     [('module:NAME', value)] set while the module is built
            (BLOOM's activation);
  state     {name: numpy array}, loaded strictly;
  inputs    {name: numpy array};
  calls     {name: ('module:function', kwargs)}: function(model, **kwargs)
            after the forward, kwargs' numpy arrays as tensors (generate);
  probe     the output keys a loss reads: sum over them of
            mean(out * cos(arange)), whose gradients are returned whole;
  probe_masks {key: numpy array} multiplying that key's weights (BLOOM's
            real rows).
"""

import contextlib
import importlib

import numpy as np
import torch

import torch_parallel_workers as W


def _import(path):
    module, _, name = path.partition(":")
    return getattr(importlib.import_module(module), name)


def _tensor(v):
    return torch.as_tensor(np.asarray(v), device=W.DEVICE)


@contextlib.contextmanager
def setup(pairs):
    """Module constants [('module:NAME', value)] set for the block."""
    saved = []
    for path, value in pairs:
        module, _, name = path.partition(":")
        module = importlib.import_module(module)
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)
    try:
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def build(case):
    """The case's module (and app, or None), its weights loaded."""
    config = _import(case["config"][0])(**case["config"][1])
    cls = _import(case["ctor"])
    with setup(case.get("setup", ())):
        if case.get("app"):
            model = cls.build_module(config, dtype=torch.float32,
                                     device="cpu")
        else:
            model = cls(config)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in case["state"].items()}, strict=True)
    model = model.to(W.DEVICE).eval()
    app = cls(model, config, "cpu") if case.get("app") else None
    return model, app


def probe_loss(out, keys, masks=None):
    loss = 0.0
    for k in keys:
        v = out[k].float()
        w = torch.cos(torch.arange(v.numel(), dtype=torch.float32,
                                   device=v.device)).view(v.shape)
        if masks and k in masks:
            w = w * _tensor(masks[k])
        loss = loss + (v * w).mean()
    return loss


def run_case(case, mesh=None):
    """Forward (and the probe's backward) of the case on `mesh` (None:
    one process): {'out': outputs, 'grads': full gradients, 'calls':
    {name: result}, 'local_shapes': {name: shape}}."""
    from easynlp_tpu_torch.parallel import sharding
    model, app = build(case)
    sharding.parallelize(model, mesh)
    inputs = {k: _tensor(v) for k, v in case["inputs"].items()}
    out = app.forward(inputs) if app is not None else model(**inputs)
    result = {"out": {k: v.detach().cpu() for k, v in out.items()
                      if torch.is_tensor(v)}}
    if case.get("probe"):
        probe_loss(out, case["probe"], case.get("probe_masks")).backward()
        grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None}
        if mesh is not None:
            grads = sharding.full_state(model, mesh, grads)
        result["grads"] = {k: v.cpu() for k, v in grads.items()}
    result["calls"] = {}
    with torch.no_grad():
        for name, (fn, kw) in case.get("calls", {}).items():
            kw = {k: _tensor(v) if isinstance(v, np.ndarray) else v
                  for k, v in kw.items()}
            got = _import(fn)(app if app is not None else model, **kw)
            result["calls"][name] = got.cpu() if torch.is_tensor(got) \
                else got
    result["local_shapes"] = {n: tuple(p.shape)
                              for n, p in model.named_parameters()}
    result["specs"] = sorted(getattr(model, "parallel_specs", {}))
    return result


def cases(payload):
    """run_case of each case on the running mesh, then the refusals:
    {'results': [...], 'refused': {name: message}}."""
    from easynlp_tpu_torch.parallel.mesh import get_global_mesh
    mesh = get_global_mesh()
    out = {"results": [run_case(c, mesh) for c in payload["cases"]],
           "refused": {}}
    for name, case in payload.get("refused", {}).items():
        try:
            model, _ = build(case)
            _import(case["before"])(model)
            from easynlp_tpu_torch.parallel import sharding
            sharding.parallelize(model, mesh)
            out["refused"][name] = None
        except NotImplementedError as exc:
            out["refused"][name] = str(exc)
    return out


# ---------------------------------------------------------------- generate

def bart_generate(model, ids, mask, max_length, num_beams):
    from easynlp_tpu_torch.modelzoo.seq2seq_generation import (
        encoder_decoder_generate)
    return encoder_decoder_generate(model, ids.long(), mask,
                                    max_length=max_length,
                                    num_beams=num_beams)


def artist_generate(app, ids, mask):
    return app.generate(ids.cpu().numpy(), mask.cpu().numpy(),
                        do_sample=False)


def quantize_int8(model):
    from easynlp_tpu_torch.modelzoo.quantization import quantize_params
    quantize_params(model, min_size=1)


# ----------------------------------------------------------------- Trainer

def trainer_app(job):
    """The job's app on W.DEVICE: text classification ('bert_cls'),
    seq2seq ('bart_gen') or latent diffusion ('ldm'), weights from its
    state (its module built under the job's `setup` constants), wrapped in
    LoRA where the job asks."""
    if job["app"] == "bert_cls":
        from easynlp_tpu_torch.appzoo.sequence_classification.model import (
            SequenceClassification as App)
        from easynlp_tpu_torch.modelzoo.models.bert import BertConfig as Cfg
    elif job["app"] == "bart_gen":
        from easynlp_tpu_torch.appzoo.sequence_generation.model import (
            SequenceGeneration as App)
        from easynlp_tpu_torch.modelzoo.models.bart import BartConfig as Cfg
    else:
        from easynlp_tpu_torch.appzoo.latent_diffusion.model import (
            LatentDiffusion as App)
        from easynlp_tpu_torch.appzoo.latent_diffusion.model import (
            LDMConfig as Cfg)
    config = Cfg(**job["config"])
    kw = {"num_labels": 2} if job["app"] == "bert_cls" else {}
    with setup(job.get("setup", ())):
        module = App.build_module(config, dtype=torch.float32,
                                  device=str(W.DEVICE), **kw)
    module.load_state_dict({k: torch.from_numpy(np.asarray(v))
                            for k, v in job["state"].items()}, strict=True)
    app = App(module, config, W.DEVICE if W.DEVICE.type == "cuda"
              else torch.device("cpu"))
    if job.get("lora"):
        from easynlp_tpu_torch.core.lora_app import LoRAApplication
        app = LoRAApplication(app, **job["lora"])
    return app


def run_trainer_job(job):
    """Trainer steps of the job on the running mesh (none: one process):
    {'metrics': per step, 'params': the whole parameters after them,
    'adapters': the whole LoRA adapters (LoRA jobs)}. `save` writes a
    checkpoint after the steps (the master writes); `resume` resumes from
    one first."""
    import torch.distributed as dist

    from easynlp_tpu_torch.core.trainer import Trainer
    from easynlp_tpu_torch.parallel import sharding
    from easynlp_tpu_torch.parallel.mesh import (data_parallel_size,
                                                 get_global_mesh)
    from easynlp_tpu_torch.utils.arguments import parse_args
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    argv = ["--dtype=float32", "--logging_steps=1000",
            "--micro_batch_size=%d" % job["micro"],
            "--num_processes=%d" % world, "--process_index=%d" % rank,
            "--random_seed=%d" % job.get("seed", 1)] + list(job["argv"])
    if job.get("save"):
        argv.append("--checkpoint_dir=" + job["save"])
    if job.get("resume"):
        argv.append("--resume_from_checkpoint=" + job["resume"])
    args = parse_args(args_list=argv)
    torch.manual_seed(job.get("seed", 1))
    app = trainer_app(job)
    trainer = Trainer(app, W._Rows(job["rows"] // data_parallel_size()),
                      args=args)
    metrics = []
    for batch in job["batches"]:
        batch = W._batch_rows(batch, job["micro"], 1)
        batch = {k: v.to(W.DEVICE) for k, v in batch.items()}
        names, values = trainer._train_step(batch)
        metrics.append(dict(zip(names, values.tolist())))
    mesh = get_global_mesh()
    mesh = mesh if mesh is not None and mesh.world_size > 1 else None
    module = trainer.app.module
    params = sharding.full_state(module, mesh) if mesh is not None \
        else dict(module.named_parameters())
    out = {"metrics": metrics,
           "params": {sharding.plain_name(k): v.detach().cpu().clone()
                      for k, v in params.items()}}
    if job.get("save"):
        trainer.save_checkpoint()
        trainer._join_pending_save()
        if dist.is_initialized():
            dist.barrier()
    return out


def trainer_jobs(jobs):
    """run_trainer_job of each job, each on its mesh ({axis: size}), laid
    over the running group in turn."""
    from easynlp_tpu_torch.parallel import mesh as M
    out = []
    for job in jobs:
        M.set_global_mesh(M.build_mesh(job["mesh"], W.DEVICE.type))
        out.append(run_trainer_job(job))
    return out
