"""Training loop for the PyTorch port.

Counterpart of easynlp_tpu/core/trainer.py, on one device or on the
process mesh (parallel/mesh.py):

- the shuffled, drop-last DataLoader (the port's copy of the JAX package's:
  the same batches in the same order for the same seed), global batch = micro batch x
  gradient_accumulation_steps, fed through data/prefetch.py's
  device_prefetch (--num_host_prefetch batches staged ahead in pinned
  memory and copied on a side stream; 0 turns it off);
- the optimizer from core/optimizers.get_optimizer with
  t_total = ceil(steps per epoch) x epochs, built with max_grad_norm=0: the
  step clips by the global norm itself, c / max(norm, c), before the update;
- gradient accumulation: the micro-batches' gradients are summed and divided
  by their count, the loss metrics likewise;
- the non-finite guard, decided on the device as the JAX step decides it:
  a step whose loss or gradient norm is not finite leaves parameters and
  optimizer state (its step count included, which the schedule and the
  bias correction read) exactly as they were and counts `nonfinite_skip`;
  nothing waits for the device in a step;
- bf16 compute on f32 master weights: the modules cast f32 parameters to
  the compute dtype inside autograd, so gradients arrive in f32 and no
  autocast or loss scaler is needed;
- logging through Statistics (events.jsonl), evaluation on every save
  with the best score kept, checkpoints as `pytorch_model.bin` (HF names)
  plus the JAX package's other artifacts, and resume with the mid-epoch skip;
- on a mesh of more than one process: the module split over the tensor,
  expert and fsdp axes (parallel/sharding.parallelize, JAX _place_state
  :141-167), the global batch (micro x accum) split over the batch axes
  (each rank's dataset holds its rows: the api slices them), so each rank
  steps on micro / dp rows a micro-batch; the gradients
  averaged over the ranks that hold other tokens (FSDP2 reduces over data
  and fsdp itself, the rest is one all_reduce of the flattened
  gradients), the loss metrics averaged likewise, the global gradient norm
  summed over the split parameters' groups, so every rank takes the same
  skip and clip; evaluation on every rank with rank 0's score broadcast
  before the save decision (JAX :382-387: the gathers below would
  deadlock if ranks decided apart); the save gathers the full weights and
  optimizer state on every rank and the master alone writes them, so a
  checkpoint trained on a mesh loads into one process under the usual
  file names (JAX :408-428, :501-507); resume loads the full weights
  (and the EMA weights) before the split and splits the optimizer state
  and the EMA shadow as their parameters. Every app trains there:
  an app's own resume (`restore_params`: LoRA's base and adapters,
  ControlNet's) loads the whole weights before the split, LoRA's adapters
  split with their weights (core/lora_app.py), a loss that draws its own
  randomness (`make_train_loss`) draws the global batch's and takes the
  rank's rows, --remat recomputes the layers' collectives in the
  backward, and Adafactor reduces its statistics over the groups that
  split each parameter (core/optimizers.py), its factored state whole on
  every rank;
- `--remat` (modeling_bert.set_remat: activation checkpointing of each
  BERT and BART layer under the JAX package's policies);
- `--ema_decay`: an f32 EMA of the trained parameters on the device
  (modelzoo/models/latent_diffusion/ema.py), updated after every step,
  skipped ones included, as the JAX Trainer does; saved as
  `pytorch_model_ema.bin` with `ema_num_updates` in meta.json, and
  restored on resume;
- `--async_save`: the checkpoint is copied to host memory on the training
  thread (a finished snapshot: the optimizers update the parameters in
  place) and written by a background thread, at most one write in
  flight; a failed write raises at the next save or at the end;
- only the parameters that require a gradient are trained (LoRA and
  ControlNet freeze their base), and an app may hook the checkpoint as the
  JAX package's LoRA does: `extra_save_artifacts()`, `restore_params(dir)`;
- an app whose loss draws its own randomness (latent diffusion: timesteps,
  noise, a posterior sample) gives `make_train_loss()`, the JAX Trainer's
  hook: loss_fn(batch, generator) -> {"loss": ...}, the generator a CPU
  torch.Generator seeded with --random_seed; an app may name another to
  evaluate (`eval_target`: ControlNet evaluates itself, not its base).

Losses, gradient norms and skips stay on the device until a logging step,
which reads every step since the last one back in one copy. Then
`step_records` gains one record per step: step, loss, grad_norm, lr,
nonfinite_skip and seconds, the time from the end of the previous step
(or, first, from just before the batch is fetched) to the end of this
one's optimizer update, read on a card from CUDA events on the device's
timeline: the device's work, and its idle time while the host fetched the
batch or launched the step. On the CPU, which runs synchronously, from the
host clock.
"""

import contextlib
import json
import math
import os
import threading
import time

import torch

from easynlp_tpu_torch.core.optimizers import (get_optimizer, global_norm,
                                               norms)
from easynlp_tpu_torch.data.dataset import DataLoader
from easynlp_tpu_torch.data.prefetch import device_prefetch
from easynlp_tpu_torch.modelzoo.modeling_utils import (
    PYTORCH_WEIGHTS_NAME,
    host_copy,
    load_pytorch_state_dict,
    substituted,
)
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import set_remat
from easynlp_tpu_torch.modelzoo.models.latent_diffusion.ema import (
    ema_init,
    ema_update,
)
from easynlp_tpu_torch.parallel import comm, sharding
from easynlp_tpu_torch.parallel.mesh import BATCH_AXES, get_global_mesh
from easynlp_tpu_torch.utils.global_vars import get_args
from easynlp_tpu_torch.utils.io_utils import io
from easynlp_tpu_torch.utils.logger import logger
from easynlp_tpu_torch.utils.statistics import Statistics

META_NAME = "meta.json"
OPT_STATE_NAME = "optimizer.pt"
EMA_WEIGHTS_NAME = "pytorch_model_ema.bin"


class StepClock:
    """Marks for step times: CUDA events on a card (the time between two
    covers the device's work and its idle gaps), the host clock on the
    CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def seconds(self, start, end):
        """Seconds from `start` to `end` (both reached)."""
        if self.cuda:
            return start.elapsed_time(end) / 1e3
        return end - start


class Trainer:
    def __init__(self, model, train_dataset, evaluator=None, args=None,
                 tokenizer=None):
        """model: an Application (module on its device, config,
        label_mapping). train_dataset: a BaseDataset."""
        self.args = args = args or get_args()
        self.app = model
        self.evaluator = evaluator
        self.tokenizer = tokenizer
        mesh = get_global_mesh()
        self.mesh = mesh if mesh is not None and mesh.world_size > 1 \
            else None
        self.dp = mesh.size(BATCH_AXES) if self.mesh else 1
        self.accum = max(1, args.gradient_accumulation_steps)
        global_batch = args.micro_batch_size * self.accum
        if args.micro_batch_size % self.dp:
            raise ValueError("--micro_batch_size=%d does not split over %d "
                             "data-parallel ranks"
                             % (args.micro_batch_size, self.dp))
        self.micro = args.micro_batch_size // self.dp
        self.train_loader = DataLoader(
            train_dataset, batch_size=global_batch // self.dp, shuffle=True,
            seed=args.random_seed,
            num_workers=getattr(args, "data_workers", 0))
        self.steps_per_epoch = max(1, len(self.train_loader))
        self.remat = getattr(args, "remat", "none") or "none"
        set_remat(self.app.module, self.remat)
        if self.mesh is not None:
            self._place_state(args)
        # frozen parameters (LoRA's base) get no optimizer state and no
        # update, as the JAX Trainer's trainable_mask
        trained = [(n, p) for n, p in self.app.module.named_parameters()
                   if p.requires_grad]
        self.param_names = [n for n, _ in trained]
        # the module's own parameters (DTensors under FSDP2); the optimizer
        # and self.params hold their local parts
        self.module_params = [p for _, p in trained]
        # where each parameter is split (Adafactor's statistics reduce over
        # it; the element-wise optimizers ignore it)
        splits = sharding.param_splits(self.app.module, self.mesh,
                                       self.param_names)
        trained = [(n, sharding.local(p)) for n, p in trained]
        self.optimizer, self.schedule_fn, self.t_total = get_optimizer(
            trained,
            optimizer_type=args.optimizer_type,
            learning_rate=args.learning_rate,
            warmup_proportion=args.warmup_proportion,
            lr_scheduler=args.lr_scheduler,
            epoch_num=args.epoch_num,
            steps_per_epoch=self.steps_per_epoch,
            gradient_accumulation_steps=1,  # accumulation is inside the step
            weight_decay=args.weight_decay,
            max_grad_norm=0.0,  # the step clips, sharing the guard's norm
            b1=args.adam_beta1, b2=args.adam_beta2, eps=args.adam_epsilon,
            splits=splits)
        self.max_grad_norm = float(args.max_grad_norm or 0.0)
        self.params = self.optimizer.params
        self.custom_loss = (self.app.make_train_loss()
                            if hasattr(self.app, "make_train_loss") else None)
        self.generator = torch.Generator().manual_seed(args.random_seed)
        self.prefetch_depth = int(getattr(args, "num_host_prefetch", 2))
        self.clock = StepClock(self.app.device)
        self._pending = []  # steps not yet read back
        self.ema_decay = float(getattr(args, "ema_decay", 0.0) or 0.0)
        self.ema_state = ema_init(self.params) if self.ema_decay > 0 \
            else None
        self.async_save = bool(getattr(args, "async_save", False))
        self._save_thread = None
        self._save_error = None

        self.global_step = 0
        self.start_epoch = 0
        self._resume_skip_batches = 0
        self.best_score = -float("inf")
        self.nonfinite_skips = 0
        self.step_records = []
        self.save_seconds = []
        self._profiler = None
        if args.resume_from_checkpoint:
            self.resume_from_ckpt(args.resume_from_checkpoint)
        self.stats = Statistics(args)
        logger.info(
            "Trainer: %d params | %d steps/epoch x %s epochs (t_total %d) | "
            "global batch %d (micro %d x accum %d) | device %s | mesh %s",
            sum(p.numel() for p in self.params), self.steps_per_epoch,
            args.epoch_num, self.t_total, global_batch,
            args.micro_batch_size, self.accum, self.app.device, self.mesh)

    # ----------------------------------------------------------------- mesh
    def _place_state(self, args):
        """Split the module over the mesh (JAX _place_state): the full
        weights to resume from go in first (through the app's own
        restore_params where it has one, JAX :523-527), then
        parallelize."""
        ckpt = args.resume_from_checkpoint
        self._ema_resume = None
        if ckpt and io.exists(os.path.join(ckpt, META_NAME)):
            ema_path = os.path.join(ckpt, EMA_WEIGHTS_NAME)
            if float(getattr(args, "ema_decay", 0.0) or 0.0) > 0 \
                    and io.exists(ema_path):
                # the EMA weights go in through the module too (the file
                # has the export's names) and are kept whole until
                # resume_from_ckpt splits them as their parameters
                self.app.load_state_dict(self.app.module,
                                         load_pytorch_state_dict(ema_path))
                self._ema_resume = {
                    n: p.detach().clone()
                    for n, p in self.app.module.named_parameters()}
            restore = getattr(self.app, "restore_params", None)
            if restore is not None:
                restore(ckpt)
            else:
                self.app.load_state_dict(self.app.module,
                                         load_pytorch_state_dict(ckpt))
        sharding.parallelize(self.app.module, self.mesh)

    def _reduce_gradients(self, grads):
        """Average the gradients over the ranks that hold other tokens:
        every such rank's loss is the mean over its own rows. FSDP2 has
        averaged over data and fsdp; expert parameters are averaged over
        the data axes and divided by the expert count (each owner summed
        its expert group's contributions through all_to_all)."""
        mesh = self.mesh
        fsdp = mesh.size("fsdp") > 1
        dense_axes = ("expert", "sequence") if fsdp \
            else BATCH_AXES + ("sequence",)
        expert_axes = ("sequence",) if fsdp \
            else ("data", "fsdp", "sequence")
        expert = [getattr(p, "expert_parallel", False)
                  for p in self.module_params]
        for axes, pick, extra in (
                (dense_axes, False, 1),
                (expert_axes, True, mesh.size("expert"))):
            chosen = [g for g, e in zip(grads, expert) if e == pick]
            n = mesh.size(axes) * extra
            if not chosen or n == 1:
                continue
            flat = torch._utils._flatten_dense_tensors(chosen)
            comm.all_reduce(flat, mesh.group(axes))
            flat /= n
            for g, v in zip(chosen, torch._utils._unflatten_dense_tensors(
                    flat, chosen)):
                g.copy_(v)

    def _global_norm(self, grads):
        """The norm of the whole gradient, the same on every rank: sums of
        squares of the tensor- and expert-split parameters summed over
        their groups, and everything summed over fsdp."""
        mesh = self.mesh
        specs = getattr(self.app.module, "parallel_specs", {})
        parts = {"tensor": [], "expert": [], "": []}
        for name, p, g in zip(self.param_names, self.module_params, grads):
            key = ("tensor" if name in specs else "expert"
                   if getattr(p, "expert_parallel", False) else "")
            parts[key].append(g)
        total = None
        for axes, gs in parts.items():
            if not gs:
                continue
            sq = norms(gs).square().sum()
            if axes:
                comm.all_reduce(sq, mesh.group(axes))
            total = sq if total is None else total + sq
        return comm.all_reduce(total, mesh.group("fsdp")).sqrt().float()

    # ------------------------------------------------------------------ step
    def _train_step(self, inputs):
        """One optimizer step on a batch of device tensors. Returns (metric
        names, a 1-D f32 device tensor of their values): loss, grad_norm,
        nonfinite_skip and the loss function's other scalars."""
        micro = self.micro
        sums = {}
        for j in range(self.accum):
            mb = {k: v[j * micro:(j + 1) * micro] for k, v in inputs.items()}
            if self.custom_loss is not None:
                loss_dict = self.custom_loss(mb, self.generator)
            else:
                loss_dict = self.app.loss_fn(self.app.forward(mb), mb)
            loss_dict["loss"].float().backward()
            for k, v in loss_dict.items():
                if v.dim() == 0:
                    v = v.detach().float()
                    sums[k] = v if k not in sums else sums[k] + v
        grads = [sharding.local(p.grad) if p.grad is not None
                 else torch.zeros_like(q)
                 for p, q in zip(self.module_params, self.params)]
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
            sums = {k: v / self.accum for k, v in sums.items()}
        if self.mesh is None:
            gnorm = global_norm(grads)
        else:
            self._reduce_gradients(grads)
            gnorm = self._global_norm(grads)
            names = sorted(sums)
            means = torch.stack([sums[k] for k in names])
            comm.all_reduce(means, self.mesh.group(BATCH_AXES))
            sums = dict(zip(names, means / self.dp))
        finite = torch.isfinite(sums["loss"]) & torch.isfinite(gnorm)
        if self.max_grad_norm > 0:
            torch._foreach_mul_(grads, self.max_grad_norm / torch.clamp(
                gnorm, min=self.max_grad_norm))
        self.optimizer.step(grads, apply=finite)
        for p in self.module_params:
            p.grad = None
        if self.ema_state is not None:  # skipped steps too, as in JAX
            ema_update(self.ema_state, self.params, decay=self.ema_decay)
        extra = [k for k in sums if k != "loss"]
        values = torch.stack([sums["loss"], gnorm, (~finite).float()]
                             + [sums[k] for k in extra])
        return ["loss", "grad_norm", "nonfinite_skip"] + extra, values

    def _read_back(self):
        """Every pending step's metrics to the host in one copy: their
        step_records, the skip count, and the last step's metrics (with
        its lr), or None when nothing is pending."""
        if not self._pending:
            return None
        rows = torch.stack([p["values"] for p in self._pending]).cpu()
        metrics = None
        for pending, row in zip(self._pending, rows.tolist()):
            metrics = dict(zip(pending["names"], row), lr=pending["lr"])
            self.nonfinite_skips += int(metrics["nonfinite_skip"])
            self.step_records.append(dict(
                metrics, step=pending["step"],
                seconds=self.clock.seconds(pending["start"],
                                           pending["end"])))
        self._pending = []
        return metrics

    # ----------------------------------------------------------------- train
    def train(self):
        args = self.args
        total_epochs = int(math.ceil(args.epoch_num))
        last_log, last_log_step = time.time(), self.global_step
        self.app.module.train()

        def strip_valid(batch):
            batch.pop("_valid", None)
            return batch

        for epoch in range(self.start_epoch, total_epochs):
            self.train_loader.set_epoch(epoch)
            batches = iter(self.train_loader)
            if epoch == self.start_epoch and self._resume_skip_batches:
                # shuffling is a function of (seed, epoch): skipping by index
                # replays the exact data order without featurising the head
                logger.info("resume: skipping %d already-trained batches of "
                            "epoch %d", self._resume_skip_batches, epoch)
                batches = self.train_loader.iter_from(
                    self._resume_skip_batches)
            with contextlib.closing(device_prefetch(
                    batches, self.app.device, depth=self.prefetch_depth,
                    transform=strip_valid)) as device_batches:
                start = self.clock.mark()
                for batch in device_batches:
                    if self.global_step >= self.t_total:
                        break
                    self._profile_window()
                    names, values = self._train_step(batch)
                    end = self.clock.mark()
                    self._pending.append(dict(
                        step=self.global_step + 1, names=names,
                        values=values, start=start, end=end,
                        lr=self.schedule_fn(self.global_step)))
                    start = end
                    self.global_step += 1
                    if self.global_step % args.logging_steps == 0 \
                            or self.global_step == self.t_total:
                        metrics = self._read_back()
                        now = time.time()
                        sps = ((self.global_step - last_log_step)
                               * args.micro_batch_size * self.accum
                               / max(now - last_log, 1e-6))
                        last_log, last_log_step = now, self.global_step
                        self.stats.log_train(epoch, self.global_step,
                                             self.t_total, metrics,
                                             samples_per_sec=sps)
                    if args.save_checkpoint_steps and self.global_step \
                            % args.save_checkpoint_steps == 0:
                        self._eval_and_save()
                        start = self.clock.mark()
        self._read_back()
        self._stop_profiler()
        self.after_train()

    def _profile_window(self):
        """--profile_dir: a torch.profiler trace of steps 3..2+profile_steps
        written as a Chrome trace (the JAX Trainer's jax.profiler window)."""
        args = self.args
        if not args.profile_dir:
            return
        if self.global_step == 2 and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.app.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        elif self.global_step == 2 + args.profile_steps:
            self._stop_profiler()

    def _stop_profiler(self):
        if self._profiler is None:
            return
        if self.app.device.type == "cuda":
            torch.cuda.synchronize(self.app.device)
        self._profiler.stop()
        io.makedirs(self.args.profile_dir)
        path = os.path.join(self.args.profile_dir, "trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        logger.info("profiler trace written to %s", path)

    def after_train(self):
        self._eval_and_save(final=True)
        # the last write is on disk before train() returns
        self._join_pending_save()
        self.stats.close()

    def _eval_and_save(self, final=False):
        args = self.args
        score = None
        if self.evaluator is not None:
            results = self.evaluator.evaluate(
                getattr(self.app, "eval_target", self.app))
            self.stats.log_eval(self.global_step, results)
            score = results[0][1]
        if not args.checkpoint_dir:
            return
        if self.mesh is not None and score is not None:
            # every rank takes rank 0's decision: the saves gather
            score = torch.tensor([score], dtype=torch.float64,
                                 device=self.app.device)
            torch.distributed.broadcast(score, 0)
            score = float(score)
        if score is None or score >= self.best_score:
            if score is not None:
                self.best_score = score
            self.save_checkpoint()
        if args.save_all_checkpoints and not final:
            self.save_checkpoint(subdir="step_%d" % self.global_step)

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, subdir=None):
        """The JAX package's artifact set, with the weights as
        `pytorch_model.bin`: config.json, vocab.txt, label_mapping.json,
        train_config.json, meta.json, the optimizer state (optimizer.pt),
        the app's extra artifacts and, with --ema_decay,
        `pytorch_model_ema.bin`. With subdir the set goes into
        checkpoint_dir/subdir. Everything written is first copied to host
        memory here, on the training thread; with --async_save a
        background thread writes it."""
        args = self.args
        t0 = time.perf_counter()
        out = args.checkpoint_dir
        if subdir:
            out = os.path.join(out, subdir)
        ema = None
        if self.ema_state is not None:
            ema = dict(zip(self.param_names, self.ema_state["shadow"]))
        opt_state = self.optimizer.state_dict()
        if self.mesh is not None:
            # collective: every rank gathers, the master alone writes
            module = self.app.module
            if ema is not None:
                ema = sharding.full_state(module, self.mesh, ema)
            for key in self.optimizer.state_keys:
                if key not in self.optimizer.replicated_keys:
                    opt_state[key] = sharding.full_state(module, self.mesh,
                                                         opt_state[key])
            exportable = sharding.full_parameters(module, self.mesh)
        else:
            exportable = contextlib.nullcontext()
        with exportable:
            files = {PYTORCH_WEIGHTS_NAME: self.app.export_state_dict()}
            extra = getattr(self.app, "extra_save_artifacts", None)
            if extra is not None:
                files.update(extra())
            if ema is not None:
                with substituted(self.app.module, ema):
                    files[EMA_WEIGHTS_NAME] = self.app.export_state_dict()
        meta = {"global_step": self.global_step,
                "epoch": self.global_step // self.steps_per_epoch,
                "best_score": self.best_score}
        if ema is not None:
            meta["ema_num_updates"] = int(self.ema_state["num_updates"])
        files[OPT_STATE_NAME] = opt_state
        if self.mesh is not None and not args.is_master_node:
            return
        files = host_copy(files)
        cfg = {k: v for k, v in vars(args).items()
               if isinstance(v, (str, int, float, bool, type(None)))}
        self._join_pending_save()  # at most one write in flight
        if self.async_save:
            self._save_thread = threading.Thread(
                target=self._write_guarded, args=(out, files, meta, cfg),
                name="checkpoint-writer", daemon=True)
            self._save_thread.start()
        else:
            self._write_checkpoint(out, files, meta, cfg)
        self.save_seconds.append(time.perf_counter() - t0)

    def _write_guarded(self, *write_args):
        try:
            self._write_checkpoint(*write_args)
        except Exception as exc:  # raised by _join_pending_save
            self._save_error = exc
            logger.error("async checkpoint write failed: %s", exc)

    def _join_pending_save(self):
        """Wait for the write in flight; raise if a write failed."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            exc, self._save_error = self._save_error, None
            raise RuntimeError("async checkpoint write failed") from exc

    def _write_checkpoint(self, out, files, meta, cfg):
        """Host data in, files out: safe on a background thread (the config,
        tokenizer and label mapping do not change while training)."""
        io.makedirs(out)
        for name, obj in files.items():
            with io.open(os.path.join(out, name), "wb") as f:
                torch.save(obj, f)
        self.app.config.save_pretrained(out)
        if self.tokenizer is not None:
            self.tokenizer.save_pretrained(out)
        if self.app.label_mapping:
            with io.open(os.path.join(out, "label_mapping.json"), "w") as f:
                json.dump(self.app.label_mapping, f, ensure_ascii=False,
                          indent=2)
        with io.open(os.path.join(out, "train_config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        with io.open(os.path.join(out, META_NAME), "w") as f:
            json.dump(meta, f)
        logger.info("checkpoint saved to %s", out)

    @torch.no_grad()
    def _copy_params_to_shadow(self):
        torch._foreach_copy_(self.ema_state["shadow"], self.params)

    def resume_from_ckpt(self, ckpt_dir):
        """Restore weights, optimizer state, step counter and the EMA
        shadow and count; the loader fast-forwards because shuffling is a
        function of (seed, epoch)."""
        meta_path = os.path.join(ckpt_dir, META_NAME)
        if not io.exists(meta_path):
            logger.warning("no %s in %s; fresh start", META_NAME, ckpt_dir)
            return
        with io.open(meta_path) as f:
            meta = json.load(f)
        self.global_step = int(meta["global_step"])
        self.start_epoch = int(meta.get("epoch", 0))
        self._resume_skip_batches = self.global_step % self.steps_per_epoch
        self.best_score = float(meta.get("best_score", -float("inf")))
        restore = getattr(self.app, "restore_params", None)
        ema_path = os.path.join(ckpt_dir, EMA_WEIGHTS_NAME)
        ema_restored = False
        if self.mesh is not None:
            # the weights and the EMA weights went in before the split
            # (_place_state); the shadow takes this rank's part of these
            restore = lambda _: None  # noqa: E731
            ema_path = None
            if self.ema_state is not None and self._ema_resume is not None:
                specs = getattr(self.app.module, "parallel_specs", {})
                for name, p, shadow in zip(self.param_names,
                                           self.module_params,
                                           self.ema_state["shadow"]):
                    shadow.copy_(sharding.shard_like(
                        p, self._ema_resume[name], specs.get(name),
                        self.mesh))
                ema_restored = True
            self._ema_resume = None
        if self.ema_state is not None and restore is None \
                and io.exists(ema_path):
            # the EMA weights go in through the module (the file has the
            # export's names), into the shadow, then the trained ones
            self.app.load_state_dict(self.app.module,
                                     load_pytorch_state_dict(ema_path))
            self._copy_params_to_shadow()
            ema_restored = True
        if restore is not None:
            restore(ckpt_dir)
        else:
            self.app.load_state_dict(self.app.module,
                                     load_pytorch_state_dict(ckpt_dir))
        if self.ema_state is not None:
            if not ema_restored:
                logger.warning("no restorable %s in %s: the EMA restarts "
                               "from the resumed weights", EMA_WEIGHTS_NAME,
                               ckpt_dir)
                self._copy_params_to_shadow()
            self.ema_state["num_updates"].fill_(
                int(meta.get("ema_num_updates", self.global_step)))
        opt_path = os.path.join(ckpt_dir, OPT_STATE_NAME)
        if io.exists(opt_path):
            with io.open(opt_path, "rb") as f:
                state = torch.load(f, map_location=self.app.device,
                                   weights_only=True)
            if self.mesh is not None:
                specs = getattr(self.app.module, "parallel_specs", {})
                params = dict(zip(self.param_names, self.module_params))
                for key in self.optimizer.state_keys:
                    if key in self.optimizer.replicated_keys:
                        continue  # whole on every rank
                    state[key] = {
                        name: sharding.shard_like(params[name], full,
                                                  specs.get(name), self.mesh)
                        for name, full in state[key].items()}
            self.optimizer.load_state_dict(state)
        logger.info("resumed from %s at step %d", ckpt_dir, self.global_step)
