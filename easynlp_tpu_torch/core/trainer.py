"""Training loop for the PyTorch port.

Counterpart of easynlp_tpu/core/trainer.py on one device:

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
  plus the JAX package's other artifacts, and resume with the mid-epoch skip.

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
import time

import torch

from easynlp_tpu_torch.core.optimizers import get_optimizer, global_norm
from easynlp_tpu_torch.data.dataset import DataLoader
from easynlp_tpu_torch.data.prefetch import device_prefetch
from easynlp_tpu_torch.modelzoo.modeling_utils import (
    load_pytorch_state_dict,
    save_pytorch_state_dict,
)
from easynlp_tpu_torch.utils.global_vars import get_args
from easynlp_tpu_torch.utils.io_utils import io
from easynlp_tpu_torch.utils.logger import logger
from easynlp_tpu_torch.utils.statistics import Statistics

META_NAME = "meta.json"
OPT_STATE_NAME = "optimizer.pt"


def refuse_unported_options(args):
    """Raise on the JAX Trainer's options that the port does not have yet,
    rather than ignore them."""
    if (getattr(args, "remat", "none") or "none") != "none":
        raise NotImplementedError("--remat=%s (activation checkpointing) is "
                                  "not ported yet (ROADMAP A6b)" % args.remat)
    if float(getattr(args, "ema_decay", 0.0) or 0.0) > 0.0:
        raise NotImplementedError("--ema_decay is not ported yet "
                                  "(ROADMAP A6b)")
    if getattr(args, "async_save", False):
        raise NotImplementedError("--async_save is not ported yet "
                                  "(ROADMAP A6b)")
    if (getattr(args, "num_processes", 1) or 1) > 1 or getattr(args, "mesh",
                                                               None):
        raise NotImplementedError("multi-process and multi-device training "
                                  "(--num_processes, --mesh) is not ported "
                                  "yet (ROADMAP A23)")


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
        refuse_unported_options(args)
        self.app = model
        self.evaluator = evaluator
        self.tokenizer = tokenizer
        self.accum = max(1, args.gradient_accumulation_steps)
        global_batch = args.micro_batch_size * self.accum
        self.train_loader = DataLoader(
            train_dataset, batch_size=global_batch, shuffle=True,
            seed=args.random_seed,
            num_workers=getattr(args, "data_workers", 0))
        self.steps_per_epoch = max(1, len(self.train_loader))
        self.optimizer, self.schedule_fn, self.t_total = get_optimizer(
            self.app.module.named_parameters(),
            optimizer_type=args.optimizer_type,
            learning_rate=args.learning_rate,
            warmup_proportion=args.warmup_proportion,
            lr_scheduler=args.lr_scheduler,
            epoch_num=args.epoch_num,
            steps_per_epoch=self.steps_per_epoch,
            gradient_accumulation_steps=1,  # accumulation is inside the step
            weight_decay=args.weight_decay,
            max_grad_norm=0.0,  # the step clips, sharing the guard's norm
            b1=args.adam_beta1, b2=args.adam_beta2, eps=args.adam_epsilon)
        self.max_grad_norm = float(args.max_grad_norm or 0.0)
        self.params = self.optimizer.params
        self.prefetch_depth = int(getattr(args, "num_host_prefetch", 2))
        self.clock = StepClock(self.app.device)
        self._pending = []  # steps not yet read back

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
            "global batch %d (micro %d x accum %d) | device %s",
            sum(p.numel() for p in self.params), self.steps_per_epoch,
            args.epoch_num, self.t_total, global_batch,
            args.micro_batch_size, self.accum, self.app.device)

    # ------------------------------------------------------------------ step
    def _train_step(self, inputs):
        """One optimizer step on a batch of device tensors. Returns (metric
        names, a 1-D f32 device tensor of their values): loss, grad_norm,
        nonfinite_skip and the loss function's other scalars."""
        micro = self.args.micro_batch_size
        sums = {}
        for j in range(self.accum):
            mb = {k: v[j * micro:(j + 1) * micro] for k, v in inputs.items()}
            loss_dict = self.app.loss_fn(self.app.forward(mb), mb)
            loss_dict["loss"].float().backward()
            for k, v in loss_dict.items():
                if v.dim() == 0:
                    v = v.detach().float()
                    sums[k] = v if k not in sums else sums[k] + v
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.accum > 1:
            torch._foreach_div_(grads, float(self.accum))
            sums = {k: v / self.accum for k, v in sums.items()}
        gnorm = global_norm(grads)
        finite = torch.isfinite(sums["loss"]) & torch.isfinite(gnorm)
        if self.max_grad_norm > 0:
            torch._foreach_mul_(grads, self.max_grad_norm / torch.clamp(
                gnorm, min=self.max_grad_norm))
        self.optimizer.step(grads, apply=finite)
        for p in self.params:
            p.grad = None
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
        self.stats.close()

    def _eval_and_save(self, final=False):
        args = self.args
        score = None
        if self.evaluator is not None:
            results = self.evaluator.evaluate(self.app)
            self.stats.log_eval(self.global_step, results)
            score = results[0][1]
        if not args.checkpoint_dir:
            return
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
        train_config.json, meta.json and the optimizer state (optimizer.pt).
        With subdir the set goes into checkpoint_dir/subdir."""
        args = self.args
        t0 = time.perf_counter()
        out = args.checkpoint_dir
        if subdir:
            out = os.path.join(out, subdir)
        io.makedirs(out)
        save_pytorch_state_dict(self.app.export_state_dict(), out)
        self.app.config.save_pretrained(out)
        if self.tokenizer is not None:
            self.tokenizer.save_pretrained(out)
        if self.app.label_mapping:
            with io.open(os.path.join(out, "label_mapping.json"), "w") as f:
                json.dump(self.app.label_mapping, f, ensure_ascii=False,
                          indent=2)
        cfg = {k: v for k, v in vars(args).items()
               if isinstance(v, (str, int, float, bool, type(None)))}
        with io.open(os.path.join(out, "train_config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        meta = {"global_step": self.global_step,
                "epoch": self.global_step // self.steps_per_epoch,
                "best_score": self.best_score}
        with io.open(os.path.join(out, META_NAME), "w") as f:
            json.dump(meta, f)
        with io.open(os.path.join(out, OPT_STATE_NAME), "wb") as f:
            torch.save(self.optimizer.state_dict(), f)
        self.save_seconds.append(time.perf_counter() - t0)
        logger.info("checkpoint saved to %s", out)

    def resume_from_ckpt(self, ckpt_dir):
        """Restore weights, optimizer state and step counter; the loader
        fast-forwards because shuffling is a function of (seed, epoch)."""
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
        self.app.load_state_dict(self.app.module,
                                 load_pytorch_state_dict(ckpt_dir))
        opt_path = os.path.join(ckpt_dir, OPT_STATE_NAME)
        if io.exists(opt_path):
            with io.open(opt_path, "rb") as f:
                self.optimizer.load_state_dict(torch.load(
                    f, map_location=self.app.device, weights_only=True))
        logger.info("resumed from %s at step %d", ckpt_dir, self.global_step)
