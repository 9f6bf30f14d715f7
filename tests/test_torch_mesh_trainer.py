"""The Trainer on a mesh for what it refused there before: --remat,
Adafactor, LoRA (its restore_params resume) and a loss that draws its own
randomness (latent diffusion's make_train_loss).

Two gloo ranks on the CPU run every job in one start
(tests/torch_mesh_tasks.py::trainer_jobs, each job laying its own mesh
over them). Each job is held, in f32, against the same job in one
process and against `jax_reference`: JAX's Trainer step (value_and_grad,
optax.global_norm, the clip to max_grad_norm, the JAX package's
get_optimizer with the port's flags) on the JAX module applied on one
device to the same numpy weights and batches, over the port's parameter
names (parameters whose gradient is rounding alone, ROUNDING_RTOL, left
out):

- --remat=full|selective|names: BART seq2seq at tensor=2 with dropout on
  gives the losses, gradient norms and parameters of --remat=none on the
  same mesh bit for bit (the recompute replays the RNG and the layers'
  all-reduces); with dropout off tensor=2 at each policy (and none) gives
  one process's losses and gradient norms within STEP_RTOL, and JAX's
  module at the same policy's within JAX_STEP_RTOL, its parameters after
  two AdamW steps within JAX_UPDATE_ATOL + JAX_UPDATE_RTOL;
- Adafactor on a BERT wide enough to factor (its 131 x 128 table and its
  128 x 256 layers), at tensor=2 (the padded vocabulary too), fsdp=2 and
  data=2: the losses and gradient norms within STEP_RTOL and the
  parameters after two steps within UPDATE_ATOL + UPDATE_RTOL of one
  process's (the key biases left out: the softmax ignores them, so their
  gradient is rounding alone, which Adafactor's normalised step scales to
  a full step of either sign), and within the JAX bounds of optax's
  adafactor;
- LoRA on query, value and both output denses (column- and row-split
  weights) at tensor=2: two steps, a collective save, a resume on the
  mesh and two more give one process's four losses and gradient norms
  within STEP_RTOL and its adapters within UPDATE_ATOL, and JAX's (the
  merged W + s (A B)^T through the JAX module, AdamW on the adapters)
  within JAX_STEP_RTOL and JAX_LORA_ATOL;
- latent diffusion at data=2 (built with JAX's numerics): two
  make_train_loss steps (the global batch's timesteps and noise, each
  rank its rows) give one process's losses and gradient norms within
  STEP_RTOL, and JAX's loss at the port's draws within JAX_STEP_RTOL, its
  parameters within the JAX bounds.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_mesh_tasks as T
from torch_parallel_workers import run_ranks

STEP_RTOL = 1e-5
UPDATE_ATOL, UPDATE_RTOL = 2e-6, 1e-5
JAX_STEP_RTOL = 1e-5
JAX_UPDATE_ATOL, JAX_UPDATE_RTOL = 2e-6, 1e-5
# LoRA's adapters under AdamW at lr 1e-2: A's gradient is zero at the
# first step (B starts at zero) and then small, and AdamW divides each
# element by its own rms, which carries the two frameworks' f32 rounding
# of a small gradient into the step: 1e-4 is 1% of one step
JAX_LORA_ATOL = 1e-4
KEY_BIAS = ("attention.self.key.bias",)
# a parameter whose gradient stays under this share of the largest entry
# has none but f32 rounding (the key biases before a softmax; at the
# LDM's 8 channels, every per-channel constant before a GroupNorm of one
# channel a group), which AdamW's and Adafactor's normalised steps turn
# into steps of either sign: the JAX reference leaves them out (their
# gradients read 1e-13 to 3e-9 of the largest, the others 1e-5 and up)
ROUNDING_RTOL = 1e-7
POLICIES = ("full", "selective", "names")
CONSTANT_LR = "--lr_scheduler=constant"

BERT = dict(vocab_size=131, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=32, type_vocab_size=2,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
LDM_SETUP = [("easynlp_tpu_torch.modelzoo.models.latent_diffusion.unet:"
              "TRANSFORMER_GN_EPS", 1e-5),
             ("easynlp_tpu_torch.modelzoo.models.latent_diffusion.unet:"
              "TRANSFORMER_LN_EPS", 1e-6),
             ("easynlp_tpu_torch.modelzoo.models.latent_diffusion.unet:"
              "GEGLU_APPROXIMATE", "tanh"),
             ("easynlp_tpu_torch.modelzoo.models.latent_diffusion."
              "autoencoder:VAE_DOWN_PAD", (1, 1, 1, 1))]


def _state(module):
    return {k: v.detach().numpy().copy()
            for k, v in module.state_dict().items()}


def _bert_job(mesh, argv, steps=2, **extra):
    """BERT text classification from the port's seeded init; `jax` holds
    what the JAX reference needs (the JAX app's tree, which
    _port_to_jax fills with these weights)."""
    from easynlp_tpu.appzoo.sequence_classification.model import (
        SequenceClassification as JaxApp)
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification, SequenceClassificationModule)
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    from test_torch_text_match import jax_params
    config = dict(BERT, model_type="bert", layer_norm_eps=1e-12,
                  initializer_range=0.02, hidden_act="gelu")
    module = SequenceClassificationModule(BertConfig(**config), num_labels=2)
    module.init_weights(torch.Generator().manual_seed(0))
    state = _state(module)
    _, module, params = jax_params(JaxApp, config, seed=0, num_labels=2)
    rng = np.random.RandomState(1)
    batches = []
    for _ in range(steps):
        ids = rng.randint(1, BERT["vocab_size"], (4, 8)).astype(np.int64)
        mask = (np.arange(8)[None] < np.array([8, 5, 8, 3])[:, None]) \
            .astype(np.int64)
        batches.append({"input_ids": ids * mask, "attention_mask": mask,
                        "token_type_ids": np.zeros_like(ids),
                        "label_ids": rng.randint(0, 2, 4).astype(np.int64)})
    jax_side = dict(app=JaxApp, module=module, params=params,
                    to_port=lambda g: SequenceClassification
                    .state_dict_from_jax(g, BertConfig(**config)))
    return dict(app="bert_cls", config=config, state=state, mesh=mesh,
                argv=argv, micro=4, rows=8, batches=batches,
                jax=jax_side, **extra)


def _bart_job(mesh, policy, dropout):
    from easynlp_tpu.appzoo.sequence_generation.model import (
        SequenceGeneration as JaxApp)
    from easynlp_tpu.modelzoo.models.bart import BartConfig as JaxBartConfig
    from easynlp_tpu.modelzoo.models.bart.conversion import (
        convert_bart_state_dict)
    from test_torch_bart import TINY, hf_state_dict
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    from easynlp_tpu_torch.modelzoo.models.bart import BartConfig
    from easynlp_tpu_torch.modelzoo.models.bart.conversion import (
        normalize_keys)
    config = dict(TINY, dropout=dropout, activation_dropout=dropout,
                  model_type="bart")
    hf = hf_state_dict(BartConfig(**config), 3)
    state = {k: v.numpy() for k, v in normalize_keys(
        {k: torch.from_numpy(v) for k, v in hf.items()},
        BartConfig(**config)).items()}
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(2):
        src = rng.randint(3, 120, (4, 10)).astype(np.int64)
        src_mask = (np.arange(10)[None]
                    < np.array([10, 6, 8, 9])[:, None]).astype(np.int64)
        dec = rng.randint(3, 120, (4, 6)).astype(np.int64)
        dec_mask = (np.arange(6)[None]
                    < np.array([6, 4, 2, 5])[:, None]).astype(np.int64)
        batches.append({
            "input_ids": src, "attention_mask": src_mask,
            "decoder_input_ids": dec, "decoder_attention_mask": dec_mask,
            "labels": np.where(dec_mask == 1, rng.randint(3, 120, (4, 6)),
                               -100).astype(np.int64)})
    jcfg = JaxBartConfig(**TINY)
    jax_side = dict(app=JaxApp, module=JaxApp.build_module(
        jcfg, args=SimpleNamespace(remat=policy), dtype=jnp.float32),
        params=convert_bart_state_dict(hf, jcfg),
        to_port=lambda g: SequenceGeneration.state_dict_from_jax(
            g, BartConfig(**config)))
    return dict(app="bart_gen", config=config, state=state, mesh=mesh,
                argv=["--remat=" + policy, "--learning_rate=1e-3",
                      CONSTANT_LR],
                micro=4, rows=8, batches=batches, jax=jax_side)


def _ldm_job(mesh):
    """The LDM of test_torch_diffusion_apps.small, built with JAX's
    numerics (LDM_SETUP, test_torch_diffusion.JAX_NUMERICS)."""
    from easynlp_tpu.appzoo.latent_diffusion import model as JM
    from easynlp_tpu.modelzoo.models.latent_diffusion.conversion import (
        convert_stable_diffusion)
    from test_torch_diffusion_apps import small
    from easynlp_tpu_torch.appzoo.latent_diffusion import model as PM
    kw = small(40)
    with T.setup(LDM_SETUP):
        module = PM.LDMModule(PM.LDMConfig(**kw))
    module.init_weights(torch.Generator().manual_seed(0))
    state = _state(module)
    rng = np.random.RandomState(5)
    batches = [{"input_ids": rng.randint(1, 40, (4, 6)).astype(np.int64),
                "attention_mask": np.ones((4, 6), np.int64),
                "pixel_values": (rng.rand(4, 8, 8, 3) * 2 - 1).astype(
                    np.float32)} for _ in range(2)]
    jcfg = JM.LDMConfig(**kw)
    jax_side = dict(app=JM.LatentDiffusion, config=jcfg,
                    module=JM.LDMModule(config=jcfg),
                    params=convert_stable_diffusion(state, jcfg),
                    to_port=lambda g: PM.LatentDiffusion.state_dict_from_jax(
                        g, PM.LDMConfig(**kw)))
    return dict(app="ldm", config=kw, state=state, mesh=mesh,
                argv=["--learning_rate=1e-3", CONSTANT_LR],
                micro=4, rows=8, batches=batches, setup=LDM_SETUP,
                jax=jax_side)


# --------------------------------------------------------------------------
# the JAX reference: JAX's Trainer step (easynlp_tpu core/trainer.py:216-266,
# value_and_grad, optax.global_norm, the clip to max_grad_norm, the JAX
# package's optimizer) on the JAX module, over the port's parameter names
# --------------------------------------------------------------------------

def _port_to_jax(template, to_port, names):
    """A function carrying a {port name: array} state into the JAX tree of
    `template`: to_port moves elements (transposes, splits, stacks), so it
    is read off once on a tree of each element's index; the port's
    parameters `names` must cover every element of the tree."""
    leaves, treedef = jax.tree.flatten(template)
    offsets = np.cumsum([0] + [np.size(x) for x in leaves])
    index = to_port(treedef.unflatten(
        [np.arange(o, o + np.size(x), dtype=np.float64).reshape(np.shape(x))
         for o, x in zip(offsets, leaves)]))
    where = {n: np.asarray(index[n]).astype(np.int64) for n in names}
    covered = np.zeros(offsets[-1], bool)
    for i in where.values():
        covered[i.ravel()] = True
    assert covered.all() and offsets[-1] < 2 ** 24
    base = np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in leaves])

    def to_jax(state):
        flat = base.copy()
        for n, i in where.items():
            flat[i.ravel()] = np.asarray(state[n]).ravel()
        return treedef.unflatten([
            jnp.asarray(flat[o:o + np.size(x)].reshape(np.shape(x)))
            for o, x in zip(offsets, leaves)])
    return to_jax


def _jax_loss(job):
    """loss(params, batch, draws) of the job's JAX app on one device,
    dropout off; latent diffusion reads the port's draws of the step."""
    side = job["jax"]
    module, app = side["module"], side["app"]
    if job["app"] != "ldm":
        labels = ("label_ids", "labels")

        def loss(params, batch, draws):
            out = module.apply({"params": params}, deterministic=True, **{
                k: v for k, v in batch.items() if k not in labels})
            return app.loss_fn(out, batch)["loss"]
        return loss
    config = side["config"]
    schedule = app(module, side["params"], config).schedule

    def loss(params, batch, draws):
        v = {"params": params}
        context = module.apply(v, batch["input_ids"], batch["attention_mask"],
                               deterministic=True, method=module.encode_text)
        mean, logvar = module.apply(v, batch["pixel_values"],
                                    method=lambda m, x: m.vae_encoder(x))
        latents = (mean + jnp.exp(0.5 * logvar) * draws["posterior"]) \
            * config.scale_factor
        noisy = schedule.q_sample(latents, draws["t"], draws["noise"])
        pred = module.apply(v, noisy, draws["t"], context, deterministic=True,
                            method=module.predict_noise)
        return jnp.mean((pred - draws["noise"]) ** 2)
    return loss


def _draws(job, steps):
    """The port Trainer's draws for each step (its generator from the
    random seed, the global batch's rows), NHWC for JAX."""
    app = T.trainer_app(job)
    gen = torch.Generator().manual_seed(job.get("seed", 1))
    out = []
    for batch in job["batches"][:steps]:
        d = app.draw_training_noise(len(batch["input_ids"]), gen,
                                    batch["pixel_values"].shape[1])
        out.append({"t": jnp.asarray(d["t"].numpy()),
                    "noise": jnp.asarray(d["noise"].numpy()
                                         .transpose(0, 2, 3, 1)),
                    "posterior": jnp.asarray(d["posterior"].numpy()
                                             .transpose(0, 2, 3, 1))})
    return out


def jax_reference(job, lora=None):
    """The job's steps on the JAX module: {'metrics': [{'loss',
    'grad_norm'}], 'params': the trained parameters (the adapters, named
    lora_a.i / lora_b.i as the port's LoRAModule names them, for a LoRA
    job) whose gradient is more than rounding (ROUNDING_RTOL)}. The optimizer is the JAX package's get_optimizer with the
    port's parsed flags (a constant lr); LoRA merges W + s (A B)^T in the
    port's layout and carries the merged weights' gradient to A and B."""
    from easynlp_tpu.core.optimizers import get_optimizer
    from easynlp_tpu_torch.utils.arguments import parse_args
    args = parse_args(args_list=list(job["argv"]))
    assert args.lr_scheduler == "constant"
    tx, _, _ = get_optimizer(
        optimizer_type=args.optimizer_type, learning_rate=args.learning_rate,
        lr_scheduler="constant", weight_decay=args.weight_decay,
        max_grad_norm=0.0, b1=args.adam_beta1, b2=args.adam_beta2,
        eps=args.adam_epsilon)
    side = job["jax"]
    app = T.trainer_app(dict(job, lora=None))
    names = [n for n, _ in app.module.named_parameters()]
    to_jax = _port_to_jax(side["params"], side["to_port"], names)
    state = {n: np.asarray(job["state"][n], np.float32) for n in names}
    grad_fn = jax.jit(jax.value_and_grad(_jax_loss(job)))
    draws = _draws(job, len(job["batches"])) if job["app"] == "ldm" \
        else [None] * len(job["batches"])
    if lora:
        from easynlp_tpu_torch.modelzoo.lora import lora_init
        init = lora_init(app.module, rank=lora["rank"],
                         targets=lora["targets"], seed=0)
        targets = list(init)
        trained = {}
        for i, n in enumerate(targets):
            trained["lora_a.%d" % i] = jnp.asarray(init[n]["a"].detach().numpy())
            trained["lora_b.%d" % i] = jnp.asarray(init[n]["b"].detach().numpy())
        scale = 1.0  # alpha defaults to the rank
    else:
        trained = {n: jnp.asarray(state[n]) for n in names}
    opt_state = tx.init(trained)
    metrics, largest = [], {}
    for batch, d in zip(job["batches"], draws):
        full = dict(state)
        if lora:
            for i, n in enumerate(targets):
                a, b = (np.asarray(trained["lora_%s.%d" % (x, i)])
                        for x in "ab")
                full[n] = state[n] + scale * (a @ b).T
        jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64
                                 else v) for k, v in batch.items()}
        if job["app"] == "ldm":
            jbatch["pixel_values"] = jnp.asarray(batch["pixel_values"])
        loss, g = grad_fn(to_jax(full), jbatch, d)
        g = {n: np.asarray(v) for n, v in side["to_port"](
            jax.tree.map(np.asarray, g)).items() if n in names}
        if lora:
            grads = {}
            for i, n in enumerate(targets):
                a, b = (np.asarray(trained["lora_%s.%d" % (x, i)])
                        for x in "ab")
                grads["lora_a.%d" % i] = scale * g[n].T @ b.T
                grads["lora_b.%d" % i] = scale * a.T @ g[n].T
        else:
            grads = g
        for k, v in grads.items():
            largest[k] = max(largest.get(k, 0.0), float(np.abs(v).max()))
        grads = {k: jnp.asarray(v) for k, v in grads.items()}
        gnorm = optax.global_norm(grads)
        clip = args.max_grad_norm / jnp.maximum(gnorm, args.max_grad_norm)
        grads = jax.tree.map(lambda x: x * clip, grads)
        updates, opt_state = tx.update(grads, opt_state, trained)
        trained = optax.apply_updates(trained, updates)
        if not lora:
            state = {n: np.asarray(v) for n, v in trained.items()}
        metrics.append({"loss": float(loss), "grad_norm": float(gnorm)})
    top = max(largest.values())
    real = [k for k, v in largest.items() if v > ROUNDING_RTOL * top]
    assert len(real) > len(largest) // 2
    return {"metrics": metrics,
            "params": {k: np.asarray(trained[k]) for k in real}}


LORA = {"rank": 4, "targets": ("query", "value", "output.dense")}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """({name: the two ranks' results}, {name: one process's result},
    {name: the JAX reference's}, the LoRA checkpoint) from one start of
    two ranks."""
    work = str(tmp_path_factory.mktemp("mesh_trainer"))
    ckpt = os.path.join(work, "lora_ckpt")
    ada = ["--optimizer_type=Adafactor", "--learning_rate=1e-2",
           CONSTANT_LR]
    lora_argv = ["--learning_rate=1e-2", CONSTANT_LR]
    todo = {"remat-none": _bart_job({"tensor": 2}, "none", 0.1)}
    for policy in POLICIES:
        todo["remat-" + policy] = _bart_job({"tensor": 2}, policy, 0.1)
    todo["bart-tp2"] = _bart_job({"tensor": 2}, "none", 0.0)
    for policy in POLICIES:
        todo["bart-tp2-" + policy] = _bart_job({"tensor": 2}, policy, 0.0)
    for axis in ("tensor", "fsdp", "data"):
        todo["adafactor-" + axis] = _bert_job({axis: 2}, ada)
    lora = _bert_job({"tensor": 2}, lora_argv, steps=4, lora=LORA)
    todo["lora-save"] = dict(lora, batches=lora["batches"][:2], save=ckpt)
    todo["lora-resume"] = dict(lora, batches=lora["batches"][2:],
                               resume=ckpt)
    todo["ldm-dp2"] = _ldm_job({"data": 2})
    names = list(todo)
    ranks = run_ranks("trainer_jobs", 2, work, [
        {k: v for k, v in todo[n].items() if k != "jax"} for n in names],
        timeout=240)
    one = {"bart-tp2": T.run_trainer_job(todo["bart-tp2"]),
           "adafactor": T.run_trainer_job(todo["adafactor-tensor"]),
           "lora": T.run_trainer_job(lora),
           "ldm-dp2": T.run_trainer_job(todo["ldm-dp2"])}
    ref = {"adafactor": jax_reference(todo["adafactor-tensor"]),
           "lora": jax_reference(lora, LORA),
           "ldm-dp2": jax_reference(todo["ldm-dp2"]),
           "bart-tp2-none": jax_reference(todo["bart-tp2"])}
    for policy in POLICIES:
        ref["bart-tp2-" + policy] = jax_reference(todo["bart-tp2-" + policy])
    return ({n: [r[i] for r in ranks] for i, n in enumerate(names)}, one,
            ref, ckpt)


def _metrics_close(got, want, rtol=STEP_RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=0,
                                       err_msg=k)


def _params_close(got, want, skip=(), atol=UPDATE_ATOL, rtol=UPDATE_RTOL):
    assert set(want) <= set(got)
    for k, w in want.items():
        if k.endswith(skip):
            continue
        w = w.detach().numpy() if torch.is_tensor(w) else w
        np.testing.assert_allclose(got[k].numpy(), w, atol=atol, rtol=rtol,
                                   err_msg=k)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_on_a_tensor_mesh_is_bit_for_bit(jobs, policy):
    ranks = jobs[0]
    for base, got in zip(ranks["remat-none"], ranks["remat-" + policy]):
        assert got["metrics"] == base["metrics"]
        for k, v in base["params"].items():
            assert torch.equal(got["params"][k], v), k
    # the two steps moved the weights, and dropout drew the same masks
    # on both ranks (their losses agree)
    a, b = ranks["remat-" + policy]
    assert a["metrics"] == b["metrics"]


@pytest.mark.parametrize("policy", ("none",) + POLICIES)
def test_remat_on_a_tensor_mesh_matches_jax(jobs, policy):
    """Dropout off: tensor=2 at the policy against JAX's module at the
    same policy (its remat), two AdamW steps."""
    name = "bart-tp2" if policy == "none" else "bart-tp2-" + policy
    ref = jobs[2]["bart-tp2-" + policy]
    for got in jobs[0][name]:
        _metrics_close(got["metrics"], ref["metrics"], JAX_STEP_RTOL)
        _params_close(got["params"], ref["params"],
                      atol=JAX_UPDATE_ATOL, rtol=JAX_UPDATE_RTOL)


def test_bart_on_tensor2_matches_one_process(jobs):
    ranks, one = jobs[0], jobs[1]["bart-tp2"]
    for got in ranks["bart-tp2"]:
        _metrics_close(got["metrics"], one["metrics"])


@pytest.mark.parametrize("axis", ["tensor", "fsdp", "data"])
def test_adafactor_on_a_mesh_matches_one_process(jobs, axis):
    ranks, one, ref = jobs[0], jobs[1]["adafactor"], jobs[2]["adafactor"]
    for got in ranks["adafactor-" + axis]:
        _metrics_close(got["metrics"], one["metrics"])
        _params_close(got["params"], one["params"], skip=KEY_BIAS)
        _metrics_close(got["metrics"], ref["metrics"], JAX_STEP_RTOL)
        _params_close(got["params"], ref["params"],
                      atol=JAX_UPDATE_ATOL, rtol=JAX_UPDATE_RTOL)


def test_lora_resumes_on_tensor2_like_one_process(jobs):
    ranks, one, ref, ckpt = (jobs[0], jobs[1]["lora"], jobs[2]["lora"],
                             jobs[3])
    for save, resume in zip(ranks["lora-save"], ranks["lora-resume"]):
        _metrics_close(save["metrics"] + resume["metrics"], one["metrics"])
        _params_close(resume["params"], one["params"])
        _metrics_close(save["metrics"] + resume["metrics"], ref["metrics"],
                       JAX_STEP_RTOL)
        _params_close(resume["params"], ref["params"], atol=JAX_LORA_ATOL,
                      rtol=0)
    # the checkpoint holds the whole adapters and the merged weights under
    # the inner app's names, as one process writes them
    adapters = torch.load(os.path.join(ckpt, "pytorch_model_lora.bin"),
                          weights_only=True)
    # a and b of 4 weights in each of the 2 layers
    assert len(adapters) == 2 * 4 * 2
    saved = torch.load(os.path.join(ckpt, "optimizer.pt"), weights_only=True)
    assert saved["count"] == 2
    merged = torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                        weights_only=True)
    assert (BERT["vocab_size"], BERT["hidden_size"]) in {
        tuple(t.shape) for t in merged.values()}
    for name, t in adapters.items():
        assert t.shape[0] in (4, 128, 256) and t.shape[-1] in (4, 128, 256)


def test_diffusion_loss_on_data2_matches_one_process(jobs):
    ranks, one, ref = jobs[0], jobs[1]["ldm-dp2"], jobs[2]["ldm-dp2"]
    for got in ranks["ldm-dp2"]:
        _metrics_close(got["metrics"], one["metrics"])
        _metrics_close(got["metrics"], ref["metrics"], JAX_STEP_RTOL)
        _params_close(got["params"], ref["params"],
                      atol=JAX_UPDATE_ATOL, rtol=JAX_UPDATE_RTOL)


def test_norms_sum_in_f64():
    """The Trainer's gradient norm and Adafactor's rms (optimizers.norms)
    sum in f64: over a table of BERT-base's word embeddings (21128 x 768)
    they give the exact norm, whole or summed from two halves as two
    tensor ranks sum it, to within one f32 rounding."""
    from easynlp_tpu_torch.core.optimizers import global_norm, norms
    t = torch.from_numpy(np.random.RandomState(0).standard_normal(
        (21128, 768)).astype(np.float32) * 0.02)
    exact = float(t.double().norm())
    assert abs(float(global_norm([t])) - exact) <= 2.0 ** -23 * exact
    halves = float(norms(list(t.chunk(2))).square().sum().sqrt())
    assert abs(halves - exact) <= 2.0 ** -40 * exact
