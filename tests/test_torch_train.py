"""The port's training path against the JAX package's: losses, optimizers and
schedules, evaluator metrics, and `--mode=train` end to end.

Inputs are made with numpy from a seed and handed to both packages. The
end-to-end runs use one tiny model directory (tests/fixtures/make_fixtures.py
config with hidden_dropout_prob=0, since the two frameworks draw different
dropout streams; weights from test_torch_text_classify.write_weights,
classifier head included) and one 64-row TSV. Both CLIs run in f32 on the
CPU and see the same batches in the same order: the port trains on the JAX
package's own ClassificationDataset and DataLoader.

Bounds: losses and the optimizer updates 1e-6 (f32 arithmetic in the same
order, up to fused multiply-adds); metrics 1e-12 (the same counts in
float64); the trained parameters 1e-5 after four steps at lr 3e-4 (f32
forward/backward in two frameworks, summed in other orders).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
sys.path.insert(0, os.path.dirname(__file__))
from make_fixtures import make_pretrained, make_tsv  # noqa: E402
from test_torch_text_classify import write_weights  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = "id:str:1,sent:str:1,label:str:1"


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _loss_cases():
    rng = np.random.RandomState(0)
    logits = rng.standard_normal((6, 5)).astype(np.float32) * 3
    labels = rng.randint(0, 5, 6).astype(np.int32)
    labels_ign = labels.copy()
    labels_ign[[1, 4]] = -100
    multi = rng.randint(0, 2, (6, 5)).astype(np.int32)
    soft = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    teacher = rng.standard_normal((6, 5)).astype(np.float32)
    a, b = (rng.standard_normal((6, 8)).astype(np.float32) for _ in range(2))
    pm = np.where(rng.rand(6) > 0.5, 1, -1).astype(np.int32)
    sim = np.tanh(rng.standard_normal((6, 6))).astype(np.float32)
    pos = (rng.rand(6, 6) > 0.7).astype(np.int32)
    return {
        "mse_loss": ((logits, teacher), {}),
        "per_sample_cross_entropy": ((logits, labels), {}),
        "cross_entropy": ((logits, labels), {}),
        "cross_entropy-ignore": ((logits, labels_ign), {}),
        "cross_entropy-smoothing": ((logits, labels_ign),
                                    {"label_smoothing": 0.1}),
        "soft_cross_entropy": ((logits, soft), {}),
        "vanilla_kd_loss": ((logits, teacher, labels_ign),
                            {"temperature": 2.0, "alpha": 0.3}),
        "multi_label_sigmoid_ce": ((logits, multi), {}),
        "hinge_loss": ((a[:, 0], b[:, 0]), {}),
        "cosine_embedding_loss": ((a, b, pm), {"margin": 0.1}),
        "circle_loss": ((sim, pos), {}),
        "clip_contrastive_loss": ((sim,), {}),
    }


@pytest.mark.parametrize("name", sorted(_loss_cases()))
def test_losses_match_jax(name):
    from easynlp_tpu.utils import losses as jl
    from easynlp_tpu_torch.utils import losses as tl
    args, kwargs = _loss_cases()[name]
    fn = name.split("-")[0]
    want = np.asarray(getattr(jl, fn)(*map(jnp.asarray, args), **kwargs))
    got = getattr(tl, fn)(*map(torch.from_numpy, args), **kwargs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# optimizers and schedules
# --------------------------------------------------------------------------

SHAPES = {"dense": {"kernel": (4, 3), "bias": (3,)},
          "LayerNorm": {"scale": (3,), "bias": (3,)},
          "emb": {"embedding": (5, 4)}}


def _param_tree(seed):
    rng = np.random.RandomState(seed)
    return {m: {n: rng.standard_normal(s).astype(np.float32)
                for n, s in leaves.items()} for m, leaves in SHAPES.items()}


def _flat(tree):
    return {"%s.%s" % (m, n): v for m, leaves in tree.items()
            for n, v in leaves.items()}


def _run_both(optimizer_type, lr_scheduler, max_grad_norm, steps=10,
              grad_scale=1.0):
    from easynlp_tpu.core.optimizers import get_optimizer as jax_get
    from easynlp_tpu_torch.core.optimizers import get_optimizer as port_get
    kw = dict(optimizer_type=optimizer_type, learning_rate=1e-2,
              warmup_proportion=0.2, lr_scheduler=lr_scheduler, epoch_num=1,
              steps_per_epoch=steps, weight_decay=0.05,
              max_grad_norm=max_grad_norm)
    init = _param_tree(1)
    grads = [_param_tree(10 + i) for i in range(steps)]
    tx, jax_sched, t_total = jax_get(**kw)
    params = jax.tree.map(jnp.asarray, init)
    state = tx.init(params)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in _flat(init).items()]
    opt, port_sched, port_total = port_get(named, **kw)
    assert port_total == t_total == steps
    trail = []
    for i, g in enumerate(grads):
        g = jax.tree.map(lambda x: x * grad_scale, g)
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state,
                                   params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        flat = _flat(g)
        opt.step([torch.from_numpy(np.asarray(flat[n])) for n, _ in named])
        np.testing.assert_allclose(port_sched(i), float(jax_sched(i)),
                                   rtol=1e-6, atol=1e-12)
        trail.append(({k: np.asarray(v) for k, v in _flat(params).items()},
                      {n: p.detach().numpy().copy() for n, p in named}))
    return trail, init


@pytest.mark.parametrize("schedule", [
    "warmup_linear", "warmup_constant", "warmup_cosine",
    "warmup_cosine_with_hard_restarts", "constant"])
@pytest.mark.parametrize("optimizer_type", ["AdamW", "Adam", "BertAdam",
                                            "SGD"])
def test_optimizer_matches_jax(optimizer_type, schedule):
    """Ten steps of random gradients, large enough (x5) that the global-norm
    clip (max_grad_norm=1) acts on every step, BertAdam's own clip
    included; parameters agree after every step."""
    trail, init = _run_both(optimizer_type, schedule, max_grad_norm=1.0,
                            grad_scale=5.0)
    for jax_params, port_params in trail:
        for k in jax_params:
            np.testing.assert_allclose(port_params[k], jax_params[k],
                                       atol=1e-6, rtol=0)
    if schedule == "warmup_linear":
        # the schedule is read before the count increments: step 1 has lr 0
        for k, v in _flat(init).items():
            np.testing.assert_array_equal(trail[0][1][k], v)


def test_sgd_without_clip_moves_unlike_jax():
    """ROADMAP C8: optax.clip_by_global_norm(0) scales every update to 0,
    so the JAX SGD (built with max_grad_norm=0 by its Trainer) never moves;
    the port leaves the clip out at 0 and takes the step."""
    trail, init = _run_both("SGD", "constant", max_grad_norm=0.0, steps=2)
    jax_params, port_params = trail[-1]
    grads = [_flat(_param_tree(10 + i)) for i in range(2)]
    for k, v in _flat(init).items():
        np.testing.assert_array_equal(jax_params[k], v)
        np.testing.assert_allclose(
            port_params[k], v - 1e-2 * (grads[0][k] + grads[1][k]),
            atol=1e-6)


def test_optimizer_state_round_trips():
    from easynlp_tpu_torch.core.optimizers import get_optimizer
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in _flat(_param_tree(1)).items()]
    opt, _, _ = get_optimizer(named, optimizer_type="AdamW",
                              steps_per_epoch=5, epoch_num=1)
    opt.step([torch.ones_like(p) for _, p in named])
    again, _, _ = get_optimizer(named, optimizer_type="AdamW",
                                steps_per_epoch=5, epoch_num=1)
    again.load_state_dict(opt.state_dict())
    assert again.count == 1
    for a, b in zip(again.state["nu"], opt.state["nu"]):
        assert torch.equal(a, b)
    bert, _, _ = get_optimizer(named, optimizer_type="BertAdam")
    with pytest.raises(ValueError, match="AdamW"):
        bert.load_state_dict(opt.state_dict())


# --------------------------------------------------------------------------
# evaluator metrics
# --------------------------------------------------------------------------

def _metric_cases():
    rng = np.random.RandomState(3)
    two = rng.standard_normal((40, 2)).astype(np.float32)
    two[:12] = two[12:24]  # tied scores across rows for the AUC
    three = rng.standard_normal((45, 3)).astype(np.float32)
    return {
        "2-class-ties": (two, rng.randint(0, 2, 40), None),
        "2-class-report": (two, rng.randint(0, 2, 40),
                           ["classification_report"]),
        "3-class": (three, rng.randint(0, 3, 45), ["precision_recall"]),
        "3-class-missing-label": (three, rng.randint(0, 2, 45), None),
        "regression": (three[:, :1], rng.standard_normal(45), None),
    }


@pytest.mark.parametrize("name", sorted(_metric_cases()))
def test_metrics_match_sklearn_evaluator(name):
    from easynlp_tpu.appzoo.sequence_classification.evaluator import (
        SequenceClassificationEvaluator as JaxEvaluator)
    from easynlp_tpu_torch.appzoo.sequence_classification.evaluator import (
        single_label_metrics)
    logits, labels, requested = _metric_cases()[name]
    jax_eval = JaxEvaluator.__new__(JaxEvaluator)
    jax_eval.eval_metrics = requested
    want = jax_eval._single_label_metrics(logits, labels)
    got = single_label_metrics(logits, labels, requested)
    assert [m for m, _ in got] == [m for m, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-12)


# --------------------------------------------------------------------------
# --mode=train end to end
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_train"))
    model_dir = make_pretrained(os.path.join(base, "model"))
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = json.load(f)
    cfg["hidden_dropout_prob"] = 0.0
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    write_weights(model_dir)
    make_tsv(os.path.join(base, "train.tsv"), 64, seed=1)
    make_tsv(os.path.join(base, "dev.tsv"), 24, seed=2)
    return base


def _common(base):
    return ["--app_name=text_classify", "--input_schema=" + SCHEMA,
            "--first_sequence=sent", "--label_name=label",
            "--sequence_length=16", "--dtype=float32"]


def train_argv(base, ckpt, *extra):
    return ["--mode=train", "--tables=%s/train.tsv,%s/dev.tsv" % (base, base),
            "--checkpoint_dir=" + ckpt, "--epoch_num=1",
            "--learning_rate=3e-4", "--logging_steps=1",
            "--pretrained_model_name_or_path=%s/model" % base,
            *_common(base), *extra]


def _fresh_args():
    from easynlp_tpu.utils import global_vars
    global_vars._GLOBAL_ARGS = None


@pytest.fixture(autouse=True)
def _restore_global_args():
    from easynlp_tpu.utils import global_vars
    saved = global_vars._GLOBAL_ARGS
    yield
    global_vars._GLOBAL_ARGS = saved


def _run_port(argv):
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    _fresh_args()
    return default_main_fn(initialize_easynlp(args_list=argv
                                              + ["--device=cpu"]))


def _run_jax(argv):
    from easynlp_tpu.appzoo.api import default_main_fn
    from easynlp_tpu.utils.initializer import initialize_easynlp
    _fresh_args()
    return default_main_fn(initialize_easynlp(args_list=argv))


def _jax_state(trainer):
    from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
        state_dict_from_jax)
    params = jax.tree.map(np.asarray, trainer.app.params)
    state = {"bert." + k: v.numpy() for k, v in state_dict_from_jax(
        params["backbone"], trainer.app.config).items()}
    state["classifier.weight"] = params["classifier"]["kernel"].T
    state["classifier.bias"] = params["classifier"]["bias"]
    return state


TRAJECTORIES = {
    "adamw-warmup_linear-accum1": ["--optimizer_type=AdamW",
                                   "--lr_scheduler=warmup_linear",
                                   "--micro_batch_size=16"],
    "bertadam-accum2-clipped": ["--optimizer_type=BertAdam",
                                "--micro_batch_size=8",
                                "--gradient_accumulation_steps=2",
                                "--max_grad_norm=0.5"],
}


@pytest.fixture(scope="module")
def trajectories(tiny):
    """Both CLIs on each configuration: (jax trainer, port trainer, port
    checkpoint dir)."""
    out = {}
    for name, extra in TRAJECTORIES.items():
        j = _run_jax(train_argv(tiny, os.path.join(tiny, "jax_" + name),
                                *extra))
        ckpt = os.path.join(tiny, "port_" + name)
        out[name] = (j, _run_port(train_argv(tiny, ckpt, *extra)), ckpt)
    return out


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_training_trajectory_matches_jax(trajectories, name):
    """Four steps through each CLI: the same losses and grad norms step by
    step, the same final parameters (the port's saved pytorch_model.bin
    against the JAX trainer's params), the same evaluation."""
    from easynlp_tpu.utils.io_utils import io
    jax_trainer, port, ckpt = trajectories[name]
    assert port.global_step == jax_trainer.global_step == 4
    assert port.nonfinite_skips == 0
    want = _jax_state(jax_trainer)
    got = torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                     weights_only=True)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=1e-5, err_msg=k)
    init = torch.load(os.path.join(os.path.dirname(ckpt), "model",
                                   "pytorch_model.bin"), weights_only=True)
    moved = max(float((got[k] - init[k]).abs().max()) for k in got)
    assert moved > 1e-4  # the comparison is not vacuous
    events = {}
    for tag, path in (("jax", jax_trainer.args.checkpoint_dir),
                      ("port", ckpt)):
        with io.open(os.path.join(path, "events.jsonl")) as f:
            events[tag] = [json.loads(line) for line in f]
    train_j = [e for e in events["jax"] if e["kind"] == "train"]
    train_p = [e for e in events["port"] if e["kind"] == "train"]
    assert len(train_j) == len(train_p) == 4
    for ej, ep in zip(train_j, train_p):
        for key in ("loss", "grad_norm", "lr", "nonfinite_skip"):
            np.testing.assert_allclose(ep[key], ej[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    eval_j = [e for e in events["jax"] if e["kind"] == "eval"][-1]
    eval_p = [e for e in events["port"] if e["kind"] == "eval"][-1]
    assert set(eval_p) == set(eval_j)
    for key in eval_j:
        if key != "kind":
            np.testing.assert_allclose(eval_p[key], eval_j[key], atol=1e-9)
    for artifact in ("pytorch_model.bin", "config.json", "vocab.txt",
                     "label_mapping.json", "train_config.json", "meta.json",
                     "optimizer.pt"):
        assert os.path.exists(os.path.join(ckpt, artifact)), artifact


def test_train_then_evaluate_then_predict(trajectories, tiny):
    """The port's evaluate and predict modes on the checkpoint its train mode
    wrote: the evaluation repeats the trainer's final one, and predict's
    labels are the argmax of its probabilities."""
    _, port, ckpt = trajectories["adamw-warmup_linear-accum1"]
    results = _run_port(["--mode=evaluate", "--tables=%s/dev.tsv" % tiny,
                         "--checkpoint_dir=" + ckpt, "--micro_batch_size=16",
                         *_common(tiny)])
    with open(os.path.join(ckpt, "events.jsonl")) as f:
        final = [json.loads(line) for line in f][-1]
    assert [m for m, _ in results] == ["accuracy", "f1", "auc", "mcc"]
    for metric, score in results:
        assert score == pytest.approx(final[metric], abs=1e-12)
    out = os.path.join(tiny, "pred_after_train.tsv")
    _run_port(["--mode=predict", "--tables=%s/dev.tsv" % tiny,
               "--outputs=" + out, "--checkpoint_dir=" + ckpt,
               "--output_schema=predictions,probabilities",
               "--micro_batch_size=16", *_common(tiny)])
    with open(out) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert len(rows) == 24
    for label, probs in rows:
        p = [float(x) for x in probs.split()]
        assert label == ("neg", "pos")[int(np.argmax(p))]
        assert abs(sum(p) - 1) < 1e-5


def test_resume_replays_the_uninterrupted_run(tiny):
    """A run saved after step 2 and resumed from there (weights, optimizer
    state, step counter, the mid-epoch skip) ends where the uninterrupted
    run ends."""
    full = os.path.join(tiny, "resume_full")
    _run_port(train_argv(tiny, full, "--micro_batch_size=16",
                         "--save_checkpoint_steps=2",
                         "--save_all_checkpoints"))
    resumed = os.path.join(tiny, "resume_tail")
    trainer = _run_port(train_argv(
        tiny, resumed, "--micro_batch_size=16",
        "--resume_from_checkpoint=%s/step_2" % full))
    assert [r["step"] for r in trainer.step_records] == [3, 4]
    a = torch.load(os.path.join(full, "pytorch_model.bin"), weights_only=True)
    b = torch.load(os.path.join(resumed, "pytorch_model.bin"),
                   weights_only=True)
    for k in a:
        torch.testing.assert_close(b[k], a[k], atol=1e-7, rtol=0)


def test_nonfinite_step_is_skipped(tiny, monkeypatch):
    """A non-finite loss leaves parameters and optimizer state untouched
    and is counted."""
    from easynlp_tpu_torch.appzoo.sequence_classification import model as M
    real = M.SequenceClassification.loss_fn
    calls = []

    def poisoned(outputs, batch):
        calls.append(1)
        out = real(outputs, batch)
        if len(calls) == 2:
            out["loss"] = out["loss"] * float("nan")
        return out
    monkeypatch.setattr(M.SequenceClassification, "loss_fn",
                        staticmethod(poisoned))
    trainer = _run_port(train_argv(tiny, os.path.join(tiny, "nan"),
                                   "--micro_batch_size=16"))
    assert [r["nonfinite_skip"] for r in trainer.step_records] == [0, 1, 0, 0]
    assert trainer.nonfinite_skips == 1
    assert trainer.optimizer.count == 3


@pytest.mark.parametrize("flag", ["--remat=full", "--ema_decay=0.9",
                                  "--async_save", "--optimizer_type=Lion",
                                  "--num_processes=2"])
def test_unported_training_options_raise(tiny, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run_port(train_argv(tiny, os.path.join(tiny, "refused"),
                             "--micro_batch_size=16", flag))


def test_host_prefetch_depth_is_refused(tiny):
    """ROADMAP C13, resolved by A6c: the port used to refuse
    --num_host_prefetch above 0, having no prefetcher. Now the flag
    defaults to 2, as the JAX package's does, and sets the depth of the
    host-to-device prefetch; 0 turns it off. The same run at depth 2 (the
    default) and depth 0 sees the same batches in the same order: the same
    losses and final parameters, bit for bit."""
    runs = {}
    for depth in ("default", "0"):
        ckpt = os.path.join(tiny, "prefetch_" + depth)
        extra = [] if depth == "default" else ["--num_host_prefetch=0"]
        trainer = _run_port(train_argv(tiny, ckpt, "--micro_batch_size=16",
                                       *extra))
        assert trainer.global_step == 4
        assert trainer.prefetch_depth == (2 if depth == "default" else 0)
        runs[depth] = (trainer, torch.load(
            os.path.join(ckpt, "pytorch_model.bin"), weights_only=True))
    (on, on_state), (off, off_state) = runs["default"], runs["0"]
    assert [r["loss"] for r in on.step_records] == \
        [r["loss"] for r in off.step_records]
    for k in on_state:
        assert torch.equal(on_state[k], off_state[k]), k


def test_train_cli_imports_no_jax_or_sklearn(tiny):
    """--mode=train, then --mode=evaluate on its checkpoint, in a fresh
    process: neither loads jax, flax, optax, sklearn or any module of the
    JAX package."""
    ckpt = os.path.join(tiny, "nojax")
    evaluate = ["--mode=evaluate", "--tables=%s/dev.tsv" % tiny,
                "--checkpoint_dir=" + ckpt, "--micro_batch_size=16",
                "--device=cpu", *_common(tiny)]
    code = (
        "import sys\n"
        "from easynlp_tpu_torch.cli import main\n"
        "assert main(%r) == 0\n"
        "assert main(%r) == 0\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', "
        "'sklearn', 'easynlp_tpu') or m.startswith('easynlp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n" % (train_argv(tiny, ckpt, "--device=cpu",
                                             "--micro_batch_size=16"),
                                   evaluate))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert os.path.exists(os.path.join(ckpt, "pytorch_model.bin"))
