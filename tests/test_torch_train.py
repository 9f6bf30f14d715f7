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


# Lion and Adafactor against optax itself: the JAX package's Lion decays
# every parameter (optax.lion without a mask) where the port masks biases
# and LayerNorm as its AdamW does, and its Adafactor leaves are [in, out]
# where the port's are [out, in]; the updates are held to optax's chain
# with the port's mask, over leaves of both layouts.
OPTAX_SHAPES = {"dense.weight": (256, 130), "wide.weight": (128, 300),
                "square.weight": (128, 128), "tall.weight": (300, 129),
                "small.weight": (5, 4), "dense.bias": (3,),
                "LayerNorm.weight": (200,), "emb.weight": (130, 127)}


def _optax_run(optimizer_type, schedule, steps=10, apply=None):
    """Ten steps of x5 random gradients through the port's optimizer and
    optax's: [(optax params, port params)] after each step."""
    import optax
    from easynlp_tpu_torch.core import optimizers as O
    rng = np.random.RandomState(4)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in OPTAX_SHAPES.items()}
    sched = O.SCHEDULES[schedule](1e-2, warmup=0.2, t_total=steps)
    named = [(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
             for k, v in init.items()]
    if optimizer_type == "Lion":
        opt = O.Lion(named, sched, weight_decay=0.05, max_grad_norm=1.0,
                     num_steps=steps)
        tx = optax.chain(optax.clip_by_global_norm(1.0), optax.lion(
            sched, weight_decay=0.05,
            mask={k: O.decays(k) for k in OPTAX_SHAPES}))
    else:
        opt = O.Adafactor(named, sched, num_steps=steps)
        tx = optax.adafactor(sched)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    trail = []
    for _ in range(steps):
        g = {k: (5 * rng.standard_normal(s)).astype(np.float32)
             for k, s in OPTAX_SHAPES.items()}
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.from_numpy(g[n]) for n, _ in named])
        trail.append(({k: np.asarray(v) for k, v in params.items()},
                      {n: p.detach().numpy().copy() for n, p in named}))
    return trail, init, opt


@pytest.mark.parametrize("schedule", ["warmup_linear", "constant"])
@pytest.mark.parametrize("optimizer_type", ["Lion", "Adafactor"])
def test_lion_and_adafactor_match_optax(optimizer_type, schedule):
    """After every step each parameter is within 1e-6 of optax's, relative
    to the largest parameter (N(0, 1) leaves: 1e-6 of ~4). Adafactor
    factors the leaves whose two largest dims are >= 128 (4 of 8 here)."""
    trail, init, opt = _optax_run(optimizer_type, schedule)
    scale = max(float(np.abs(v).max()) for v in init.values())
    for want, got in trail:
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6 * scale,
                                       rtol=0, err_msg=k)
    moved = max(float(np.abs(trail[-1][1][k] - init[k]).max())
                for k in init)
    assert moved > 1e-2
    if optimizer_type == "Adafactor":
        assert sum(d is not None for d in opt.factored) == 4


def test_lion_without_clip_moves_unlike_jax():
    """ROADMAP C8, Lion's case: the JAX package chains
    clip_by_global_norm(max_grad_norm) before optax.lion and its Trainer
    passes 0, so in a JAX Lion run through the Trainer the gradients never
    move the parameters: clip(0) zeroes them, and only the weight decay
    (on every leaf: optax.lion gets no mask there) shrinks them. The port
    leaves the clip out at 0 and takes the step: p - lr sign(0.1 g) - lr
    wd p on the decayed leaves."""
    trail, init = _run_both("Lion", "constant", max_grad_norm=0.0, steps=1)
    jax_params, port_params = trail[-1]
    g = _flat(_param_tree(10))
    for k, v in _flat(init).items():
        np.testing.assert_allclose(jax_params[k], v * (1 - 1e-2 * 0.05),
                                   atol=1e-6, rtol=0)
        wd = 0.05 if "bias" not in k and "LayerNorm" not in k else 0.0
        np.testing.assert_allclose(
            port_params[k], v - 1e-2 * (np.sign(0.1 * g[k]) + wd * v),
            atol=1e-6)


@pytest.mark.parametrize("optimizer_type", ["Lion", "Adafactor"])
def test_skipped_step_keeps_state_bit_identical(optimizer_type):
    """A step with apply=False (the Trainer's non-finite guard), first and
    after three real steps: parameters, every state buffer and the count
    stay bit for bit as they were (for Adafactor also before its second
    moments hold anything), and the next real step goes on from there."""
    from easynlp_tpu_torch.core import optimizers as O
    rng = np.random.RandomState(5)
    named = [(k, torch.nn.Parameter(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))))
        for k, s in OPTAX_SHAPES.items()]
    opt = getattr(O, optimizer_type)(
        named, O.constant_schedule(1e-2), num_steps=10)

    def snapshot():
        return ([p.detach().clone() for p in opt.params],
                {k: [t.clone() for t in v] for k, v in opt.state.items()},
                int(opt.count))

    def grads(bad=False):
        out = [torch.from_numpy(rng.standard_normal(p.shape).astype(
            np.float32)) for p in opt.params]
        if bad:
            out[0][0, 0] = float("nan")
        return out
    for real_steps in (0, 3):
        for _ in range(real_steps):
            opt.step(grads(), apply=torch.tensor(True))
        before = snapshot()
        opt.step(grads(bad=True), apply=torch.tensor(False))
        after = snapshot()
        assert after[2] == before[2] == real_steps
        for a, b in zip(before[0], after[0]):
            assert torch.equal(a, b)
        for key in before[1]:
            for a, b in zip(before[1][key], after[1][key]):
                assert torch.equal(a, b), key
    opt.step(grads(), apply=torch.tensor(True))
    assert int(opt.count) == 4
    assert all(torch.isfinite(p).all() for p in opt.params)
    assert not all(torch.equal(a, p) for a, p in zip(before[0], opt.params))


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
    big = [("w", torch.nn.Parameter(torch.ones(128, 130))),
           ("b", torch.nn.Parameter(torch.ones(130)))]
    ada, _, _ = get_optimizer(big, optimizer_type="Adafactor")
    ada.step([torch.full_like(p, 0.5) for _, p in big])
    again, _, _ = get_optimizer(big, optimizer_type="Adafactor")
    again.load_state_dict(ada.state_dict())
    assert again.count == 1
    for key in ("v_row", "v_col", "v"):
        assert len(again.state[key]) == 1
        assert torch.equal(again.state[key][0], ada.state[key][0])


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
    # Attention's key biases get no gradient in exact arithmetic (softmax
    # ignores a shift shared by all of a query's scores), and Adafactor
    # divides each gradient by its own rms, so it turns their f32 rounding
    # noise into steps of lr x rms(bias) (~0.02) in either direction, in
    # each framework its own: at lr 5e-5 four such steps stay within
    # 2 x 4 x 5e-5 x 0.02 = 8e-6 of each other, inside the 1e-5 bound.
    "adafactor-constant": ["--optimizer_type=Adafactor",
                           "--micro_batch_size=16", "--learning_rate=5e-5",
                           "--lr_scheduler=constant"],
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


def test_lion_trains_through_the_cli(tiny):
    """--optimizer_type=Lion through the port's Trainer (which passes
    max_grad_norm=0 and clips itself): four finite steps that move the
    weights, where the JAX Trainer's Lion leaves the gradients out (C8)."""
    ckpt = os.path.join(tiny, "lion")
    trainer = _run_port(train_argv(tiny, ckpt, "--micro_batch_size=16",
                                   "--optimizer_type=Lion",
                                   "--lr_scheduler=constant",
                                   "--learning_rate=1e-4"))
    assert trainer.global_step == 4 and trainer.nonfinite_skips == 0
    assert all(np.isfinite(r["loss"]) for r in trainer.step_records)
    got = torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                     weights_only=True)
    init = torch.load(os.path.join(tiny, "model", "pytorch_model.bin"),
                      weights_only=True)
    # every step moves each weight by lr (the sign), decay aside
    moved = (got["bert.encoder.layer.0.intermediate.dense.weight"]
             - init["bert.encoder.layer.0.intermediate.dense.weight"]).abs()
    assert float(moved.max()) == pytest.approx(4e-4, rel=1e-2)


# --remat, --ema_decay and --async_save are ported
# (test_torch_trainer_options.py); multi-process and mesh training (A23)
# since slice 15 (test_torch_parallel.py): --mesh on one process trains,
# and what the JAX package refuses is refused
@pytest.mark.parametrize("flag", ["--num_processes=2", "--mesh=dp=1",
                                  "--mesh=dp=1,tp=2"])
def test_unported_training_options_raise(tiny, flag):
    """--mesh=dp=1 starts a one-process group (gloo, an in-process
    store) and trains as the run without it: the same losses and weights,
    bit for bit. --num_processes=2 with no rendezvous raises naming the
    flags that give one. --mesh=dp=1,tp=2 on one process raises the
    device-count mismatch, as JAX's parse_mesh_spec does
    (utils/arguments.py:220-222)."""
    argv = train_argv(tiny, os.path.join(tiny, "mesh"),
                      "--micro_batch_size=16", flag)
    if flag == "--num_processes=2":
        with pytest.raises(ValueError, match="coordinator_address"):
            _run_port(argv)
        return
    if flag == "--mesh=dp=1,tp=2":
        with pytest.raises(ValueError, match="uses 2 devices but 1"):
            _run_port(argv)
        return
    meshed = _run_port(argv)
    plain = _run_port(train_argv(tiny, os.path.join(tiny, "no_mesh"),
                                 "--micro_batch_size=16"))
    assert meshed.mesh is None and meshed.global_step == 4
    assert [r["loss"] for r in meshed.step_records] == \
        [r["loss"] for r in plain.step_records]
    got = torch.load(os.path.join(tiny, "mesh", "pytorch_model.bin"),
                     weights_only=True)
    want = torch.load(os.path.join(tiny, "no_mesh", "pytorch_model.bin"),
                      weights_only=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k


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
