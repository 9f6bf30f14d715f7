"""The port Trainer's --remat, --ema_decay and --async_save against the JAX
package's, in f32 on the CPU.

- --remat=full|selective|names: BERT text_classify (test_torch_text_match's
  tiny BERT) and BART seq2seq (test_torch_bart's tiny BART) give the same
  loss and gradients as --remat=none bit for bit in the port, dropout on
  (the recompute replays the RNG). Against JAX's module at the same policy
  with dropout off: the loss within 1e-6, the gradients within 1e-6 for
  BERT and 1e-5 for BART, whose 0.5-scale embeddings give larger
  gradients (f32 in two frameworks, summed in other orders; no policy
  changes the arithmetic of either package).
- --ema_decay: the EMA update against the JAX ema_update on the same
  parameter sequence (1e-6: the same f32 operations in the same order);
  after 4 steps through both CLIs the port's pytorch_model_ema.bin against
  the JAX Trainer's flax_params_ema.msgpack within 1e-6 (at decay 0.9 the
  warm-up keeps most of the shadow at the starting weights, which are
  equal; the trained ones agree to 1e-5, test_torch_train.py); the shadow
  moves on a skipped step; resume restores the shadow and its count
  exactly (the JAX package's test_e2e_classification.py::test_4b).
- --async_save: the artifacts equal a synchronous save's, and a failed
  write raises at the end of training (::test_4c).
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_text_match import (
    _restore_global_args,  # noqa: F401
    jax_params,
    make_bert_dir,
    port_module,
    run_jax,
    run_port,
)

SCHEMA = "id:str:1,sent:str:1,label:str:1"
POLICIES = ("full", "selective", "names")


# --------------------------------------------------------------------------
# --remat
# --------------------------------------------------------------------------

def _bert(policy, seed=3):
    """(JAX module at `policy`, params, port module, inputs, batch)."""
    from easynlp_tpu.appzoo.sequence_classification.model import (
        SequenceClassification as JaxApp)
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        SequenceClassification, state_dict_from_jax)
    from test_torch_text_match import TINY
    config = dict(TINY, model_type="bert", vocab_size=60,
                  max_position_embeddings=64, type_vocab_size=2,
                  layer_norm_eps=1e-12, initializer_range=0.02,
                  hidden_act="gelu", hidden_dropout_prob=0.1)
    cfg, module, params = jax_params(
        JaxApp, config, seed=seed, num_labels=3,
        args=SimpleNamespace(remat=policy))
    tmodule = port_module(SequenceClassification,
                          state_dict_from_jax(params, cfg), config,
                          num_labels=3)
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, 60, (4, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([12, 7, 3, 10])[:, None]).astype(
        np.int32)
    inputs = {"input_ids": ids, "attention_mask": mask,
              "token_type_ids": np.zeros_like(ids)}
    batch = {"label_ids": rng.randint(0, 3, 4).astype(np.int32)}
    return JaxApp, module, params, SequenceClassification, tmodule, inputs, \
        batch


def _bart(policy, seed=3):
    from easynlp_tpu.appzoo.sequence_generation.model import (
        SequenceGeneration as JaxApp)
    from easynlp_tpu.modelzoo.models.bart import BartConfig as JaxBartConfig
    from easynlp_tpu.modelzoo.models.bart.conversion import (
        convert_bart_state_dict)
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    from easynlp_tpu_torch.modelzoo.models.bart import BartConfig
    from test_torch_bart import TINY, hf_state_dict
    jcfg = JaxBartConfig(**TINY)
    state = hf_state_dict(jcfg, seed)
    params = convert_bart_state_dict(state, jcfg)
    module = JaxApp.build_module(jcfg, args=SimpleNamespace(remat=policy),
                                 dtype=jnp.float32)
    config = BartConfig(**dict(TINY, dropout=0.1, activation_dropout=0.1))
    tmodule = SequenceGeneration.build_module(config, dtype=torch.float32,
                                              device="cpu")
    SequenceGeneration.load_state_dict(
        tmodule, {k: torch.from_numpy(v) for k, v in state.items()})
    rng = np.random.RandomState(seed)
    src = rng.randint(3, 120, (3, 10)).astype(np.int32)
    src_mask = (np.arange(10)[None] < np.array([10, 6, 8])[:, None]).astype(
        np.int32)
    dec = rng.randint(3, 120, (3, 6)).astype(np.int32)
    dec_mask = (np.arange(6)[None] < np.array([6, 4, 2])[:, None]).astype(
        np.int32)
    labels = np.where(dec_mask == 1, rng.randint(3, 120, (3, 6)),
                      -100).astype(np.int32)
    inputs = {"input_ids": src, "attention_mask": src_mask,
              "decoder_input_ids": dec, "decoder_attention_mask": dec_mask}
    return JaxApp, module, params, SequenceGeneration, tmodule, inputs, \
        {"labels": labels}


# the loss bound: an absolute floor plus 4 f32 ulps of the loss (2**-23
# of its magnitude each), since XLA:CPU's and the port's sums may land a
# few ulps apart, by host CPU, at losses near 9
MODELS = {"bert": (_bert, 1e-6, 1e-6), "bart": (_bart, 1e-6, 1e-5)}
LOSS_ULPS = 4 * 2.0 ** -23


def _port_loss_grads(port_app, tmodule, inputs, batch, policy, train):
    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        set_remat)
    set_remat(tmodule, policy)
    tmodule.train(train)
    tmodule.zero_grad()
    torch.manual_seed(11)
    out = tmodule(**{k: torch.from_numpy(v) for k, v in inputs.items()})
    loss = port_app.loss_fn(out, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})["loss"]
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in tmodule.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("model", sorted(MODELS))
def test_remat_matches_none_and_jax(model, policy):
    make, loss_atol, grad_atol = MODELS[model]
    jax_app, module, params, port_app, tmodule, inputs, batch = make(policy)
    # the port, dropout on: bit for bit against no remat
    base_loss, base_grads = _port_loss_grads(port_app, tmodule, inputs,
                                             batch, "none", True)
    loss, grads = _port_loss_grads(port_app, tmodule, inputs, batch, policy,
                                   True)
    assert torch.equal(loss, base_loss)
    for n, g in base_grads.items():
        assert torch.equal(grads[n], g), n
    # against JAX's module at the same policy, dropout off
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_loss(p):
        out = module.apply({"params": p}, **jin, deterministic=True)
        return jax_app.loss_fn(out, jbatch)["loss"]

    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    loss, grads = _port_loss_grads(port_app, tmodule, inputs, batch, policy,
                                   False)
    assert abs(float(loss) - float(want_loss)) \
        <= loss_atol + LOSS_ULPS * abs(float(want_loss))
    want = port_app.state_dict_from_jax(
        jax.tree.map(np.asarray, want_grads), tmodule.config)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(),
                                   atol=grad_atol, rtol=0, err_msg=n)


def test_remat_policies_recompute_what_they_drop():
    """What each policy recomputes in the backward of the tiny BERT (2
    layers): 'full' every projection (6 a layer) and the attention; the
    other two keep q/k/v and the attention out of the recomputed part,
    'names' recomputes the intermediate projection (JAX's mlp_wi_out, 1 a
    layer) and 'selective' none; all recompute LayerNorm and gelu. An
    unknown policy is refused."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
        set_remat)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            key = func.overloadpacket.__name__
            self.ops[key] = self.ops.get(key, 0) + 1
            return func(*args, **(kwargs or {}))

    *_, port_app, tmodule, inputs, batch = _bert("none")
    counts = {}
    for policy in ("none",) + POLICIES:
        set_remat(tmodule, policy)
        out = tmodule(**{k: torch.from_numpy(v) for k, v in inputs.items()})
        loss = port_app.loss_fn(out, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})["loss"]
        count = Count()
        with count:
            loss.backward()
        counts[policy] = count.ops
    forward_ops = ("addmm", "native_layer_norm", "gelu")
    assert all(op not in counts["none"] for op in forward_ops)
    assert counts["full"]["addmm"] == 12
    assert counts["full"]["bmm"] > counts["none"]["bmm"]  # the attention
    assert "addmm" not in counts["selective"]
    assert counts["names"]["addmm"] == 2
    for policy in POLICIES:
        assert counts[policy]["native_layer_norm"] == 4
        assert counts[policy]["gelu"] == 2
    with pytest.raises(ValueError, match="remat"):
        set_remat(tmodule, "everything")


def test_remat_trains_through_the_cli(tmp_path):
    """--remat on the port's CLI: BERT text_classify takes the same losses
    at every policy, bit for bit."""
    base = str(tmp_path)
    _make_tables(base)
    losses = {}
    for policy in ("none",) + POLICIES:
        trainer = run_port(_train_argv(base, os.path.join(base, policy),
                                       "--remat=" + policy))
        assert trainer.remat == policy
        losses[policy] = [r["loss"] for r in trainer.step_records]
    assert all(v == losses["none"] for v in losses.values())


# --------------------------------------------------------------------------
# --ema_decay
# --------------------------------------------------------------------------

def test_ema_update_matches_jax():
    """Four updates of one shadow by a sequence of random parameters, at
    decay 0.99 (the warm-up's (1 + n) / (10 + n) rules the first steps)
    and without the count."""
    from easynlp_tpu.modelzoo.models.latent_diffusion import ema as jax_ema
    from easynlp_tpu_torch.modelzoo.models.latent_diffusion import ema
    rng = np.random.RandomState(0)
    shapes = [(5, 3), (3,), (2, 2, 2)]
    steps = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    for use_n in (True, False):
        jstate = jax_ema.ema_init([jnp.asarray(x) for x in steps[0]])
        state = ema.ema_init([torch.from_numpy(x) for x in steps[0]])
        for params in steps[1:]:
            jstate = jax_ema.ema_update(jstate, [jnp.asarray(x)
                                                 for x in params],
                                        decay=0.99, use_num_updates=use_n)
            ema.ema_update(state, [torch.from_numpy(x) for x in params],
                           decay=0.99, use_num_updates=use_n)
        assert int(state["num_updates"]) == int(jstate["num_updates"]) == 4
        for got, want in zip(state["shadow"], jstate["shadow"]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=0)
        like = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
        assert all(x.dtype == torch.bfloat16
                   for x in ema.ema_params(state, like))


def _make_tables(base):
    from make_fixtures import make_tsv
    make_bert_dir(os.path.join(base, "model"), heads={"classifier": 2})
    make_tsv(os.path.join(base, "train.tsv"), 32, seed=1)
    make_tsv(os.path.join(base, "dev.tsv"), 12, seed=2)


def _train_argv(base, ckpt, *extra):
    return ["--mode=train", "--app_name=text_classify",
            "--tables=%s/train.tsv,%s/dev.tsv" % (base, base),
            "--input_schema=" + SCHEMA, "--first_sequence=sent",
            "--label_name=label", "--sequence_length=16",
            "--micro_batch_size=8", "--dtype=float32", "--epoch_num=1",
            "--learning_rate=1e-3", "--logging_steps=1",
            "--pretrained_model_name_or_path=%s/model" % base,
            "--checkpoint_dir=" + ckpt, *extra]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_trainer_options"))
    _make_tables(base)
    return base


def test_ema_after_four_steps_matches_the_jax_trainer(tables):
    from easynlp_tpu.modelzoo.modeling_utils import load_params
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        state_dict_from_jax)
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    jax_trainer = run_jax(_train_argv(tables, os.path.join(tables, "jax_ema"),
                                      "--ema_decay=0.9"))
    ckpt = os.path.join(tables, "port_ema")
    trainer = run_port(_train_argv(tables, ckpt, "--ema_decay=0.9"))
    assert trainer.global_step == jax_trainer.global_step == 4
    with open(os.path.join(ckpt, "meta.json")) as f:
        assert json.load(f)["ema_num_updates"] == 4
    jax_ema = load_params(jax_trainer.args.checkpoint_dir,
                          target=jax.device_get(jax_trainer.params),
                          name="flax_params_ema.msgpack")
    config = BertConfig.from_pretrained(ckpt)
    want = {k.replace("backbone.", "bert.", 1): v
            for k, v in state_dict_from_jax(
                jax.tree.map(np.asarray, jax_ema), config).items()}
    got = torch.load(os.path.join(ckpt, "pytorch_model_ema.bin"),
                     weights_only=True)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)
    final = torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                       weights_only=True)
    assert max(float((got[k] - final[k]).abs().max()) for k in got) > 1e-5


def test_ema_moves_on_a_skipped_step(tables, monkeypatch):
    """A non-finite step leaves the parameters as they were, and the EMA
    still takes its update towards them, as the JAX Trainer's does."""
    from easynlp_tpu_torch.appzoo.sequence_classification import model as M
    from easynlp_tpu_torch.core import trainer as trainer_mod
    real_loss, real_update = M.SequenceClassification.loss_fn, \
        trainer_mod.ema_update
    calls, seen = [], []

    def poisoned(outputs, batch):
        calls.append(1)
        out = real_loss(outputs, batch)
        if len(calls) == 3:  # step 1 runs at lr 0: step 2 moves
            out["loss"] = out["loss"] * float("nan")
        return out

    def update(state, params, decay):
        before = [s.clone() for s in state["shadow"]]
        real_update(state, params, decay=decay)
        seen.append((before, [p.detach().clone() for p in params],
                     [s.clone() for s in state["shadow"]]))

    monkeypatch.setattr(M.SequenceClassification, "loss_fn",
                        staticmethod(poisoned))
    monkeypatch.setattr(trainer_mod, "ema_update", update)
    trainer = run_port(_train_argv(tables, os.path.join(tables, "ema_nan"),
                                   "--ema_decay=0.9"))
    assert [r["nonfinite_skip"] for r in trainer.step_records] == [0, 0, 1, 0]
    assert int(trainer.ema_state["num_updates"]) == 4
    (_, p2, _), (before, p3, s3) = seen[1], seen[2]
    assert all(torch.equal(a, b) for a, b in zip(p2, p3))  # skipped
    eff = min(0.9, 4.0 / 13.0)
    for b, p, s in zip(before, p3, s3):
        torch.testing.assert_close(s, b - (1 - eff) * (b - p), atol=1e-7,
                                   rtol=0)
    assert any(not torch.equal(b, s) for b, s in zip(before, s3))


def test_ema_survives_resume(tables):
    ckpt = os.path.join(tables, "ema_resume")
    first = run_port(_train_argv(tables, ckpt, "--ema_decay=0.999"))
    shadow = [s.clone() for s in first.ema_state["shadow"]]
    assert int(first.ema_state["num_updates"]) == 4
    # resume at the end of the run: nothing left to train, the state read
    again = run_port(_train_argv(tables, ckpt, "--ema_decay=0.999",
                                 "--resume_from_checkpoint=" + ckpt))
    assert int(again.ema_state["num_updates"]) == 4
    for a, b in zip(shadow, again.ema_state["shadow"]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# --async_save
# --------------------------------------------------------------------------

def test_async_save_matches_sync_and_surfaces_errors(tables, monkeypatch):
    from easynlp_tpu_torch.core import trainer as trainer_mod
    runs = {}
    for mode in ("sync", "async"):
        ckpt = os.path.join(tables, "save_" + mode)
        extra = ["--save_checkpoint_steps=1", "--save_all_checkpoints",
                 "--ema_decay=0.9"]
        trainer = run_port(_train_argv(tables, ckpt, *extra, *(
            ["--async_save"] if mode == "async" else [])))
        assert trainer._save_thread is None  # the last write joined
        runs[mode] = ckpt
    for sub in ("", "step_2", "step_4"):
        a = os.path.join(runs["sync"], sub)
        b = os.path.join(runs["async"], sub)
        names = sorted(n for n in os.listdir(a) if n.endswith((".bin",
                                                              ".pt")))
        assert names == sorted(n for n in os.listdir(b)
                               if n.endswith((".bin", ".pt")))
        assert "pytorch_model_ema.bin" in names
        for name in names:
            x = torch.load(os.path.join(a, name), weights_only=True)
            y = torch.load(os.path.join(b, name), weights_only=True)
            flat_x, flat_y = _flat(x), _flat(y)
            assert flat_x.keys() == flat_y.keys()
            for k in flat_x:
                if torch.is_tensor(flat_x[k]):
                    assert torch.equal(flat_x[k], flat_y[k]), (name, k)
                else:
                    assert flat_x[k] == flat_y[k], (name, k)
        for name in ("meta.json", "label_mapping.json", "config.json"):
            with open(os.path.join(a, name)) as f, \
                    open(os.path.join(b, name)) as g:
                assert json.load(f) == json.load(g), name

    def boom(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(trainer_mod.Trainer, "_write_checkpoint", boom)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        run_port(_train_argv(tables, os.path.join(tables, "save_err"),
                             "--save_checkpoint_steps=1", "--async_save"))


def _flat(obj, prefix=""):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_flat(v, "%s%s/" % (prefix, k)))
        return out
    return {prefix: obj}
