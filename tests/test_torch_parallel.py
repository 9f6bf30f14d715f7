"""The port's device-parallel layer (easynlp_tpu_torch/parallel/) held to
the JAX package on the CPU: the mesh spec and groups, a Trainer step on a
dp2 x fsdp2 x tp2 mesh (and sp2) against the JAX Trainer's one-device
step, tensor-parallel BERT and GLM logits and the vocab-parallel
cross-entropy, BERT with ring attention, GPipe, the multi-process CLI,
its checkpoint and a tensor-parallel resume, and the build lock. Port ranks are `gloo` processes on the CPU
(tests/torch_parallel_workers.py), each group under its own time limit;
the JAX package runs in this process on its virtual CPU devices."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_workers import REPO, run_ranks


def _np_state(state):
    return {k: np.asarray(v, np.float32) for k, v in state.items()}


# ------------------------------------------------------------------ mesh

@pytest.mark.parametrize("spec,world", [
    (None, 4), ("dp=2,tp=2", 4), ("dp=-1,tp=2", 8), ("fsdp=2,sp=2,ep=2", 8),
    ("pp=2,dp=1", 2)])
def test_mesh_spec_matches_jax(spec, world):
    """parse_mesh_spec's aliases and "-1" axis, as the JAX package's."""
    from easynlp_tpu.utils.arguments import parse_mesh_spec as jax_parse

    from easynlp_tpu_torch.parallel.mesh import parse_mesh_spec
    assert parse_mesh_spec(spec, world) == jax_parse(spec, world)


def test_mesh_spec_refuses_what_jax_refuses():
    from easynlp_tpu.utils.arguments import parse_mesh_spec as jax_parse

    from easynlp_tpu_torch.parallel.mesh import parse_mesh_spec
    for spec, world in (("dp=1,tp=2", 1), ("dp=-1,tp=-1", 4),
                        ("dp=-1,tp=3", 4)):
        with pytest.raises(ValueError):
            jax_parse(spec, world)
        with pytest.raises(ValueError):
            parse_mesh_spec(spec, world)


def test_mesh_coordinates_and_groups():
    """Rank r sits at the row-major coordinate over AXIS_ORDER; a group
    holds the ranks that differ only along its axes; the batch rows of a
    rank are its block over the batch axes."""
    from easynlp_tpu_torch.parallel.mesh import Mesh, batch_sharding
    mesh = Mesh({"data": 2, "fsdp": 2, "tensor": 2}, rank=5)
    assert mesh.coords["data"] == 1 and mesh.coords["fsdp"] == 0 \
        and mesh.coords["tensor"] == 1
    assert mesh.ranks("tensor") == [4, 5]
    assert mesh.ranks(("data", "fsdp")) == [1, 3, 5, 7]
    assert mesh.ranks(("data", "fsdp", "expert")) == [1, 3, 5, 7]
    assert mesh.index(("data", "fsdp")) == 2
    assert batch_sharding(16, mesh) == (8, 12)
    assert mesh.group("sequence") is None


# ------------------------------------------------------------ TP logits

def _init_jax(module, **inputs):
    rng = jax.random.PRNGKey(0)
    from flax import linen as nn
    boxed = module.init({"params": rng, "dropout": rng}, **inputs,
                        deterministic=True)
    return jax.tree.map(np.asarray, nn.unbox(boxed["params"]))


def _tiny_bert(**over):
    from easynlp_tpu.testing import tiny_bert_config
    return tiny_bert_config(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0, **over)


def _bert_tp_case():
    """JAX's BERT text classification (3 labels) and its logits, with the
    port's payload."""
    from easynlp_tpu.appzoo.sequence_classification.model import (
        SequenceClassificationModule)

    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        state_dict_from_jax)
    cfg = _tiny_bert()
    module = SequenceClassificationModule(config=cfg, dtype=jnp.float32,
                                          num_labels=3)
    params = _init_jax(module, input_ids=jnp.ones((1, 8), jnp.int32))
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 900, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    mask[1, 11:] = 0
    want = module.apply({"params": params}, input_ids=jnp.asarray(ids),
                        attention_mask=jnp.asarray(mask),
                        deterministic=True)["logits"]
    return np.asarray(want), dict(
        config=_port_config(cfg.to_dict()), num_labels=3,
        state=_np_state(state_dict_from_jax(params, cfg)), input_ids=ids,
        attention_mask=mask)


def _glm_tp_case():
    """JAX's GLM (test_multichip_parity.py:148's widths) and its logits on
    block-infilling inputs, with the port's payload."""
    from easynlp_tpu.modelzoo.models.glm import GLMConfig
    from easynlp_tpu.modelzoo.models.glm.modeling_glm import (
        GLMForConditionalGeneration)

    from easynlp_tpu_torch.modelzoo.models.glm import conversion
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2,
              num_attention_heads=4, max_sequence_length=32,
              embedding_dropout_prob=0.0, attention_dropout_prob=0.0,
              output_dropout_prob=0.0)
    cfg = GLMConfig(**kw)
    module = GLMForConditionalGeneration(config=cfg, dtype=jnp.float32)
    params = _init_jax(module, input_ids=jnp.ones((1, 8), jnp.int32))
    ids = np.random.RandomState(1).randint(1, 60, (2, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    block = np.zeros((2, 16), np.int32)
    block[:, 10:] = np.arange(1, 7)
    prefix = np.array([10, 6], np.int32)
    want = module.apply({"params": params}, jnp.asarray(ids),
                        jnp.asarray(pos), jnp.asarray(block),
                        jnp.asarray(prefix), deterministic=True)["logits"]
    return np.asarray(want), dict(
        config=kw, state=_np_state(conversion.state_dict_from_jax(
            params, cfg)), input_ids=ids, position_ids=pos,
        block_position_ids=block, prefix_lengths=prefix)


def _vocab_ce_cases():
    """tests/test_fused_ce.py's vocab-parallel case at tensor=2: V = 64 and
    V = 63 (the last shard padded). JAX's vocab_parallel_cross_entropy
    under shard_map gives the loss where V divides; JAX's plain
    cross_entropy the loss and the logits' gradient (JAX's vocab-parallel
    CE has none: jax.lax.pmax has no differentiation rule, reference fault
    39)."""
    from jax.sharding import PartitionSpec as P

    from easynlp_tpu.ops.fused_ce import vocab_parallel_cross_entropy
    from easynlp_tpu.parallel import build_mesh
    from easynlp_tpu.parallel.compat import shard_map_compat
    from easynlp_tpu.utils import losses
    mesh = build_mesh({"tensor": 2}, devices=jax.devices()[:2])
    cases, wants = [], []
    for v in (64, 63):
        k = jax.random.split(jax.random.PRNGKey(v), 2)
        logits = jax.random.normal(k[0], (8, v), jnp.float32)
        labels = jax.random.randint(k[1], (8,), 0, v).at[2].set(-100)
        loss, grad = jax.value_and_grad(
            lambda lg: losses.cross_entropy(lg, labels))(logits)
        if v % 2 == 0:
            fn = shard_map_compat(
                lambda lg, lb: vocab_parallel_cross_entropy(
                    lg, lb, "tensor")[None],
                mesh=mesh, in_specs=(P(None, "tensor"), P()),
                out_specs=P())
            parallel = float(fn(logits, labels)[0])
            assert abs(parallel - float(loss)) < 1e-5
            loss = parallel
            with pytest.raises(NotImplementedError, match="pmax"):
                jax.grad(lambda lg: fn(lg, labels)[0])(logits)
        cases.append(dict(logits=np.asarray(logits),
                          labels=np.asarray(labels)))
        wants.append((float(loss), np.asarray(grad)))
    return wants, cases


@pytest.fixture(scope="module")
def tensor2(tmp_path_factory):
    """BERT, GLM, the vocab-parallel CE and GPipe on one group of two
    ranks (mesh tensor=2): (the JAX results, each rank's)."""
    cases = [("bert_forward", _bert_tp_case()), ("glm_forward",
                                                 _glm_tp_case()),
             ("vocab_ce", _vocab_ce_cases()), ("gpipe", _gpipe_case())]
    res = run_ranks("several", 2, str(tmp_path_factory.mktemp("tp")),
                    [(task, payload) for task, (_, payload) in cases],
                    mesh={"tensor": 2})
    return {task: (want, [r[i] for r in res])
            for i, (task, (want, _)) in enumerate(cases)}


def test_tensor_parallel_bert_logits_match_jax(tensor2):
    """BERT text classification at tensor=2 (Megatron layers, a
    vocab-parallel embedding: 1000 rows split 500/500) equals the JAX
    module's logits within 2e-5 (test_multichip_parity.py:127)."""
    want, ranks = tensor2["bert_forward"]
    for r in ranks:
        np.testing.assert_allclose(r["logits"].numpy(), want, atol=2e-5)


def test_vocab_parallel_cross_entropy_matches_jax(tensor2):
    """vocab_parallel_cross_entropy over tensor=2 (three all-reduces, no
    all-gather of the vocabulary): the loss within 1e-5 of JAX's and the
    logits' gradient within 1e-5 of the plain cross-entropy's, the padded
    vocabulary included (_vocab_ce_cases)."""
    wants, ranks = tensor2["vocab_ce"]
    for r in ranks:
        for got, (loss, grad) in zip(r, wants):
            assert abs(float(got["loss"]) - loss) < 1e-5
            np.testing.assert_allclose(got["grad"].numpy(), grad, atol=1e-5)


def test_tensor_parallel_glm_logits_match_jax(tensor2):
    """GLM at tensor=2: query_key_value split by head inside each of its
    q|k|v sections, the tied head's vocabulary gathered; logits within
    2e-5 of JAX's (test_multichip_parity.py:148)."""
    want, ranks = tensor2["glm_forward"]
    for r in ranks:
        np.testing.assert_allclose(r["logits"].numpy(), want, atol=2e-5)


# ------------------------------------------------------------ train step

def _jax_trainer(mesh_spec, devices=None):
    """The JAX Trainer of tests/test_multichip_parity.py:50-59."""
    from easynlp_tpu.appzoo.sequence_classification.model import (
        SequenceClassification, SequenceClassificationModule)
    from easynlp_tpu.core.trainer import Trainer
    from easynlp_tpu.parallel.mesh import build_mesh, set_global_mesh
    from easynlp_tpu.testing import (SyntheticClassificationDataset,
                                     make_args, tiny_bert_config)
    mesh = build_mesh(mesh_spec, devices=devices)
    set_global_mesh(mesh)
    config = tiny_bert_config(hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    module = SequenceClassificationModule(config=config, dtype=jnp.float32,
                                          num_labels=2)
    app = SequenceClassification(
        module, SequenceClassification.init_params(module, config), config)
    args = make_args(micro_batch_size=8, sequence_length=16,
                     dtype="float32", epoch_num=1.0, logging_steps=10**9,
                     checkpoint_dir=None, gradient_accumulation_steps=2)
    args.global_mesh = mesh
    ds = SyntheticClassificationDataset(n=32, seq_len=16,
                                        vocab_size=config.vocab_size)
    return Trainer(app, ds, evaluator=None, args=args), config


def _port_state(params, config):
    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        state_dict_from_jax)
    return _np_state(state_dict_from_jax(
        jax.tree.map(np.asarray, params), config))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX Trainer's one-device step on the first global batch: the
    port's initial state, the batch, the loss and the updated state."""
    from easynlp_tpu.parallel.mesh import get_global_mesh, set_global_mesh
    prev = get_global_mesh()
    try:
        tr, config = _jax_trainer({"data": 1}, devices=jax.devices()[:1])
        batch = next(iter(tr.train_loader))
        batch.pop("_valid", None)
        init = _port_state(tr.params, config)
        params, _, metrics = tr._train_step(
            tr.params, tr.opt_state, jax.device_put(batch, tr.batch_shard),
            0)
        return dict(config=config.to_dict(), init=init, batch=batch,
                    loss=float(metrics["loss"]),
                    grad_norm=float(metrics["grad_norm"]),
                    after=_port_state(params, config))
    finally:
        set_global_mesh(prev)


def _port_config(config):
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig
    keys = BertConfig().to_dict()
    return {k: v for k, v in config.items() if k in keys}


def _step_payload(jax_step, **extra):
    return dict(config=_port_config(jax_step["config"]),
                state=jax_step["init"], batch=jax_step["batch"], rows=32,
                args=dict(micro_batch_size=8, gradient_accumulation_steps=2,
                          epoch_num=1.0), **extra)


@pytest.mark.parametrize("mesh", ["dp2-fsdp2-tp2", "sp2"])
def test_train_step_on_a_mesh_matches_one_device(jax_step, tmp_path, mesh,
                                                 request):
    """The Trainer's step on dp2 x fsdp2 x tp2 (FSDP2 over fsdp with data,
    Megatron layers over tensor) and on sp2 (ring attention; its group is
    shared with BERT's ring forward, `sequence2`) equals the JAX Trainer's
    one-device step: loss within 1e-5, parameters within 2e-5
    (test_multichip_parity.py:62-92)."""
    if mesh == "sp2":
        res = request.getfixturevalue("sequence2")["bert_step"][1]
    else:
        res = run_ranks("bert_step", 8, str(tmp_path), _step_payload(
            jax_step), mesh={"data": 2, "fsdp": 2, "tensor": 2},
            timeout=120)
    for r in res:
        m = r["metrics"][0]
        assert abs(m["loss"] - jax_step["loss"]) < 1e-5, (m, jax_step)
        assert abs(m["grad_norm"] - jax_step["grad_norm"]) < 1e-4
        assert m["nonfinite_skip"] == 0
        for k, want in jax_step["after"].items():
            np.testing.assert_allclose(r["params"][k].numpy(), want,
                                       atol=2e-5, err_msg=k)


def _bert_ring_case():
    """JAX's BERT classification with use_ring_attention on sequence=8
    (test_ring_attention.py:50) and its logits, with the port's
    payload."""
    from easynlp_tpu.appzoo.sequence_classification.model import (
        SequenceClassificationModule)
    from easynlp_tpu.parallel.mesh import (build_mesh, get_global_mesh,
                                           set_global_mesh)

    from easynlp_tpu_torch.appzoo.sequence_classification.model import (
        state_dict_from_jax)
    ids = np.random.RandomState(0).randint(5, 900, (2, 64)).astype(np.int32)
    mask = np.array([[1] * 64, [1] * 40 + [0] * 24], np.int32)
    cfg = _tiny_bert(use_ring_attention=True)
    module = SequenceClassificationModule(config=cfg, dtype=jnp.float32,
                                          num_labels=2)
    prev = get_global_mesh()
    try:
        set_global_mesh(build_mesh({"sequence": 8}))
        params = _init_jax(module, input_ids=jnp.asarray(ids),
                           attention_mask=jnp.asarray(mask))
        want = module.apply({"params": params}, input_ids=jnp.asarray(ids),
                            attention_mask=jnp.asarray(mask),
                            deterministic=True)
    finally:
        set_global_mesh(prev)
    return np.asarray(want["logits"]), dict(
        config=_port_config(cfg.to_dict()),
        state=_np_state(state_dict_from_jax(params, cfg)), input_ids=ids,
        attention_mask=mask)


def _gpt2_ring_case():
    """JAX's GPT-2 (no ring, one device) and its logits on left-padded
    rows, with the port's payload: GPT-2 with use_ring_attention (JAX
    modeling_gpt2.py:76)."""
    from easynlp_tpu.modelzoo.models.gpt2 import GPT2Config, GPT2LMHeadModel

    from easynlp_tpu_torch.modelzoo.models.gpt2.conversion import (
        state_dict_from_jax)
    kw = dict(vocab_size=64, n_positions=32, n_embd=16, n_layer=2,
              n_head=2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    cfg = GPT2Config(**kw)
    m = GPT2LMHeadModel.from_config(cfg, dtype=jnp.float32)
    params = _init_jax(m, input_ids=jnp.ones((1, 4), jnp.int32))
    ids = np.random.RandomState(2).randint(0, 64, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, :5] = 0
    want = m.apply({"params": params}, input_ids=jnp.asarray(ids),
                   attention_mask=jnp.asarray(mask),
                   deterministic=True)["logits"]
    state = {"transformer." + k: v.numpy() for k, v in
             state_dict_from_jax(params, cfg).items()}
    return np.asarray(want), dict(
        config=dict(kw, use_ring_attention=True), state=state,
        input_ids=ids, attention_mask=mask)


@pytest.fixture(scope="module")
def sequence2(jax_step, tmp_path_factory):
    """The Trainer's step, BERT's and GPT-2's ring forwards on one
    sequence=2 group: {task: (the JAX logits, each rank's result)}."""
    jobs = {"bert_forward": _bert_ring_case(),
            "gpt2_forward": _gpt2_ring_case()}
    res = run_ranks("several", 2, str(tmp_path_factory.mktemp("sp")),
                    [("bert_step", _step_payload(jax_step))]
                    + [(task, payload) for task, (_, payload) in
                       jobs.items()], mesh={"sequence": 2})
    out = {"bert_step": (None, [r[0] for r in res])}
    for i, (task, (want, _)) in enumerate(jobs.items()):
        out[task] = (want, [r[i + 1] for r in res])
    return out


def test_bert_ring_attention_matches_jax(sequence2):
    """BERT with use_ring_attention on sequence=2: each rank embeds and
    encodes its 32 of 64 tokens (positions offset), the layers attend over
    the ring, the outputs are gathered; equal to JAX's BERT with
    use_ring_attention on sequence=8 (test_ring_attention.py:50) within
    2e-4 as there."""
    want, ranks = sequence2["bert_forward"]
    for r in ranks:
        np.testing.assert_allclose(r["logits"].numpy(), want, atol=2e-4)


def test_gpt2_ring_attention_matches_jax(sequence2):
    """GPT-2 with use_ring_attention on sequence=2 (causal ring hops, the
    positions of left-padded rows taken from the whole mask): logits within
    2e-5 of JAX's GPT-2 on one device."""
    want, ranks = sequence2["gpt2_forward"]
    for r in ranks:
        np.testing.assert_allclose(r["logits"].numpy(), want, atol=2e-5)


# ------------------------------------------------------------------ GPipe

def _gpipe_case():
    """JAX's gpipe over pipeline=2, one layer a stage, 4 micro-batches:
    the outputs and the gradients of mean(y ** 2) (the stacked parameters'
    and the input's), with the port's payload. The port's ranks run it
    over the two ranks of their tensor group (gpipe takes any group)."""
    from easynlp_tpu.parallel.mesh import (build_mesh, get_global_mesh,
                                           set_global_mesh)
    from easynlp_tpu.parallel.pipeline import gpipe, place_stage_stacked
    rng = np.random.RandomState(0)
    stacked = {"w1": rng.randn(2, 8, 16) * 0.3, "b1": rng.randn(2, 16) * 0.1,
               "w2": rng.randn(2, 16, 8) * 0.3, "b2": rng.randn(2, 8) * 0.1}
    stacked = {k: v.astype(np.float32) for k, v in stacked.items()}
    x = rng.randn(8, 8).astype(np.float32)

    def stage(p, h):
        for i in range(p["w1"].shape[0]):
            h = jnp.tanh(h @ p["w1"][i] + p["b1"][i]) @ p["w2"][i] \
                + p["b2"][i]
        return h

    prev = get_global_mesh()
    try:
        mesh = build_mesh({"pipeline": 2}, devices=jax.devices()[:2])
        set_global_mesh(mesh)
        placed = place_stage_stacked(
            jax.tree.map(jnp.asarray, stacked), mesh)

        def loss(p, x):
            y = gpipe(stage, p, x, mesh, num_microbatches=4)
            return jnp.mean(y ** 2), y

        (_, y), (g, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                             has_aux=True)(
            placed, jnp.asarray(x))
        y, g, gx = jax.device_get((y, g, gx))
    finally:
        set_global_mesh(prev)
    return (np.asarray(y), np.asarray(gx), {k: np.asarray(v) for k, v in
                                            g.items()}), dict(
        params=stacked, x=x, microbatches=4, axis="tensor")


def test_gpipe_matches_jax(tensor2):
    """gpipe's fill and drain over two stages: outputs, the stages'
    gradients and the input's within 1e-5 of JAX's gpipe
    (test_pipeline_parallel.py)."""
    (y, gx, g), res = tensor2["gpipe"]
    for r in res:
        np.testing.assert_allclose(r["y"].numpy(), y, atol=1e-5)
        np.testing.assert_allclose(r["dx"].numpy(), gx, atol=1e-5)
    for k in g:
        got = np.concatenate([r["grads"][k].numpy() for r in res])
        np.testing.assert_allclose(got, g[k], atol=1e-5, err_msg=k)


# ------------------------------------------------------------------- CLI

_NO_JAX = (
    "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', "
    "'sklearn', 'easynlp_tpu') or m.startswith('easynlp_tpu.')]\n"
    "assert not bad, bad\n")


def _cli(argv, tag):
    return ("import sys\n"
            "from easynlp_tpu_torch.cli import main\n"
            "assert main(%r) == 0\n%s"
            "print(%r)\n" % (argv, _NO_JAX, tag))


def _ranks(argv, base, tag, timeout=150):
    """Two CLI ranks of argv (a file:// rendezvous under base)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    argv = argv + ["--num_processes=2", "--coordinator_address=file://"
                   + os.path.join(base, "rdzv_" + tag)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _cli(argv + ["--process_index=%d" % r],
                                    "RANK_OK")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert "RANK_OK" in out


def test_cli_dp2_checkpoint_evaluates_in_one_process(tmp_path):
    """Two CLI processes train text_classify on --mesh dp=2 (gloo, a
    file:// rendezvous), each on its half of the rows; the master writes
    the checkpoint under the usual names; one process evaluates it and
    predicts from it. Then two processes resume from it on --mesh tp=2:
    the full weights go in before the split and the saved optimizer state
    is split as its parameters (the vocabulary, the heads and the MLP);
    the resumed run trains the second epoch. No process loads JAX or the
    JAX package."""
    sys.path.insert(0, os.path.join(REPO, "tests", "fixtures"))
    from make_fixtures import make_pretrained, make_tsv
    from test_torch_text_classify import write_weights
    base = str(tmp_path)
    model_dir = make_pretrained(os.path.join(base, "model"))
    write_weights(model_dir)
    make_tsv(os.path.join(base, "train.tsv"), 64, seed=1)
    make_tsv(os.path.join(base, "dev.tsv"), 24, seed=2)
    ckpt = os.path.join(base, "ckpt")
    common = ["--app_name=text_classify",
              "--input_schema=id:str:1,sent:str:1,label:str:1",
              "--first_sequence=sent", "--label_name=label",
              "--sequence_length=16", "--dtype=float32", "--device=cpu"]
    train = ["--mode=train", "--tables=%s/train.tsv,%s/dev.tsv"
             % (base, base), "--micro_batch_size=16",
             "--learning_rate=3e-4", "--logging_steps=1",
             "--pretrained_model_name_or_path=" + model_dir, *common]
    _ranks(train + ["--checkpoint_dir=" + ckpt, "--epoch_num=1",
                    "--mesh=dp=2"], base, "dp")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    state = torch.load(os.path.join(ckpt, "pytorch_model.bin"),
                       weights_only=True)
    init = torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                      weights_only=True)
    assert set(state) >= {k for k in init if k.startswith("bert.")}
    for k, v in init.items():
        if k in state:
            assert state[k].shape == v.shape, k
    with open(os.path.join(ckpt, "meta.json")) as f:
        # 64 rows in global batches of 16, 8 rows a rank: 4 steps
        assert json.load(f)["global_step"] == 4
    evaluate = ["--mode=evaluate", "--tables=%s/dev.tsv" % base,
                "--checkpoint_dir=" + ckpt, "--micro_batch_size=8", *common]
    predict = ["--mode=predict", "--tables=%s/dev.tsv" % base,
               "--outputs=%s/pred.tsv" % base, "--checkpoint_dir=" + ckpt,
               "--output_schema=predictions", "--micro_batch_size=8",
               *common]
    code = _cli(evaluate, "EVAL_OK").replace(
        "assert main(", "assert main(%r) == 0\nassert main(" % predict, 1)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "EVAL_OK" in proc.stdout
    with open(os.path.join(base, "pred.tsv")) as f:
        assert len(f.read().splitlines()) == 24
    resumed = os.path.join(base, "resumed")
    _ranks(train + ["--checkpoint_dir=" + resumed, "--epoch_num=2",
                    "--resume_from_checkpoint=" + ckpt, "--mesh=tp=2"],
           base, "tp")
    with open(os.path.join(resumed, "meta.json")) as f:
        # epoch 1's 4 steps, then epoch 2's 4 of 16 rows
        assert json.load(f)["global_step"] == 8
    opt = torch.load(os.path.join(resumed, "optimizer.pt"),
                     weights_only=True)
    assert opt["count"] == 8
    word = "bert.embeddings.word_embeddings.weight"
    got = torch.load(os.path.join(resumed, "pytorch_model.bin"),
                     weights_only=True)
    assert got[word].shape == state[word].shape
    # the state of split parameters is saved whole, under their names
    assert opt["mu"]["backbone.embeddings.word_embeddings.weight"].shape \
        == state[word].shape
    assert not torch.equal(got[word], state[word])


def test_ema_shadow_survives_a_resume_on_a_mesh(tmp_path):
    """A Trainer with --ema_decay takes two steps on data=2 and saves
    (pytorch_model_ema.bin among the files); a Trainer resumed from that
    checkpoint on tensor=2 holds the saved EMA shadow, split as its
    parameters, bit for bit, and not the trained weights."""
    rng = np.random.RandomState(5)
    config = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=64,
                  max_position_embeddings=32, hidden_dropout_prob=0.0,
                  attention_probs_dropout_prob=0.0)
    batch = {"input_ids": rng.randint(1, 96, (8, 16)),
             "attention_mask": np.ones((8, 16), np.int64),
             "token_type_ids": np.zeros((8, 16), np.int64),
             "label_ids": rng.randint(0, 2, (8,))}
    ckpt = str(tmp_path / "ckpt")
    res = run_ranks("bert_ema_resume", 2, str(tmp_path / "ranks"), dict(
        config=config, batch=batch, micro=8, rows=32, ckpt=ckpt),
        mesh={"data": 2})
    assert os.path.exists(os.path.join(ckpt, "pytorch_model_ema.bin"))
    for r in res:
        assert set(r["resumed"]) == set(r["saved"])
        for name, want in r["saved"].items():
            assert torch.equal(r["resumed"][name], want), name
        assert any(not torch.equal(r["resumed"][n], r["params"][n])
                   for n in r["params"])


# ------------------------------------------------------------- build lock

_BUILD = """
import sys
from easynlp_tpu_torch.data.native_lib import GXX_FLAGS, NATIVE_DIR, _gxx
from easynlp_tpu_torch.kernels import compile_library
src = NATIVE_DIR / "tsv_reader.cpp"
path, info = compile_library(src, sys.argv[1], _gxx, GXX_FLAGS, [src])
print("BUILT", int(info["cached"]), path)
"""


def test_concurrent_first_builds_compile_once(tmp_path):
    """Two processes build native/tsv_reader.cpp with g++ into one empty
    directory at once: the build lock lets one compile while the other
    waits and then finds the library built."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    out = str(tmp_path / "native")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, out], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    lines = []
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, e[-2000:]
        lines += [line.split() for line in o.splitlines()
                  if line.startswith("BUILT")]
    assert sorted(int(c) for _, c, _ in lines) == [0, 1]
    assert lines[0][2] == lines[1][2]
    assert [f for f in os.listdir(out) if f.endswith(".tmp")] == []
