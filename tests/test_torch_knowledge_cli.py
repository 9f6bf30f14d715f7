"""The language_modeling knowledge variants through both CLIs, on the CPU:
`--mode=train` (4 AdamW steps) then `--mode=evaluate` with
user_defined_parameters enable_dkplm, contrast_learning_flag (CKBERT) and
enable_kangaroo, at tiny widths (2-3 layers, hidden 32, dropout 0), each
from one model directory holding the JAX app's own init (moved by seeded
noise) as flax_params.msgpack, which the port reads through the app's
state_dict_from_jax. The JAX CLI trains in this process (its Trainer
evaluates the final weights on the dev table); the port's CLI trains and
evaluates in a fresh interpreter, the three variants' at once: per-step
losses and grad norms within rtol 1e-5 (test_torch_language_modeling.py's
bounds), the same accuracy and perplexity (rel 1e-5), and no jax, flax
or easynlp_tpu module loaded by the port's run. Also ROADMAP reference
fault 21: the JAX CKBERT app's loss ignores the config's
contrastive_temperature and contrastive_weight.
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

from test_torch_knowledge_data import (
    KANGAROO_CONFIG,
    KG_DIM,
    dkplm_udp,
    kangaroo_udp,
    make_knowledge_dir,
    write_dkplm_rows,
    write_dkplm_tables,
    write_kangaroo_rows,
    write_kangaroo_tables,
)
from test_torch_text_match import (
    REPO,
    _restore_global_args,  # noqa: F401
    run_jax,
)

SCHEMA = "id:str:1,text:str:1"


def _jax_app(variant):
    from easynlp_tpu.appzoo.language_modeling import model
    return {"dkplm": model.DKPLMLanguageModeling,
            "ckbert": model.CKBertLanguageModeling,
            "kangaroo": model.KangarooLanguageModeling}[variant]


def make_variant_dir(base, variant):
    """(model dir, udp, train and dev tables) of a variant: the model
    directory holds the JAX app's init moved by 0.05 N(0, 1) noise."""
    from easynlp_tpu.modelzoo.modeling_utils import save_params
    model_dir = os.path.join(base, "model")
    extra = {"dkplm": dict(knowledge_emb_size=KG_DIM), "ckbert": {},
             "kangaroo": KANGAROO_CONFIG}[variant]
    make_knowledge_dir(
        model_dir, "kangaroo" if variant == "kangaroo" else "bert", **extra)
    app = _jax_app(variant)
    jcfg = app.load_config(model_dir)
    module = app.build_module(jcfg, dtype=jnp.float32)
    # jitted: flax's init op by op costs seconds at these widths
    params = jax.jit(lambda: app.init_params(module, module.config, 0))()
    rng = np.random.RandomState(0)
    save_params(jax.tree.map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params), model_dir)
    if variant == "dkplm":
        udp = dkplm_udp(tuple(write_dkplm_tables(base)))
        for name, n, seed in (("train", 32, 1), ("dev", 10, 2)):
            write_dkplm_rows(os.path.join(base, name + ".tsv"), n, seed)
    elif variant == "kangaroo":
        paths, names = write_kangaroo_tables(base)
        udp = kangaroo_udp(paths)
        for name, n, seed in (("train", 32, 1), ("dev", 10, 2)):
            write_kangaroo_rows(os.path.join(base, name + ".tsv"), n, names,
                                seed)
    else:
        udp = "contrast_learning_flag=true"
        from test_torch_language_modeling import make_rows
        for name, n, seed in (("train", 32, 1), ("dev", 10, 2)):
            make_rows(os.path.join(base, name + ".tsv"), n, seed)
    return model_dir, udp


def argv(base, udp, mode, ckpt):
    common = ["--app_name=language_modeling", "--input_schema=" + SCHEMA,
              "--first_sequence=text", "--sequence_length=24",
              "--micro_batch_size=8", "--dtype=float32",
              "--user_defined_parameters=" + udp]
    if mode == "train":
        return ["--mode=train", "--tables=%s/train.tsv,%s/dev.tsv"
                % (base, base),
                "--pretrained_model_name_or_path=%s/model" % base,
                "--checkpoint_dir=" + ckpt, "--epoch_num=1",
                "--learning_rate=1e-3", "--logging_steps=1"] + common
    return ["--mode=evaluate", "--tables=%s/dev.tsv" % base,
            "--checkpoint_dir=" + ckpt] + common


PORT_RUN = """
import json, sys
from easynlp_tpu_torch.appzoo.api import default_main_fn
from easynlp_tpu_torch.utils.initializer import initialize_easynlp
trainer = default_main_fn(initialize_easynlp(args_list=%r))
results = default_main_fn(initialize_easynlp(args_list=%r))
bad = [m for m in sys.modules if m in ("jax", "flax", "easynlp_tpu")
       or m.startswith("easynlp_tpu.")]
print("RESULT " + json.dumps({"steps": trainer.global_step,
                              "eval": results, "bad": bad}))
"""
VARIANTS = ("dkplm", "ckbert", "kangaroo")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{variant: (the port's result, udp, the JAX and port checkpoint
    dirs)}: each variant's port CLI train + evaluate in a fresh
    interpreter (the three started at once) and its JAX CLI train in this
    process (its Trainer evaluates the final weights)."""
    started = {}
    for variant in VARIANTS:
        base = str(tmp_path_factory.mktemp("torch_knowledge_" + variant))
        _, udp = make_variant_dir(base, variant)
        jax_ckpt, port_ckpt = (os.path.join(base, "ckpt_" + t)
                               for t in ("jax", "port"))
        code = PORT_RUN % (argv(base, udp, "train", port_ckpt)
                           + ["--device=cpu"],
                           argv(base, udp, "evaluate", port_ckpt)
                           + ["--device=cpu"])
        started[variant] = (subprocess.Popen(
            [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=REPO)), base, udp, jax_ckpt,
            port_ckpt)
    out = {}
    for variant, (proc, base, udp, jax_ckpt, port_ckpt) in started.items():
        run_jax(argv(base, udp, "train", jax_ckpt))
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        line = [ln for ln in stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        out[variant] = (json.loads(line[len("RESULT "):]), udp, jax_ckpt,
                        port_ckpt)
    return out


def _events(path, kind):
    with open(os.path.join(path, "events.jsonl")) as f:
        return [e for e in map(json.loads, f) if e["kind"] == kind]


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_trains_and_evaluates_like_jax(runs, variant):
    """4 steps: per-step loss, grad norm and lr within rtol 1e-5, then
    the port's --mode=evaluate on its checkpoint gives the accuracy and
    perplexity of the JAX Trainer's evaluation of its final weights, and
    of the port Trainer's; the port's run loaded no JAX module; and the
    port's --mode=evaluate on the JAX CLI's checkpoint (its
    flax_params.msgpack) gives the JAX Trainer's evaluation of it."""
    port, udp, jax_ckpt, port_ckpt = runs[variant]
    assert port["bad"] == []
    assert port["steps"] == 4
    train_j, train_p = _events(jax_ckpt, "train"), _events(port_ckpt,
                                                           "train")
    assert len(train_j) == len(train_p) == 4
    for ej, ep in zip(train_j, train_p):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(ep[key], ej[key], rtol=1e-5,
                                       atol=1e-6, err_msg=(variant, key))
    assert len({round(e["loss"], 6) for e in train_p}) > 1
    assert [m for m, _ in port["eval"]] == ["accuracy", "perplexity"]
    for events in (_events(jax_ckpt, "eval"), _events(port_ckpt, "eval")):
        for metric, score in port["eval"]:
            assert score == pytest.approx(events[-1][metric], rel=1e-5), \
                (variant, metric)
    with open(os.path.join(port_ckpt, "config.json")) as f:
        assert json.load(f)["model_type"] == variant
    # the port evaluates the checkpoint the JAX CLI trained
    # (flax_params.msgpack) as the JAX Trainer evaluated it
    from test_torch_text_match import run_port
    assert not os.path.exists(os.path.join(jax_ckpt, "pytorch_model.bin"))
    got = run_port(argv(os.path.dirname(jax_ckpt), udp, "evaluate",
                        jax_ckpt))
    for metric, score in got:
        assert score == pytest.approx(
            _events(jax_ckpt, "eval")[-1][metric], rel=1e-5), (variant,
                                                               metric)


def test_ckbert_settings_reference_fault_21():
    """ROADMAP reference fault 21: JAX's CKBertLanguageModeling.loss_fn
    calls ckbert_pretrain_loss with its defaults (temperature 0.05, weight
    0.1), whatever the config's contrastive_temperature and
    contrastive_weight say; the port's reads the config. At the defaults
    the two agree (1e-6)."""
    from easynlp_tpu.appzoo.language_modeling.model import (
        CKBertLanguageModeling as JaxApp)
    from easynlp_tpu.modelzoo.models.ckbert import ckbert_pretrain_loss

    from easynlp_tpu_torch.appzoo.language_modeling.model import (
        CKBertLanguageModeling)
    from easynlp_tpu_torch.modelzoo.models.ckbert import CKBertConfig
    rng = np.random.RandomState(5)
    outputs = {"logits": rng.standard_normal((4, 6, 20)).astype(np.float32),
               "cls_view1": rng.standard_normal((4, 16)).astype(np.float32),
               "cls_view2": rng.standard_normal((4, 16)).astype(np.float32)}
    batch = {"label_ids": np.where(rng.rand(4, 6) < 0.4,
                                   rng.randint(0, 20, (4, 6)), -100)
             .astype(np.int32)}
    jo = {k: jnp.asarray(v) for k, v in outputs.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    to = {k: torch.from_numpy(v) for k, v in outputs.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    jax_loss = float(JaxApp.loss_fn(jo, jb)["loss"])
    default = CKBertLanguageModeling(None, CKBertConfig(), "cpu")
    assert float(default.loss_fn(to, tb)["loss"]) == pytest.approx(
        jax_loss, abs=1e-6)
    tuned = CKBertLanguageModeling(None, CKBertConfig(
        contrastive_temperature=0.5, contrastive_weight=0.3), "cpu")
    want = float(ckbert_pretrain_loss(jo, jb, temperature=0.5,
                                      weight=0.3)["loss"])
    got = float(tuned.loss_fn(to, tb)["loss"])
    assert got == pytest.approx(want, abs=1e-6)
    assert abs(got - jax_loss) > 1e-2  # JAX ignored the config


def test_width_mismatch_is_refused_before_training(tmp_path):
    """Through the port's CLI: a Kangaroo config whose concept_size
    disagrees with the data's (user_defined_parameters concept_size) is
    refused with a ValueError naming both, before any step."""
    from test_torch_text_match import run_port
    base = str(tmp_path)
    make_knowledge_dir(os.path.join(base, "model"), "kangaroo",
                       **KANGAROO_CONFIG)
    paths, names = write_kangaroo_tables(base)
    write_kangaroo_rows(os.path.join(base, "train.tsv"), 8, names, 1)
    write_kangaroo_rows(os.path.join(base, "dev.tsv"), 4, names, 2)
    udp = kangaroo_udp(paths).replace("concept_size=5", "concept_size=7")
    with pytest.raises(ValueError, match="concept_size=5.*concept_size=7"):
        run_port(argv(base, udp, "train", os.path.join(base, "ckpt")))
    assert not os.path.exists(os.path.join(base, "ckpt", "events.jsonl"))
