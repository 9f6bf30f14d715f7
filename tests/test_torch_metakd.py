"""MetaKD (user_defined_parameters enable_metakd; MetaDistillationTrainer)
in the PyTorch port against the JAX package, in f32 on the CPU, at tiny
widths: a teacher of 2 layers of width 32 and a student of 1 layer of
width 16 with the teacher's 4 heads (attention transfer compares the score
maps head by head), dropout off.

- The dataset: the same features as the JAX dataset, domain_ids and
  sample_weights included, with and without the genre filter (a header
  row skipped before the filter).
- BERT's output_attentions: the masked pre-softmax scores [L, B, H, S, S]
  (-1e4 on masked keys, not HF's probabilities) within 1e-5 of JAX's
  (tests/test_metakd.py's test_bert_output_attentions_scores), the
  hidden states unchanged by the explicit path (2e-5).
- The modules from one JAX init carried over by state_dict_from_jax: every
  output within 1e-5; meta_teacher_loss and its gradients within 1e-5
  (test_torch_text_match.check_parity); the stage-1 and stage-2 losses on
  the two modules' outputs within 1e-5.
- 4 steps through both CLIs (enable_metakd, MetaTeacherTrainer) from a JAX
  flax_params.msgpack: the losses within 1e-6 and the trained weights
  within 1e-5 (test_torch_train.py's bounds); evaluate and predict on the
  port's checkpoint.
- MetaDistillationTrainer at stage 1 and stage 2 trains the student and
  leaves the teacher as it was.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_text_match import (
    ATOL,
    _restore_global_args,  # noqa: F401
    assert_trained_like_jax,
    check_parity,
    jax_params,
    make_flax_dir,
    port_module,
    read_tsv,
    run_jax,
    run_port,
)

SCHEMA = "id:str:1,sent:str:1,label:str:1,domain:str:1,weight:str:1"
DOMAINS = ["books", "dvd", "electronics", "kitchen"]
STUDENT = dict(num_hidden_layers=1, hidden_size=16, intermediate_size=32,
               num_attention_heads=4)


def write_rows(path, n, seed, header=False):
    from make_fixtures import FILLER, NEG_WORDS, POS_WORDS
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        if header:
            f.write("id\tsent\tlabel\tdomain\tweight\n")
        for i in range(n):
            label = ("neg", "pos")[rng.randint(2)]
            words = list(rng.choice(FILLER, 4)) + [
                rng.choice(POS_WORDS if label == "pos" else NEG_WORDS)]
            f.write("%d\t%s\t%s\t%s\t%.2f\n" % (
                i, " ".join(words), label, DOMAINS[rng.randint(4)],
                0.5 + 0.1 * rng.randint(5)))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    from easynlp_tpu.distillation.distill_metakd_application import (
        MetaTeacherClassification)
    base = str(tmp_path_factory.mktemp("torch_metakd"))
    make_flax_dir(os.path.join(base, "model"), MetaTeacherClassification,
                  num_labels=2, num_domains=4)
    write_rows(os.path.join(base, "train.tsv"), 32, seed=1)
    write_rows(os.path.join(base, "dev.tsv"), 12, seed=2)
    write_rows(os.path.join(base, "header.tsv"), 16, seed=3, header=True)
    return base


def _config(fixture_dir, **over):
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        return dict(json.load(f), **over)


@pytest.mark.parametrize("table,udp,skip", [
    ("train.tsv", {}, False),
    ("header.tsv", {"genre": "books"}, True),
    ("header.tsv", {"genre": "dvd", "domain_label": "dvd,books"}, True),
])
def test_dataset_matches_jax(fixture_dir, table, udp, skip):
    from easynlp_tpu.distillation.distill_metakd_dataset import (
        MetaKDClassificationDataset as JaxDataset)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.distillation.distill_metakd_dataset import (
        MetaKDClassificationDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    path = os.path.join(fixture_dir, table)
    kw = dict(max_seq_length=16, input_schema=SCHEMA, first_sequence="sent",
              label_name="label", user_defined_parameters=udp,
              skip_first_line=skip)
    want = JaxDataset(path, JaxTok.from_pretrained(model), **kw)
    got = MetaKDClassificationDataset(path, BertTokenizer.from_pretrained(
        model), **kw)
    assert sorted(got.features) == sorted(want.features)
    assert "domain_ids" in got.features and "sample_weights" in got.features
    for k in want.features:
        np.testing.assert_array_equal(got.features[k], want.features[k],
                                      err_msg=k)
    if "genre" in udp:
        with open(path) as f:
            rows = [line.split("\t") for line in f][1:]
        assert len(got) == sum(r[3] == udp["genre"] for r in rows) > 0
        index = (udp.get("domain_label") or ",".join(DOMAINS)).split(",")
        assert set(got.features["domain_ids"]) == {index.index(udp["genre"])}


def _inputs(seed, vocab, n=4, width=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, vocab, (n, width)).astype(np.int32)
    lengths = np.array([width, 7, 3, 10][:n])
    mask = (np.arange(width)[None] < lengths[:, None]).astype(np.int32)
    inputs = {"input_ids": ids, "attention_mask": mask,
              "token_type_ids": np.zeros_like(ids),
              "domain_ids": rng.randint(0, 4, n).astype(np.int32)}
    batch = {"label_ids": rng.randint(0, 2, n).astype(np.int32),
             "domain_ids": inputs["domain_ids"],
             "sample_weights": (0.5 + rng.rand(n)).astype(np.float32)}
    return inputs, batch


def test_output_attentions_match_jax(fixture_dir):
    from easynlp_tpu.modelzoo.models.bert import BertConfig as JaxConfig
    from easynlp_tpu.modelzoo.models.bert import BertModel as JaxBert
    from easynlp_tpu_torch.modelzoo.models.bert import BertConfig, BertModel
    from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
        state_dict_from_jax)
    from flax import linen as nn
    config = _config(fixture_dir)
    inputs, _ = _inputs(0, config["vocab_size"])
    jin = {k: jnp.asarray(inputs[k]) for k in ("input_ids", "attention_mask")}
    jmodel = JaxBert(config=JaxConfig(**config), dtype=jnp.float32,
                     output_attentions=True, output_hidden_states=True)
    params = nn.unbox(jmodel.init({"params": jax.random.PRNGKey(0)}, **jin,
                                  deterministic=True)["params"])
    want = jmodel.apply({"params": params}, **jin, deterministic=True)
    model = BertModel(BertConfig(**config), output_attentions=True,
                      output_hidden_states=True)
    model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, params), BertConfig(**config)))
    model.eval()
    plain = BertModel(BertConfig(**config)).eval()
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model(*(torch.from_numpy(inputs[k])
                      for k in ("input_ids", "attention_mask")))
        kernel_path = plain(*(torch.from_numpy(inputs[k])
                              for k in ("input_ids", "attention_mask")))
    att = got["attentions"].numpy()
    assert att.shape == (config["num_hidden_layers"], 4,
                         config["num_attention_heads"], 12, 12)
    np.testing.assert_allclose(att, np.asarray(want["attentions"]),
                               atol=1e-5, rtol=0)
    assert np.all(att[:, 2, :, :, 3:] <= -1e2)  # masked lanes
    np.testing.assert_allclose(got["hidden_states"].numpy(),
                               np.asarray(want["hidden_states"]), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(),
                               kernel_path["last_hidden_state"].numpy(),
                               atol=2e-5, rtol=0)


def _pair(fixture_dir):
    """(JAX teacher/student modules and params, the port's modules)."""
    from easynlp_tpu.distillation import distill_metakd_application as J
    from easynlp_tpu_torch.distillation import (
        distill_metakd_application as P)
    t_config = _config(fixture_dir)
    s_config = _config(fixture_dir, **STUDENT)
    t_cfg, t_module, t_params = jax_params(
        J.MetaTeacherClassification, t_config, seed=1, num_labels=2,
        num_domains=4)
    s_cfg, s_module, s_params = jax_params(
        J.MetaStudentClassification, s_config, seed=2, num_labels=2,
        num_domains=4, fit_size=t_config["hidden_size"])
    teacher = port_module(P.MetaTeacherClassification,
                          P.MetaTeacherClassification.state_dict_from_jax(
                              t_params, t_cfg), t_config, num_labels=2,
                          num_domains=4)
    student = port_module(P.MetaStudentClassification,
                          P.MetaStudentClassification.state_dict_from_jax(
                              s_params, s_cfg), s_config, num_labels=2,
                          num_domains=4, fit_size=t_config["hidden_size"])
    return (t_module, t_params, s_module, s_params), (teacher.eval(),
                                                      student.eval())


def test_teacher_outputs_loss_and_grads_match_jax(fixture_dir):
    from easynlp_tpu.distillation import distill_metakd_application as J
    from easynlp_tpu_torch.distillation import (
        distill_metakd_application as P)
    (t_module, t_params, _, _), (teacher, _) = _pair(fixture_dir)
    config = _config(fixture_dir)
    inputs, batch = _inputs(3, config["vocab_size"])
    want = check_parity(J.MetaTeacherClassification,
                        P.MetaTeacherClassification, t_module, t_params,
                        teacher, inputs, batch,
                        P.MetaTeacherClassification.state_dict_from_jax,
                        teacher.config)
    assert {"attentions", "domain_logits", "domain_content_output"} <= \
        set(want)
    for flags in ((False, True), (True, False)):
        kw = dict(zip(("use_domain_loss", "use_sample_weights"), flags))
        out = t_module.apply({"params": t_params},
                             **{k: jnp.asarray(v) for k, v in inputs.items()},
                             deterministic=True)
        with torch.no_grad():
            got = teacher(**{k: torch.from_numpy(v)
                             for k, v in inputs.items()})
        jl = J.meta_teacher_loss(out, {k: jnp.asarray(v)
                                       for k, v in batch.items()}, **kw)
        pl = P.meta_teacher_loss(got, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, **kw)
        assert set(jl) == set(pl)
        for k in jl:
            assert abs(float(jl[k]) - float(pl[k])) <= ATOL, (flags, k)


def test_student_outputs_and_stage_losses_match_jax(fixture_dir):
    from easynlp_tpu.distillation import distill_metakd_application as J
    from easynlp_tpu_torch.distillation import (
        distill_metakd_application as P)
    (t_module, t_params, s_module, s_params), (teacher, student) = \
        _pair(fixture_dir)
    config = _config(fixture_dir)
    inputs, batch = _inputs(4, config["vocab_size"])
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    jt = t_module.apply({"params": t_params}, **jin, deterministic=True)
    js = s_module.apply({"params": s_params}, **jin, deterministic=True)
    with torch.no_grad():
        pt, ps = teacher(**tin), student(**tin)
    for key, want in js.items():
        np.testing.assert_allclose(ps[key].numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=key)
    assert ps["sequence_output"].shape[-1] == config["hidden_size"]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pairs = [(J.meta_student_stage1_loss(js, jt, jbatch, 0.5),
              P.meta_student_stage1_loss(ps, pt, tbatch, 0.5)),
             (J.meta_student_stage2_loss(js, jt, 2.0),
              P.meta_student_stage2_loss(ps, pt, 2.0))]
    for want, got in pairs:
        assert set(want) == set(got)
        for k in want:
            assert abs(float(want[k]) - float(got[k])) <= ATOL, k
    assert float(pairs[0][1]["att_loss"]) > 0


def _cli_argv(base, ckpt):
    return ["--mode=train", "--app_name=text_classify",
            "--tables=%s/train.tsv,%s/dev.tsv" % (base, base),
            "--input_schema=" + SCHEMA, "--first_sequence=sent",
            "--label_name=label", "--sequence_length=16",
            "--micro_batch_size=8", "--dtype=float32", "--epoch_num=1",
            "--learning_rate=1e-3", "--logging_steps=1",
            "--pretrained_model_name_or_path=%s/model" % base,
            "--checkpoint_dir=" + ckpt,
            "--user_defined_parameters=enable_metakd=true"]


def test_meta_teacher_cli_matches_jax(fixture_dir):
    from easynlp_tpu_torch.distillation.distill_metakd_application import (
        MetaTeacherClassification)
    from easynlp_tpu_torch.ops import attention as A
    jax_trainer = run_jax(_cli_argv(fixture_dir,
                                    os.path.join(fixture_dir, "jax_teacher")))
    ckpt = os.path.join(fixture_dir, "port_teacher")
    port = run_port(_cli_argv(fixture_dir, ckpt))
    assert type(port).__name__ == "MetaTeacherTrainer"
    assert port.global_step == jax_trainer.global_step == 4
    losses = {}
    for tag, path in (("jax", jax_trainer.args.checkpoint_dir),
                      ("port", ckpt)):
        with open(os.path.join(path, "events.jsonl")) as f:
            losses[tag] = [json.loads(line)["loss"] for line in f
                           if json.loads(line)["kind"] == "train"]
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=1e-6,
                               rtol=0)
    assert_trained_like_jax(jax_trainer, MetaTeacherClassification, ckpt,
                            os.path.join(fixture_dir, "model"),
                            num_labels=2)
    argv = ["--tables=%s/dev.tsv" % fixture_dir, "--checkpoint_dir=" + ckpt,
            "--app_name=text_classify", "--input_schema=" + SCHEMA,
            "--first_sequence=sent", "--label_name=label",
            "--sequence_length=16", "--micro_batch_size=8",
            "--dtype=float32", "--user_defined_parameters=enable_metakd=true"]
    results = run_port(["--mode=evaluate"] + argv)
    assert [m for m, _ in results][:2] == ["accuracy", "f1"]
    out = os.path.join(fixture_dir, "pred_teacher.tsv")
    A.short_attention_fwd.launches = 0
    run_port(["--mode=predict", "--outputs=" + out,
              "--output_schema=predictions,probabilities"] + argv)
    assert A.short_attention_fwd.launches == 0
    rows = read_tsv(out)
    assert len(rows) == 12 and {r[0] for r in rows} <= {"neg", "pos"}


def test_meta_distillation_trains_the_student(fixture_dir):
    from easynlp_tpu_torch.core.distiller import (
        MetaDistillationTrainer,
        MetaTeacherTrainer,
    )
    from easynlp_tpu_torch.distillation.distill_metakd_application import (
        MetaStudentClassification,
        MetaTeacherClassification,
    )
    from easynlp_tpu_torch.distillation.distill_metakd_dataset import (
        MetaKDClassificationDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    model = os.path.join(fixture_dir, "model")
    ds = MetaKDClassificationDataset(
        os.path.join(fixture_dir, "train.tsv"),
        BertTokenizer.from_pretrained(model), max_seq_length=16,
        input_schema=SCHEMA, first_sequence="sent", label_name="label")

    def args(name):
        return initialize_easynlp(args_list=[
            "--device=cpu", "--micro_batch_size=8", "--epoch_num=1",
            "--learning_rate=1e-3", "--logging_steps=1",
            "--checkpoint_dir=" + os.path.join(fixture_dir, name)])

    teacher = MetaTeacherClassification.from_pretrained(
        model, device="cpu", num_labels=2)
    tr = MetaTeacherTrainer(teacher, ds, args=args("t"),
                            user_defined_parameters={
                                "domain_loss_weight": "0.5"})
    tr.train()
    assert tr.global_step == 4
    assert all(np.isfinite(r["loss"]) and "domain_loss" in r
               for r in tr.step_records)
    teacher.module.eval()
    frozen = {k: v.clone() for k, v in teacher.module.state_dict().items()}
    s_config = _config(fixture_dir, **STUDENT)
    s_dir = os.path.join(fixture_dir, "student_init")
    os.makedirs(s_dir, exist_ok=True)
    with open(os.path.join(s_dir, "config.json"), "w") as f:
        json.dump(dict(s_config, fit_size=s_config["hidden_size"] * 2), f)
    for stage in ("first", "second"):
        student = MetaStudentClassification.from_pretrained(
            s_dir, device="cpu", num_labels=2)
        start = {k: v.clone() for k, v in
                 student.module.state_dict().items()}
        d = MetaDistillationTrainer(
            student, ds, teacher_app=teacher, args=args("s_" + stage),
            user_defined_parameters={"distill_stage": stage, "T": "2"})
        d.train()
        assert d.global_step == 4
        assert all(np.isfinite(r["loss"]) for r in d.step_records)
        if stage == "first":
            assert all("att_loss" in r for r in d.step_records)
        moved = max(float((v - start[k]).abs().max())
                    for k, v in student.module.state_dict().items())
        assert moved > 1e-5
    for k, v in teacher.module.state_dict().items():
        assert torch.equal(v, frozen[k]), k
