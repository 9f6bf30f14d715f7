"""machine_reading_comprehension in the PyTorch port against the JAX
package, at test_torch_text_match.py's tiny BERT, in f32 on the CPU:
identical features ([CLS] q [SEP] c [SEP], the context cut to fit, the
answer found by token match or (0, 0)), start/end logits (-1e30 at the
padding), loss (positions clamped) and gradients within 1e-5, the same F1
and exact match on the same predictions, and, from the port's trained
checkpoint, the same evaluate metrics and answer spans through both CLIs."""

import json
import os

import numpy as np
import pytest

from test_torch_text_match import (
    WORDS,
    _restore_global_args,  # noqa: F401
    assert_cli_imports_no_jax,
    assert_same_tsv,
    check_parity,
    eval_args,
    jax_params,
    make_bert_dir,
    port_module,
    read_tsv,
    run_jax,
    run_port,
    stub_forward,
)

SCHEMA = "qas_id:str:1,question:str:1,context:str:1,answer:str:1"
SEQ_LEN = 40


def make_rows(path, n, seed):
    """Rows whose answer is a run of 1-3 context words; every fourth row's
    answer is absent from the context, and some contexts run past the
    sequence length (the answer then may be cut off)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            question = " ".join(rng.choice(WORDS, rng.randint(2, 6)))
            context = list(rng.choice(WORDS, rng.randint(6, 40)))
            start = rng.randint(0, len(context))
            answer = context[start:start + rng.randint(1, 4)]
            if i % 4 == 3:
                answer = ["unseenword", "zzz"]
            f.write("q%d\t%s\t%s\t%s\n" % (i, question, " ".join(context),
                                           " ".join(answer)))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_mrc"))
    make_bert_dir(os.path.join(base, "model"), heads={"qa_outputs": 2})
    make_rows(os.path.join(base, "train.tsv"), 32, seed=1)
    make_rows(os.path.join(base, "dev.tsv"), 10, seed=2)
    return base


def common_argv():
    return ["--app_name=machine_reading_comprehension",
            "--input_schema=" + SCHEMA, "--first_sequence=question",
            "--second_sequence=context", "--label_name=answer",
            "--sequence_length=%d" % SEQ_LEN, "--micro_batch_size=8",
            "--dtype=float32"]


def test_dataset_features_match_jax(fixture_dir):
    from easynlp_tpu.appzoo.machine_reading_comprehension.data import (
        MRCDataset as JaxDataset)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.machine_reading_comprehension.data import (
        MRCDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    kw = dict(max_seq_length=SEQ_LEN, input_schema=SCHEMA,
              first_sequence="question", second_sequence="context",
              label_name="answer")
    path = os.path.join(fixture_dir, "train.tsv")
    want = JaxDataset(path, JaxTok.from_pretrained(model), **kw).features
    got = MRCDataset(path, BertTokenizer.from_pretrained(model),
                     **kw).features
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["start_positions"] == 0).sum() >= 8  # absent answers
    assert (got["end_positions"] > got["start_positions"]).any()
    assert got["attention_mask"].sum(1).max() == SEQ_LEN  # cut contexts
    import inspect
    assert inspect.signature(MRCDataset).parameters[
        "max_seq_length"].default == 384


def test_module_loss_and_grads_match_jax(fixture_dir):
    """start/end logits, their argmaxes, the loss with one start and one
    end position past the sequence (clamped to S - 1) and the gradients."""
    from easynlp_tpu.appzoo.machine_reading_comprehension.model import (
        MachineReadingComprehension as JaxApp)
    from easynlp_tpu_torch.appzoo.machine_reading_comprehension.model import (
        MachineReadingComprehension, state_dict_from_jax)
    with open(os.path.join(fixture_dir, "model", "config.json")) as f:
        config = json.load(f)
    cfg, module, params = jax_params(JaxApp, config, seed=4)
    tmodule = port_module(MachineReadingComprehension,
                          state_dict_from_jax(params, cfg), config)
    rng = np.random.RandomState(5)
    ids = rng.randint(5, config["vocab_size"], (4, 24)).astype(np.int32)
    mask = (np.arange(24)[None] < np.array([24, 17, 9, 20])[:, None]
            ).astype(np.int32)
    types = (np.arange(24)[None] >= 6).astype(np.int32) * mask
    inputs = {"input_ids": ids, "attention_mask": mask,
              "token_type_ids": types}
    batch = {"start_positions": np.array([3, 0, 30, 7], np.int32),
             "end_positions": np.array([5, 0, 31, 99], np.int32)}
    want = check_parity(JaxApp, MachineReadingComprehension, module, params,
                        tmodule, inputs, batch, state_dict_from_jax, cfg)
    assert (np.asarray(want["start_logits"])[mask == 0] == -1e30).all()


def test_evaluator_matches_jax(fixture_dir):
    from easynlp_tpu.appzoo.machine_reading_comprehension import data as JD
    from easynlp_tpu.appzoo.machine_reading_comprehension import (
        evaluator as JE)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.machine_reading_comprehension import (
        data as PD)
    from easynlp_tpu_torch.appzoo.machine_reading_comprehension import (
        evaluator as PE)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    model = os.path.join(fixture_dir, "model")
    kw = dict(max_seq_length=SEQ_LEN, input_schema=SCHEMA,
              first_sequence="question", second_sequence="context",
              label_name="answer")
    path = os.path.join(fixture_dir, "dev.tsv")
    gold = PD.MRCDataset(path, BertTokenizer.from_pretrained(model),
                         **kw).features
    rng = np.random.RandomState(3)
    start = gold["start_positions"] + rng.randint(-1, 2, 10)
    end = gold["end_positions"] + rng.randint(-1, 2, 10)
    end[2] = start[2] - 1  # an empty predicted span
    outputs = {"start_predictions": np.r_[start, start[:2]].astype(np.int64),
               "end_predictions": np.r_[end, end[:2]].astype(np.int64)}
    results = []
    for mod_d, mod_e, tok, torch_out in (
            (JD, JE, JaxTok, False), (PD, PE, BertTokenizer, True)):
        dataset = mod_d.MRCDataset(path, tok.from_pretrained(model), **kw)
        evaluator = mod_e.MRCEvaluator(dataset, args=eval_args())
        stub_forward(evaluator, outputs, torch_out)
        results.append(evaluator.evaluate(app=None))
    want, got = results
    assert [m for m, _ in got] == [m for m, _ in want] == ["f1",
                                                           "exact_match"]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, abs=1e-12)
    assert 0 < dict(got)["f1"] < 1


@pytest.fixture(scope="module")
def trained(fixture_dir):
    ckpt = os.path.join(fixture_dir, "ckpt")
    trainer = run_port(["--mode=train",
                        "--tables=%s/train.tsv,%s/dev.tsv"
                        % (fixture_dir, fixture_dir),
                        "--pretrained_model_name_or_path=%s/model"
                        % fixture_dir, "--checkpoint_dir=" + ckpt,
                        "--epoch_num=1", "--learning_rate=1e-3",
                        "--logging_steps=1"] + common_argv())
    assert trainer.global_step == 4 and trainer.nonfinite_skips == 0
    return ckpt


def test_cli_evaluate_and_predict_match_jax(fixture_dir, trained):
    """From the port's checkpoint (bert.* without pooler, qa_outputs.*):
    the same F1 / exact match through both CLIs' evaluate, and the same
    best answers (context tokens only, the top-20 starts, at most 30
    tokens) through both predicts."""
    argv = ["--mode=evaluate", "--tables=%s/dev.tsv" % fixture_dir,
            "--checkpoint_dir=" + trained] + common_argv()
    want, got = run_jax(argv), run_port(argv)
    assert [m for m, _ in got] == [m for m, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g == pytest.approx(w, abs=1e-9)
    outs = {}
    for tag, run in (("jax", run_jax), ("port", run_port)):
        outs[tag] = os.path.join(fixture_dir, "pred_%s.tsv" % tag)
        run(["--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
             "--outputs=" + outs[tag], "--checkpoint_dir=" + trained,
             "--output_schema=predictions,best_answer",
             "--append_cols=qas_id,context"] + common_argv())
    rows = assert_same_tsv(outs["port"], outs["jax"])
    assert [r[2] for r in rows] == ["q%d" % i for i in range(10)]
    assert all(r[0] == r[1] for r in rows)
    assert sum(bool(r[0]) for r in rows) >= 8


def test_best_span_search():
    """The predictor's span search: the best start + end score among
    context tokens, the end within max_answer_length of the start."""
    from easynlp_tpu_torch.appzoo.machine_reading_comprehension.predictor \
        import best_span
    start = np.array([9., 1., 0., 5., 0., 0.])
    end = np.array([9., 0., 2., 0., 0., 4.])
    context = np.array([False, True, True, True, True, True])
    assert best_span(start, end, context, 30) == (3, 5)
    assert best_span(start, end, context, 2) == (3, 3)  # first of a tie
    assert best_span(start, end, np.zeros(6, bool), 30) == (0, 0)


def test_cli_imports_no_jax(fixture_dir, trained):
    out = "%s/pred_nojax.tsv" % fixture_dir
    assert_cli_imports_no_jax([
        "--mode=predict", "--tables=%s/dev.tsv" % fixture_dir,
        "--outputs=" + out, "--checkpoint_dir=" + trained,
        "--output_schema=predictions"] + common_argv())
    assert len(read_tsv(out)) == 10
