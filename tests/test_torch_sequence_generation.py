"""GPT-2 generation end to end: `--mode=predict --app_name=sequence_generation`
through the JAX package's CLI and the PyTorch port's CLI on one tiny model
directory (a byte-level BPE vocab.json/merges.txt, a 2-layer GPT-2 config,
HF-named weights made with numpy from a seed and saved as
pytorch_model.bin, which JAX reads through convert_gpt2_state_dict). Both
run in f32 on the CPU: `generated_ids` must be identical, token for token.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from easynlp_tpu_torch.modelzoo.models.gpt2.tokenization_gpt2 import (
    bytes_to_unicode,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEMA = "id:str:1,text:str:1"
OUT_SCHEMA = "predictions,beams,generated_ids"
WORDS = ["the", "model", "then", "in", "an", "other", "on", "here", "there",
         "generation", "token", "cache", "decode", "rather", "one"]
MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("a", "n"),
          ("e", "r"), ("o", "n"), ("r", "e"), ("Ġ", "o"), ("t", "h"),
          ("Ġ", "c"), ("Ġ", "a")]
CONFIG = dict(model_type="gpt2", n_positions=64, n_embd=32, n_layer=2,
              n_head=2, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
              initializer_range=0.02)


def write_tokenizer(model_dir, merges=MERGES):
    """vocab.json (the 256 byte symbols, then one token per merge, then
    <|endoftext|>) and merges.txt. Id 0 is "!", as in GPT-2's vocabulary.
    Returns the vocab size; EOS is the last id."""
    vocab = {s: i for i, s in enumerate(bytes_to_unicode().values())}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|endoftext|>"] = len(vocab)
    with open(os.path.join(model_dir, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(model_dir, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")
        f.write("".join("%s %s\n" % m for m in merges))
    return len(vocab)


def write_weights(model_dir, config, seed=0):
    """HF-named GPT-2 weights (`transformer.` prefix, Conv1D [in, out],
    the tied lm_head.weight and HF's attn.bias / attn.masked_bias buffers
    too) from a numpy seed; biases and LayerNorms are randomised so the
    comparison exercises them."""
    rng = np.random.RandomState(seed)
    e, v = config["n_embd"], config["vocab_size"]
    state = {}

    def put(name, *shape, std=0.02, mean=0.0):
        state["transformer." + name] = torch.from_numpy(
            (mean + std * rng.standard_normal(shape)).astype(np.float32))

    put("wte.weight", v, e)
    put("wpe.weight", config["n_positions"], e)
    for i in range(config["n_layer"]):
        for ln in ("ln_1", "ln_2"):
            put("h.%d.%s.weight" % (i, ln), e, std=0.1, mean=1.0)
            put("h.%d.%s.bias" % (i, ln), e, std=0.1)
        for name, n_in, n_out in (("attn.c_attn", e, 3 * e),
                                  ("attn.c_proj", e, e),
                                  ("mlp.c_fc", e, 4 * e),
                                  ("mlp.c_proj", 4 * e, e)):
            put("h.%d.%s.weight" % (i, name), n_in, n_out)
            put("h.%d.%s.bias" % (i, name), n_out)
        n = config["n_positions"]
        state["transformer.h.%d.attn.bias" % i] = torch.tril(
            torch.ones(n, n)).view(1, 1, n, n)
        state["transformer.h.%d.attn.masked_bias" % i] = torch.tensor(-1e4)
    put("ln_f.weight", e, std=0.1, mean=1.0)
    put("ln_f.bias", e, std=0.1)
    state["lm_head.weight"] = state["transformer.wte.weight"]
    torch.save(state, os.path.join(model_dir, "pytorch_model.bin"))
    return state


def make_model_dir(model_dir, seed=0, **overrides):
    os.makedirs(model_dir, exist_ok=True)
    config = dict(CONFIG, **overrides)
    config["vocab_size"] = write_tokenizer(model_dir)
    config["eos_token_id"] = config["bos_token_id"] = config["vocab_size"] - 1
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(config, f)
    write_weights(model_dir, config, seed)
    return config


def make_tsv(path, n, seed=0):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            words = rng.choice(WORDS, rng.randint(1, 4))
            f.write("%d\t%s\n" % (i, " ".join(words).capitalize()))


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("torch_seqgen"))
    make_model_dir(os.path.join(base, "model"))
    make_tsv(os.path.join(base, "rows.tsv"), 10, seed=3)
    return base


def predict_argv(base, outputs, udp="max_decoder_length=8", *extra):
    return ["--mode=predict", "--app_name=sequence_generation",
            "--tables=%s/rows.tsv" % base, "--outputs=" + outputs,
            "--input_schema=" + SCHEMA, "--first_sequence=text",
            "--output_schema=" + OUT_SCHEMA, "--append_cols=id",
            "--checkpoint_dir=%s/model" % base, "--micro_batch_size=4",
            "--sequence_length=12", "--dtype=float32",
            "--user_defined_parameters=" + udp, *extra]


def read_rows(path):
    with open(path, encoding="utf-8") as f:
        return [line.rstrip("\n").split("\t") for line in f]


def _fresh_args():
    from easynlp_tpu.utils import global_vars
    global_vars._GLOBAL_ARGS = None


@pytest.fixture(autouse=True)
def _restore_global_args():
    """The CLIs set the process-wide args; put back what was there so no
    later test in this process sees the port's args."""
    from easynlp_tpu.utils import global_vars
    saved = global_vars._GLOBAL_ARGS
    yield
    global_vars._GLOBAL_ARGS = saved


@pytest.mark.parametrize("udp", [
    "max_decoder_length=8",
    "max_decoder_length=6 num_beams=3 num_return_sequences=2",
], ids=["greedy", "beams"])
def test_port_generation_cli_matches_jax(fixture_dir, udp):
    """10 rows, micro batch 4 (the last batch padded to 4), prompts of 1-12
    tokens (truncated at 12): identical generated_ids. Each text column
    holds the prompt's own tokens and the generated ones; JAX's also
    decodes the left pads, id 0, as "!" (ROADMAP C9), the port's does not.
    """
    from easynlp_tpu import cli as jax_cli
    from easynlp_tpu_torch import cli as torch_cli
    from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
    from easynlp_tpu_torch.ops import attention as A

    tag = udp.split()[-1].split("=")[0]
    jax_out = os.path.join(fixture_dir, "jax_%s.tsv" % tag)
    torch_out = os.path.join(fixture_dir, "torch_%s.tsv" % tag)
    _fresh_args()
    assert jax_cli.main(predict_argv(fixture_dir, jax_out, udp)) == 0
    _fresh_args()
    A.short_attention_fwd.launches = 0
    assert torch_cli.main(predict_argv(fixture_dir, torch_out, udp,
                                       "--device=cpu")) == 0
    assert A.short_attention_fwd.launches == 0  # CPU: the plain twin

    jax_rows, torch_rows = read_rows(jax_out), read_rows(torch_out)
    assert len(jax_rows) == len(torch_rows) == 10
    assert [r[3] for r in torch_rows] == [str(i) for i in range(10)]
    new = int(udp.split()[0].split("=")[1])
    tok = GPT2Tokenizer.from_pretrained(os.path.join(fixture_dir, "model"))
    eos = tok.eos_token_id
    padded = 0
    for j, t in zip(jax_rows, torch_rows):
        assert t[2] == j[2]  # generated_ids, token for token
        ids = [int(x) for x in t[2].split()]
        assert len(ids) == 12 + new
        pads = next(i for i, x in enumerate(ids) if x != 0)
        generated = ids[12:]
        if eos in generated:
            generated = generated[:generated.index(eos) + 1]
        assert t[0] == tok.decode(ids[pads:12] + generated,
                                  skip_special_tokens=True)
        assert j[0] == tok.decode(ids, skip_special_tokens=True)
        assert j[0].startswith("!" * pads)
        padded += pads > 0
        if "num_beams" in udp:
            assert len(t[1].split("||")) == 2 == len(j[1].split("||"))
            assert t[1].split("||")[0] == t[0]
    assert padded >= 5  # the comparison covers left-padded rows


def test_prediction_text_stops_at_eos(fixture_dir):
    """A generated EOS ends the text: the slots after it (pad id 0, "!" in
    the JAX predictor's text) are not decoded."""
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.appzoo.sequence_generation.predictor import (
        SequenceGenerationPredictor)
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    _fresh_args()
    args = initialize_easynlp(args_list=predict_argv(
        fixture_dir, os.path.join(fixture_dir, "eos.tsv"),
        "max_decoder_length=8", "--device=cpu"))
    manager = default_main_fn(args)
    predictor = manager.predictor
    assert isinstance(predictor, SequenceGenerationPredictor)
    eos = predictor.app.config.eos_token_id
    gen = np.full((1, 20), 0, np.int32)
    gen[0, 9:12] = [72, 73, 74]             # prompt "ijk", 3 tokens
    gen[0, 12:15] = [75, eos, 0]            # "l", EOS, then pad fill
    out = predictor.postprocess({"generated_ids": gen,
                                 "attention_mask": np.array([[1] * 3 + [0] * 9])})
    assert out["predictions"] == ["ijkl"]
    assert out["generated_ids"][0].split()[12:14] == ["75", str(eos)]


def test_app_generate_right_and_left_padded_prompts_agree(fixture_dir):
    """app.generate re-packs prompts left-padded and counts max_length in
    new tokens (as the JAX app): right- and left-padded encodings of the
    same prompts give the same tokens; copy_constrained keeps every
    generated token inside the row's own prompt (+ EOS and pad)."""
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    app = SequenceGeneration.from_pretrained(
        os.path.join(fixture_dir, "model"), device="cpu")
    right = np.array([[11, 12, 13, 0, 0, 0], [21, 22, 23, 24, 25, 0]],
                     np.int32)
    left = np.array([[0, 0, 0, 11, 12, 13], [0, 21, 22, 23, 24, 25]],
                    np.int32)
    out_r = app.generate(right, (right != 0).astype(np.int32), max_length=6)
    out_l = app.generate(left, (left != 0).astype(np.int32), max_length=6)
    assert out_r.shape == (2, 12)
    np.testing.assert_array_equal(out_r.numpy(), out_l.numpy())
    for beams in (1, 2):
        out = app.generate(right, (right != 0).astype(np.int32),
                           max_length=6, num_beams=beams,
                           copy_constrained=True).numpy()
        for row, src in zip(out, right):
            allowed = set(src.tolist()) | {app.config.eos_token_id, 0}
            assert set(row[6:].tolist()) <= allowed


def test_checkpoint_keys_load_strictly(fixture_dir):
    """The HF-named checkpoint (transformer. prefix, tied lm_head, attn
    buffers) loads into the port strictly and lands on the same tensors."""
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    model_dir = os.path.join(fixture_dir, "model")
    app = SequenceGeneration.from_pretrained(model_dir, device="cpu")
    state = torch.load(os.path.join(model_dir, "pytorch_model.bin"),
                       weights_only=True)
    got = app.module.transformer.state_dict()
    assert set(got) == {k[len("transformer."):] for k in state
                        if k.startswith("transformer.")
                        and not k.endswith((".attn.bias", ".masked_bias"))}
    for k, v in got.items():
        assert torch.equal(v, state["transformer." + k]), k
    assert not [n for n, _ in app.module.named_parameters()
                if not n.startswith("transformer.")]  # the head is tied


@pytest.mark.parametrize("argv,match", [
    (["--mode=train"], "does not train GPT-2"),
    (["--mode=export"], "A26"),
    (["--mode=predict",
      "--user_defined_parameters=speculative_decoding=prompt_lookup"], None),
    (["--mode=predict", "--user_defined_parameters=kv_cache_dtype=int8"],
     None),
])
def test_unported_generation_modes_raise(fixture_dir, argv, match):
    """GPT-2 train and --mode=export raise. speculative_decoding and
    kv_cache_dtype=int8, which raised until slice 11 ported them, predict:
    speculative decoding gives the plain predict's generated_ids, the int8
    cache the JAX CLI's under the same parameters (f32, token for
    token)."""
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    if match is None:
        from easynlp_tpu import cli as jax_cli
        from easynlp_tpu_torch import cli as torch_cli
        udp = "max_decoder_length=8 num_draft_tokens=3 " \
            + argv[1].split("=", 1)[1]
        tag = udp.split()[-1].split("=")[0]
        outs = {}
        for side, extra in (("torch", udp), ("ref", "max_decoder_length=8")):
            outs[side] = os.path.join(fixture_dir, "%s_%s.tsv" % (side, tag))
            _fresh_args()
            if side == "ref" and "kv_cache" in tag:
                assert jax_cli.main(predict_argv(fixture_dir, outs[side],
                                                 udp)) == 0
                continue
            assert torch_cli.main(predict_argv(fixture_dir, outs[side],
                                               extra, "--device=cpu")) == 0
        got, want = read_rows(outs["torch"]), read_rows(outs["ref"])
        assert len(got) == 10
        assert [r[2] for r in got] == [r[2] for r in want]
        return
    _fresh_args()
    args = initialize_easynlp(args_list=argv + [
        "--device=cpu", "--app_name=sequence_generation",
        "--checkpoint_dir=%s/model" % fixture_dir,
        "--pretrained_model_name_or_path=%s/model" % fixture_dir,
        "--tables=%s/rows.tsv" % fixture_dir,
        "--outputs=%s/unused.tsv" % fixture_dir,
        "--input_schema=" + SCHEMA, "--first_sequence=text"])
    with pytest.raises(NotImplementedError, match=match):
        default_main_fn(args)


@pytest.mark.parametrize("model_type,match", [("glm", "no backbone"),
                                              ("bloom", "no backbone")])
def test_encoder_decoder_backbones_raise(tmp_path, model_type, match):
    """sequence_generation on a checkpoint of a family it has no backbone
    for raises, from load_config and from the CLI (BART, T5, mT5, Pegasus,
    Randeng, the dialogue transformer and GPT-2 are held to JAX in their own
    test files). A glm checkpoint, which raised with enable_glm too until
    slice 11, is read by the enable_glm variant (GLMSequenceGeneration, as
    in JAX; test_torch_glm.py holds it to JAX) and by AutoConfig."""
    from easynlp_tpu_torch.appzoo.api import default_main_fn
    from easynlp_tpu_torch.appzoo.sequence_generation.model import (
        SequenceGeneration)
    from easynlp_tpu_torch.utils.initializer import initialize_easynlp
    (tmp_path / "config.json").write_text(json.dumps(
        {"model_type": model_type}))
    with pytest.raises(NotImplementedError, match=match):
        SequenceGeneration.load_config(str(tmp_path))
    args = initialize_easynlp(args_list=[
        "--mode=predict", "--app_name=sequence_generation", "--device=cpu",
        "--checkpoint_dir=%s" % tmp_path, "--tables=unused.tsv"])
    with pytest.raises(NotImplementedError, match=match):
        default_main_fn(args)
    if model_type == "glm":
        from easynlp_tpu_torch.appzoo import api
        from easynlp_tpu_torch.modelzoo.models.auto import AutoConfig
        app_cls = api._resolve(api.MODEL_REGISTRY, "sequence_generation",
                               {"enable_glm": "true"})
        assert app_cls.__name__ == "GLMSequenceGeneration"
        assert app_cls.load_config(str(tmp_path)).model_type == "glm"
        assert AutoConfig.from_pretrained(str(tmp_path)).num_layers == 24


def test_chip_smoke_gpt2_inputs(tmp_path):
    """chip_smoke.py's synthetic GPT-2 vocabulary and prompts: 50257
    distinct tokens, "!" at id 0 and EOS at 50256 as in GPT-2, merges the
    tokenizer applies (words come out in multi-letter pieces), and
    GEN_ROWS prompts (16 until slice 14, now 8) of 600..768 tokens (the
    first 768) with no unknown token."""
    from easynlp_tpu_torch.modelzoo.models.gpt2 import GPT2Tokenizer
    sys.path.insert(0, REPO)
    import chip_smoke
    tokens, merges = chip_smoke.gpt2_vocab()
    assert len(tokens) == len(set(tokens)) == 50257
    assert tokens[0] == "!" and tokens[50256] == "<|endoftext|>"
    assert len(merges) == 50000
    (tmp_path / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(tokens)}), encoding="utf-8")
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join("%s %s\n" % m for m in merges),
        encoding="utf-8")
    tok = GPT2Tokenizer.from_pretrained(str(tmp_path))
    tsv = str(tmp_path / "prompts.tsv")
    chip_smoke.make_gen_tsv(tsv, tok, seed=1234)
    with open(tsv, encoding="utf-8") as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    assert [r[0] for r in rows] == [str(i)
                                    for i in range(chip_smoke.GEN_ROWS)]
    enc = tok([r[1] for r in rows], max_length=chip_smoke.GEN_PROMPT_WIDTH)
    n = enc["attention_mask"].sum(axis=1)
    assert n.min() >= 600 and n[0] == n.max() == 768
    real = enc["input_ids"][enc["attention_mask"] == 1]
    assert real.max() < 50256 and len(set(real.tolist())) > 1000
    words = sum(len(r[1].split()) for r in rows)
    assert words < 0.8 * n.sum()  # merged pieces, not single letters


def test_generation_cli_imports_no_jax(fixture_dir):
    out = os.path.join(fixture_dir, "nojax.tsv")
    code = (
        "import sys\n"
        "from easynlp_tpu_torch.cli import main\n"
        "assert main(%r) == 0\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax',\n"
        "       'sklearn', 'easynlp_tpu') or m.startswith('easynlp_tpu.')]\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n" % (predict_argv(fixture_dir, out,
                                               "max_decoder_length=4",
                                               "--device=cpu"),))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
    assert len(read_rows(out)) == 10
