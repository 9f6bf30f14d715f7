"""The port's host IO and adapter modules (ROADMAP A26) held to the JAX
package's on the CPU: testing.py, utils/oss_io.py with the io.register
seam, data/lazy_loader.py and the datasets' row routing,
data/odps_reader.py, utils/zoo_registry.py (model names, pipeline()
defaults and registered names), data/datahub.py, utils/adapter.py and
utils/exporter.py (the TF round trip, --mode=export) and
appzoo/hf_adapter.py. Each check runs the JAX function on the same inputs
(the counterparts of tests/test_data_infra.py, tests/test_zoo_registry.py
and tests/test_hf_adapter.py). TensorFlow runs only in subprocesses (with
torch or JAX beside it, never both: importing it into this process has
crashed later compiles), and the port's --mode=export runs in a
subprocess that must load no JAX module.
"""

import json
import os
import shutil
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from test_torch_text_match import make_bert_dir  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


# ------------------------------------------------------- the subprocesses

_JAX_TF_EXPORT = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from easynlp_tpu.modelzoo.models.bert import BertConfig
from easynlp_tpu.modelzoo.models.bert.conversion import convert_bert_backbone
from easynlp_tpu.utils.exporter import export_tf_checkpoint
state = dict(np.load(sys.argv[1]))
cfg = BertConfig(**__import__("json").load(open(sys.argv[2])))
export_tf_checkpoint(convert_bert_backbone(state, cfg), cfg, sys.argv[3])
"""

_PORT_TF = """
import os, sys, time
import numpy as np
import torch
import tensorflow as tf
from easynlp_tpu_torch.utils.adapter import load_bert_tf_checkpoint
from easynlp_tpu_torch.utils.exporter import export_tf_checkpoint
state = {k[len("bert."):]: torch.from_numpy(v)
         for k, v in np.load(sys.argv[1]).items()}
port_ckpt, jax_ckpt = sys.argv[2], sys.argv[3]
export_tf_checkpoint(state, port_ckpt)
deadline = time.time() + 240
while not os.path.exists(jax_ckpt + ".index"):
    assert time.time() < deadline, "no JAX export"
    time.sleep(0.2)
time.sleep(0.5)
names = sorted(n for n, _ in tf.train.list_variables(jax_ckpt))
assert names == sorted(n for n, _ in tf.train.list_variables(port_ckpt))
for n in names:
    assert np.array_equal(tf.train.load_variable(jax_ckpt, n),
                          tf.train.load_variable(port_ckpt, n)), n
loaded = load_bert_tf_checkpoint(jax_ckpt)
assert set(loaded) == set(state), set(loaded) ^ set(state)
for k, v in state.items():
    assert torch.equal(loaded[k], v), k
print("OK", len(names))
"""

_PORT_EXPORT = """
import sys
from easynlp_tpu_torch import cli
rc = cli.main(sys.argv[1:])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "easynlp_tpu",
                                       "tensorflow"))
print("LOADED", loaded)
sys.exit(rc or (3 if loaded else 0))
"""


def _start(code, *argv):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code, *map(str, argv)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc, timeout=240):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError("subprocess passed its time limit:\n" + out)
    assert proc.returncode == 0, out[-4000:]
    return out


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    """A tiny text_classify BERT directory (HF names) and its weights."""
    d = str(tmp_path_factory.mktemp("bert"))
    config = make_bert_dir(d, heads={"classifier": 2})
    state = torch.load(os.path.join(d, "pytorch_model.bin"),
                       weights_only=True)
    return d, config, {k: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module")
def subprocesses(bert_dir, tmp_path_factory):
    """The TF round trip (JAX's export beside the port's export and
    adapter) and the port's --mode=export CLI, started together at the
    module's first test and read by the tests that need them."""
    d, config, state = bert_dir
    work = tmp_path_factory.mktemp("sub")
    backbone = {k: v for k, v in state.items() if k.startswith("bert.")}
    np.savez(work / "backbone.npz", **backbone)
    (work / "config.json").write_text(json.dumps(
        {k: v for k, v in config.items() if k != "model_type"}))
    os.makedirs(work / "jax_tf")
    os.makedirs(work / "port_tf")
    jax_ckpt = work / "jax_tf" / "bert_model.ckpt"
    procs = {
        "jax_tf": _start(_JAX_TF_EXPORT, work / "backbone.npz",
                         work / "config.json", jax_ckpt),
        "port_tf": _start(_PORT_TF, work / "backbone.npz",
                          work / "port_tf" / "bert_model.ckpt", jax_ckpt),
        "export": _start(_PORT_EXPORT, "--mode=export",
                         "--app_name=text_classify", "--checkpoint_dir=" + d,
                         "--outputs=" + str(work / "exported.bin"),
                         "--device=cpu", "--dtype=float32"),
    }
    yield dict(procs=procs, work=work)
    for p in procs.values():
        if p.poll() is None:
            p.kill()


@pytest.fixture(autouse=True)
def _restore_global_args():
    """make_args registers global args in both packages: put back what the
    test found."""
    from easynlp_tpu.utils import global_vars as jax_vars
    from easynlp_tpu_torch.utils import global_vars
    saved = global_vars._GLOBAL_ARGS, jax_vars._GLOBAL_ARGS
    yield
    global_vars._GLOBAL_ARGS, jax_vars._GLOBAL_ARGS = saved


# ---------------------------------------------------------------- testing

def test_testing_helpers_match_jax(subprocesses):
    """SyntheticClassificationDataset gives JAX's rows bit for bit; the
    configs carry JAX's widths; make_args registers the flags."""
    from easynlp_tpu import testing as J
    from easynlp_tpu_torch import testing as T
    from easynlp_tpu_torch.utils.global_vars import get_args
    a, b = T.SyntheticClassificationDataset(12, 16, 100, 3, seed=4), \
        J.SyntheticClassificationDataset(12, 16, 100, 3, seed=4)
    assert len(a) == len(b) and a.label_enumerate_values == \
        b.label_enumerate_values
    for k in b.features:
        assert np.array_equal(a.features[k], b.features[k]), k
    batch = a.batch_fn([a[i] for i in range(4)])
    want = b.batch_fn([b[i] for i in range(4)])
    assert all(np.array_equal(batch[k], want[k]) for k in want)
    for fn, kw in (("bert_base_config", {}),
                   ("tiny_bert_config", {"hidden_size": 32})):
        got, ref = getattr(T, fn)(**kw), getattr(J, fn)(**kw)
        for key in ("vocab_size", "hidden_size", "num_hidden_layers",
                    "num_attention_heads", "intermediate_size",
                    "max_position_embeddings"):
            assert getattr(got, key) == getattr(ref, key), (fn, key)
    args = T.make_args(micro_batch_size=3, epoch_num=2.0)
    assert get_args() is args and args.micro_batch_size == 3


# ----------------------------------------------------------- lazy rows

@pytest.fixture()
def corpus(tmp_path):
    path = str(tmp_path / "corpus.tsv")
    with open(path, "w") as f:
        for i in range(50):
            f.write("%d\tthe good day number %d\n" % (i, i))
            if i % 10 == 0:
                f.write("\n")  # blank lines are skipped
    return path


def test_lazy_rows_match_jax(corpus, monkeypatch):
    """LazyRows: JAX's rows, slices and slice views; BaseDataset reads a
    local table through the native reader, else LazyRows (JAX
    dataset.py:49-75), the same rows either way."""
    from easynlp_tpu.data.lazy_loader import LazyRows as JaxRows
    from easynlp_tpu_torch.data import native_reader
    from easynlp_tpu_torch.data.dataset import BaseDataset
    from easynlp_tpu_torch.data.lazy_loader import LazyRows
    rows, ref = LazyRows(corpus), JaxRows(corpus)
    assert len(rows) == len(ref) == 50
    assert list(rows) == list(ref)
    assert list(rows[10:15]) == list(ref[10:15])
    assert list(rows[1::4][2:]) == list(ref[1::4][2:])
    native = BaseDataset(corpus, num_processes=2, process_index=1)
    monkeypatch.setattr(native_reader, "available", lambda: False)
    lazy = BaseDataset(corpus, num_processes=2, process_index=1)
    assert isinstance(lazy.rows, LazyRows)
    assert list(native.rows) == list(lazy.rows) == list(ref)[1::2]
    rows.close()
    ref.close()


def _vocab(path, words):
    with open(path, "w") as f:
        f.write("\n".join(BASE_VOCAB + words))
    return str(path)


def test_streaming_mlm_matches_jax(corpus, tmp_path):
    """StreamingLanguageModelingDataset: JAX's masked rows bit for bit, per
    (epoch, index) and per process slice."""
    from easynlp_tpu.data.lazy_loader import (
        StreamingLanguageModelingDataset as JaxStreaming)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.data.lazy_loader import (
        StreamingLanguageModelingDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    vocab = _vocab(tmp_path / "vocab.txt", ["the", "good", "day", "number"]
                   + [str(i) for i in range(10)])
    kw = dict(max_seq_length=12, input_schema="id:str:1,text:str:1",
              first_sequence="text", mask_probability=0.5, seed=7,
              process_index=1, num_processes=2)
    ds = StreamingLanguageModelingDataset(corpus, BertTokenizer(vocab), **kw)
    ref = JaxStreaming(corpus, JaxTok(vocab), **kw)
    assert len(ds) == len(ref) == 25
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = ds.batch_fn([ds[i] for i in range(len(ds))])
        want = ref.batch_fn([ref[i] for i in range(len(ref))])
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), (epoch, k)
        assert (got["label_ids"] != -100).sum() > 0


# ------------------------------------------------------- ODPS and OSS

def _cls_rows(path):
    with open(path, "w") as f:
        for i in range(8):
            f.write("%d\tgood day\t%s\n" % (i, "pos" if i % 2 else "neg"))


def _cls_features(dataset_cls, path, tok, **kw):
    ds = dataset_cls(path, tok, max_seq_length=8,
                     input_schema="id:str:1,sent:str:1,label:str:1",
                     first_sequence="sent", label_name="label", **kw)
    return ds, ds.batch_fn([ds[i] for i in range(len(ds))])


def test_odps_local_emulation_matches_jax(corpus, tmp_path):
    """odps://local/ tables: the reader's counts, reads, seeks and
    per-process slices as JAX's; a dataset over odps:// reads its slice
    and featurises JAX's rows."""
    from easynlp_tpu.appzoo.sequence_classification.data import (
        ClassificationDataset as JaxCls)
    from easynlp_tpu.data import odps_reader as JO
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu_torch.appzoo.sequence_classification.data import (
        ClassificationDataset)
    from easynlp_tpu_torch.data import odps_reader as O
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    for mod in (O, JO):
        mod.register_local_table("mytable", corpus)
    for slice_id, count in ((0, 1), (0, 2), (1, 2)):
        r = O.ODPSTableReader("odps://local/mytable", slice_id, count)
        j = JO.ODPSTableReader("odps://local/mytable", slice_id, count)
        assert r.get_row_count() == j.get_row_count()
        assert r.read(3) == j.read(3)
        r.seek(10)
        j.seek(10)
        assert r.read(2) == j.read(2)
        assert O.read_odps_rows("odps://local/mytable", slice_id, count) \
            == JO.read_odps_rows("odps://local/mytable", slice_id, count)
    tsv = str(tmp_path / "cls.tsv")
    _cls_rows(tsv)
    for mod in (O, JO):
        mod.register_local_table("cls", tsv)
    vocab = _vocab(tmp_path / "v.txt", ["good", "day", "pos", "neg"])
    for kw in ({}, {"process_index": 1, "num_processes": 2}):
        ds, got = _cls_features(ClassificationDataset, "odps://local/cls",
                                BertTokenizer(vocab), **kw)
        ref, want = _cls_features(JaxCls, "odps://local/cls", JaxTok(vocab),
                                  **kw)
        assert len(ds) == len(ref) == (8 if not kw else 4)
        assert ds.label_enumerate_values == ref.label_enumerate_values
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


def test_oss_scheme_through_local_dir_io(tmp_path):
    """oss:// through io.register and LocalDirIO as in JAX: writes, lists,
    copies out, a dataset featurising JAX's rows; an unregistered oss://
    path raises."""
    from easynlp_tpu.appzoo.sequence_classification.data import (
        ClassificationDataset as JaxCls)
    from easynlp_tpu.modelzoo.models.bert import BertTokenizer as JaxTok
    from easynlp_tpu.utils.io_utils import io as jax_io
    from easynlp_tpu.utils.oss_io import LocalDirIO as JaxDirIO
    from easynlp_tpu_torch.appzoo.sequence_classification.data import (
        ClassificationDataset)
    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    from easynlp_tpu_torch.utils.io_utils import io
    from easynlp_tpu_torch.utils.oss_io import LocalDirIO
    with pytest.raises(RuntimeError, match="No IO backend"):
        io.open("oss://test-bucket/data/train.tsv")
    root = str(tmp_path / "bucket")
    io.register("oss://test-bucket/", LocalDirIO("oss://test-bucket/", root))
    jax_io.register("oss://test-bucket/", JaxDirIO("oss://test-bucket/",
                                                   root))
    try:
        with io.open("oss://test-bucket/data/train.tsv", "w") as f:
            for i in range(8):
                f.write("%d\tgood day\t%s\n" % (i, "pos" if i % 2
                                                else "neg"))
        assert io.exists("oss://test-bucket/data/train.tsv")
        assert io.listdir("oss://test-bucket/data") == \
            jax_io.listdir("oss://test-bucket/data") == ["train.tsv"]
        assert io.glob("oss://test-bucket/data/*.tsv") == \
            jax_io.glob("oss://test-bucket/data/*.tsv")
        vocab = _vocab(tmp_path / "v.txt", ["good", "day", "pos", "neg"])
        _, got = _cls_features(ClassificationDataset,
                               "oss://test-bucket/data/train.tsv",
                               BertTokenizer(vocab))
        _, want = _cls_features(JaxCls, "oss://test-bucket/data/train.tsv",
                                JaxTok(vocab))
        for k in want:
            assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
        with io.open("oss://test-bucket/ckpt/meta.json", "w") as f:
            f.write('{"global_step": 3}')
        io.copy("oss://test-bucket/ckpt/meta.json", str(tmp_path / "m.json"))
        assert json.loads((tmp_path / "m.json").read_text()) == \
            {"global_step": 3}
    finally:
        io.backends.pop("oss://test-bucket/", None)
        jax_io.backends.pop("oss://test-bucket/", None)


def test_remote_model_path_resolution(tmp_path, monkeypatch):
    """An oss:// model directory is fetched once into the local model zoo,
    at JAX's path, and later resolutions hit the cache; with
    EASYNLP_CACHE_ROOT set the fetch lands under that root."""
    from easynlp_tpu.utils import get_pretrain_model_path as jax_resolve
    from easynlp_tpu_torch.utils import get_pretrain_model_path
    from easynlp_tpu_torch.utils.io_utils import io
    from easynlp_tpu_torch.utils.oss_io import LocalDirIO
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("EASYNLP_CACHE_ROOT", raising=False)
    io.register("oss://models/", LocalDirIO("oss://models/",
                                            str(tmp_path / "bucket")))
    try:
        with io.open("oss://models/tiny-bert/config.json", "w") as f:
            json.dump({"model_type": "bert", "vocab_size": 10}, f)
        with io.open("oss://models/tiny-bert/sub/vocab.txt", "w") as f:
            f.write("[PAD]\n[UNK]\n")
        local = get_pretrain_model_path("oss://models/tiny-bert")
        assert os.path.isfile(os.path.join(local, "config.json"))
        assert os.path.isfile(os.path.join(local, "sub", "vocab.txt"))
        monkeypatch.setenv("EASYNLP_CACHE_ROOT", str(tmp_path / "cache"))
        moved = get_pretrain_model_path("oss://models/tiny-bert")
        assert moved == str(tmp_path / "cache" / "modelzoo" / "models"
                            / "tiny-bert")
        assert os.path.isfile(os.path.join(moved, "sub", "vocab.txt"))
        monkeypatch.delenv("EASYNLP_CACHE_ROOT")
    finally:
        io.backends.pop("oss://models/", None)
    assert get_pretrain_model_path("oss://models/tiny-bert") == local
    assert jax_resolve("oss://models/tiny-bert") == local


# ------------------------------------------------------ the zoo registry

@pytest.fixture
def registry(tmp_path, monkeypatch):
    root, cache = tmp_path / "registry", tmp_path / "cache"
    root.mkdir()
    cache.mkdir()
    monkeypatch.setenv("EASYNLP_REMOTE_MODELZOO", str(root))
    monkeypatch.setenv("EASYNLP_CACHE_ROOT", str(cache))
    return root


def _tar_into(src_dir, registry_root, rel_tgz):
    tgz = registry_root / rel_tgz
    tgz.parent.mkdir(parents=True, exist_ok=True)
    with tarfile.open(tgz, "w:gz") as tar:
        tar.add(src_dir, arcname=os.path.basename(str(src_dir)))


def test_modelzoo_name_resolution_matches_jax(registry, tmp_path):
    """A model name resolves through modelzoo_alibaba.json to the fetched,
    untarred directory (JAX's path), later from the cache alone; an
    unknown name comes back as it is."""
    from easynlp_tpu.utils import get_pretrain_model_path as jax_resolve
    from easynlp_tpu_torch.utils import get_pretrain_model_path
    from easynlp_tpu_torch.utils.zoo_registry import list_pretrained_models
    src = tmp_path / "src" / "tiny-bert"
    src.mkdir(parents=True)
    (src / "config.json").write_text('{"model_type": "bert"}')
    _tar_into(src, registry, "public/tiny-bert.tgz")
    (registry / "modelzoo_alibaba.json").write_text(json.dumps(
        {"my-tiny-bert": "public/tiny-bert.tgz"}))
    local = get_pretrain_model_path("my-tiny-bert")
    assert os.path.isfile(os.path.join(local, "config.json"))
    assert list_pretrained_models() == ["my-tiny-bert"]
    (registry / "modelzoo_alibaba.json").unlink()
    assert get_pretrain_model_path("my-tiny-bert") == local \
        == jax_resolve("my-tiny-bert")
    (registry / "modelzoo_alibaba.json").write_text("{}")
    assert get_pretrain_model_path("no-such-model") == "no-such-model"


def test_pipeline_resolves_defaults_and_names_through_registry(
        registry, bert_dir, tmp_path):
    """pipeline('text_classify') without model_path and
    pipeline('<registered name>') resolve through appzoo_config.json (JAX
    pipelines/__init__.py:91-126) and predict as pipeline(<directory>)
    does; every task's default is JAX's and resolves."""
    from easynlp_tpu.pipelines import SUPPORTED_TASKS as JAX_TASKS
    from easynlp_tpu.utils.zoo_registry import (
        get_supported_app_model as jax_by_app)
    from easynlp_tpu_torch.pipelines import SUPPORTED_TASKS, pipeline
    from easynlp_tpu_torch.utils.zoo_registry import (
        get_app_model_path, get_supported_app_model)
    ckpt = tmp_path / "bert-base-sst"
    shutil.copytree(bert_dir[0], ckpt)
    (ckpt / "train_config.json").write_text(json.dumps(
        {"app_name": "text_classify"}))
    (ckpt / "label_mapping.json").write_text('{"neg": 0, "pos": 1}')
    mapping = {}
    for task, spec in SUPPORTED_TASKS.items():
        assert spec.get("default") == JAX_TASKS[task].get("default"), task
        if spec.get("default"):
            _tar_into(ckpt, registry, "zoo/%s.tgz" % spec["default"])
            mapping[spec["default"]] = {
                "app_name": task, "model_path": "zoo/%s.tgz" % spec["default"]}
    (registry / "appzoo_config.json").write_text(json.dumps(mapping))
    for name in mapping:
        assert os.path.isfile(os.path.join(get_app_model_path(name),
                                           "train_config.json"))
    assert get_supported_app_model() == jax_by_app()
    kw = dict(device="cpu", first_sequence="sent", sequence_length=16)
    want = pipeline(str(ckpt), **kw)(["a good day", "the end"])
    assert pipeline("text_classify", **kw)(["a good day", "the end"]) == want
    assert pipeline("bert-base-sst", **kw)(["a good day", "the end"]) == want
    with pytest.raises(ValueError, match="needs model_path"):
        pipeline("chinese-ldm-general")


def test_datahub_matches_jax(registry, tmp_path):
    """load_dataset('name') fetches and runs the registry's loading script,
    list_datasets() reads its listing, both cached once fetched; a raw
    format with data_files goes to HF datasets: JAX's results."""
    from easynlp_tpu.data.datahub import list_datasets as jax_list
    from easynlp_tpu.data.dataset import load_dataset as jax_load
    from easynlp_tpu_torch.data.datahub import list_datasets
    from easynlp_tpu_torch.data.dataset import load_dataset
    script_dir = registry / "datahub" / "toy_sentiment"
    script_dir.mkdir(parents=True)
    (script_dir / "toy_sentiment.py").write_text(
        "import datasets\n"
        "def load(name=None, **kwargs):\n"
        "    return datasets.Dataset.from_dict(\n"
        "        {'text': ['good', 'bad'], 'label': [1, 0]})\n")
    (registry / "datahub" / "datasets_list.txt").write_text(
        "toy_sentiment\n")
    ds = load_dataset("toy_sentiment")
    assert ds["text"] == jax_load("toy_sentiment")["text"] == ["good", "bad"]
    assert list_datasets() == jax_list() == ["toy_sentiment"]
    shutil.rmtree(registry / "datahub")
    assert load_dataset("toy_sentiment")["label"] == [1, 0]
    f = tmp_path / "rows.csv"
    f.write_text("text,label\nhello,1\nbye,0\n")
    assert load_dataset("csv", data_files=str(f))["train"]["label"] == \
        jax_load("csv", data_files=str(f))["train"]["label"] == [1, 0]


# ------------------------------------------------- export and TF adapter

def test_tf_checkpoint_round_trip_matches_jax(subprocesses):
    """The port's TF export writes JAX's variables (names and values, bit
    for bit) for the same backbone, and the port's adapter reads JAX's TF
    checkpoint back into the original weights (two subprocesses: JAX with
    TensorFlow, the port with TensorFlow)."""
    procs = subprocesses["procs"]
    _finish(procs["jax_tf"])
    assert "OK" in _finish(procs["port_tf"])


def test_export_cli_loads_into_hf_and_matches_jax(subprocesses, bert_dir):
    """--mode=export on a text_classify BERT checkpoint, in a process that
    loads no JAX module: the file loads into transformers' BertModel
    (strict) and equals JAX's export_bert_backbone_to_pytorch of the same
    weights tensor for tensor."""
    from transformers import BertConfig as HFConfig
    from transformers import BertModel as HFBert

    from easynlp_tpu.modelzoo.models.bert import BertConfig
    from easynlp_tpu.modelzoo.models.bert.conversion import (
        convert_bert_backbone)
    from easynlp_tpu.utils.exporter import export_bert_backbone_to_pytorch
    d, config, state = bert_dir
    out = _finish(subprocesses["procs"]["export"])
    assert "LOADED []" in out
    got = torch.load(subprocesses["work"] / "exported.bin",
                     weights_only=True)
    cfg = BertConfig(**{k: v for k, v in config.items()
                        if k != "model_type"})
    ref_path = subprocesses["work"] / "jax_export.bin"
    export_bert_backbone_to_pytorch(
        convert_bert_backbone({k: v for k, v in state.items()}, cfg), cfg,
        str(ref_path))
    want = torch.load(ref_path, weights_only=True)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    hf = HFBert(HFConfig(**{k: v for k, v in config.items()
                            if k != "model_type"}))
    missing = hf.load_state_dict({k[len("bert."):]: v
                                  for k, v in got.items()}, strict=False)
    assert not missing.unexpected_keys
    assert all("position_ids" in k for k in missing.missing_keys)


def test_tf_export_without_tensorflow_names_it(bert_dir, monkeypatch,
                                               tmp_path):
    """Where TensorFlow is not installed (the card's machine),
    export_format=tf raises naming the package."""
    from easynlp_tpu_torch.utils.exporter import export_tf_checkpoint
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    state = {k[len("bert."):]: torch.from_numpy(v)
             for k, v in bert_dir[2].items() if k.startswith("bert.")}
    with pytest.raises(ImportError, match="tensorflow"):
        export_tf_checkpoint(state, str(tmp_path / "x.ckpt"))


# ------------------------------------------------------------ HF adapter

def test_hf_adapter_matches_jax_and_trains(tmp_path):
    """A stock transformers BertForSequenceClassification under
    HFAdapterClassification (a Flax one loaded from its weights under the
    JAX adapter): logits, predictions,
    probabilities and loss as the JAX adapter's over the Flax model
    (1e-5), and the port's Trainer lowers its loss in 8 steps as the JAX
    test's does; HFAdapterMaskedLM's loss as JAX's."""
    import jax.numpy as jnp
    from transformers import BertConfig as HFConfig
    from transformers import (BertForSequenceClassification,
                              FlaxBertForSequenceClassification)

    from easynlp_tpu.appzoo.hf_adapter import (
        HFAdapterClassification as JaxAdapter)
    from easynlp_tpu.appzoo.hf_adapter import (
        HFAdapterMaskedLM as JaxMaskedLM)
    from easynlp_tpu_torch.appzoo.hf_adapter import (
        HFAdapterClassification, HFAdapterMaskedLM)
    from easynlp_tpu_torch.core.trainer import Trainer
    from easynlp_tpu_torch.testing import make_args
    cfg = HFConfig(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=64,
                   max_position_embeddings=64, num_labels=2)
    torch.manual_seed(0)
    hf = BertForSequenceClassification(cfg)
    hf.save_pretrained(tmp_path / "hf", safe_serialization=False)
    flax_model = FlaxBertForSequenceClassification.from_pretrained(
        tmp_path / "hf", from_pt=True)
    app = HFAdapterClassification.from_hf(hf, label_mapping={"0": 0, "1": 1})
    ref = JaxAdapter.from_hf(flax_model, label_mapping={"0": 0, "1": 1})

    def row(i):
        rng = np.random.RandomState(i)
        label = i % 2
        ids = rng.randint(5 + 50 * label, 60 + 50 * label, 16)
        return {"input_ids": ids.astype(np.int32),
                "attention_mask": np.ones(16, np.int32),
                "token_type_ids": np.zeros(16, np.int32),
                "label_ids": np.int32(label)}

    class Synthetic:
        def __len__(self):
            return 32

        def __getitem__(self, i):
            return row(i)

        def batch_fn(self, ex):
            return {k: np.stack([e[k] for e in ex]) for k in ex[0]}

    ds = Synthetic()
    batch = ds.batch_fn([ds[i] for i in range(8)])
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    app.module.eval()
    with torch.no_grad():
        got = app.forward(tb)
        loss = app.loss_fn(got, tb)["loss"]
    want = ref.forward({k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-5)
    np.testing.assert_allclose(got["probabilities"].numpy(),
                               np.asarray(want["probabilities"]), atol=1e-5)
    assert np.array_equal(got["predictions"].numpy(),
                          np.asarray(want["predictions"]))
    np.testing.assert_allclose(float(loss), float(JaxAdapter.loss_fn(
        want, batch)["loss"]), atol=1e-5)
    labels = np.where(np.arange(16) % 3 == 0, -100, np.arange(16) % 7)
    logits = np.random.RandomState(1).randn(2, 8, 7).astype(np.float32)
    mlm = HFAdapterMaskedLM.loss_fn(
        {"logits": torch.from_numpy(logits)},
        {"label_ids": torch.from_numpy(labels.reshape(2, 8))})["loss"]
    np.testing.assert_allclose(float(mlm), float(JaxMaskedLM.loss_fn(
        {"logits": jnp.asarray(logits)},
        {"label_ids": jnp.asarray(labels.reshape(2, 8))})["loss"]),
        atol=1e-6)
    args = make_args(micro_batch_size=8, epoch_num=3.0, logging_steps=100,
                     checkpoint_dir=str(tmp_path / "ckpt"),
                     learning_rate=5e-4, dtype="float32")
    trainer = Trainer(app, ds, args=args)
    losses = []
    for _ in range(8):
        names, values = trainer._train_step(tb)
        losses.append(dict(zip(names, values.tolist()))["loss"])
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], losses
    trainer.save_checkpoint()
    saved = torch.load(tmp_path / "ckpt" / "pytorch_model.bin",
                       weights_only=True)
    assert set(saved) == set(hf.state_dict())
