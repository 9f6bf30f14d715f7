"""Datahub: dataset loading-script registry (the PyTorch port's own copy
of easynlp_tpu/data/datahub.py).

Capability parity: reference easynlp/appzoo/dataset.py:393-438 —
`load_dataset` fetches a loading script `<name>/<name>.py` into
~/.easynlp/datahub and hands the script dir to HF datasets; `list_datasets`
fetches the registry's datasets_list.txt.

TPU/zero-egress redesign: the remote is the same io-seam registry root as
the model zoos (EASYNLP_REMOTE_MODELZOO, see utils/zoo_registry.py), with
scripts under `datahub/<name>/<name>.py`. A plain local directory works as
the registry in tests.
"""

import os
import tempfile

from easynlp_tpu_torch.utils.io_utils import io
from easynlp_tpu_torch.utils.logger import logger
from easynlp_tpu_torch.utils.zoo_registry import _join, cache_root, remote_root

RAW_FORMATS = ("json", "csv", "text", "parquet")


def _atomic_fetch(remote_path, local):
    """Copy through the io seam into a temp file, then atomically publish —
    a partial copy must never register as a cached script/listing."""
    os.makedirs(os.path.dirname(local), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(local), prefix=".fetch_")
    os.close(fd)
    try:
        io.copy(remote_path, tmp)
        os.replace(tmp, local)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def datahub_dir():
    return os.path.join(cache_root(), "datahub")


def load_dataset(path, name=None, data_files=None, **kwargs):
    """Reference load_dataset semantics (appzoo/dataset.py:393-422):
    raw-format + data_files delegates to HF; otherwise the loading script is
    resolved through the datahub registry (fetch once, then cached) and HF
    datasets executes it."""
    import datasets as hf_datasets

    if data_files is not None and path in RAW_FORMATS:
        return hf_datasets.load_dataset(path, data_files=data_files, **kwargs)

    script_dir = os.path.join(datahub_dir(), path)
    script = os.path.join(script_dir, path + ".py")
    if not os.path.exists(script):
        remote = remote_root()
        if remote:
            src = _join(remote, "datahub", path, path + ".py")
            if io.exists(src):
                _atomic_fetch(src, script)  # fetch errors propagate loudly
                logger.info("fetched datahub script %s", script)
    if data_files is not None:
        kwargs["data_files"] = data_files
    if os.path.exists(script):
        return _run_loading_script(script, name, **kwargs)
    # not in the registry: fall through to the HF hub/cache (reference treats
    # hub datasets the same way via its 'script' remote root)
    return hf_datasets.load_dataset(path, name, **kwargs)


def _run_loading_script(script, name, **kwargs):
    """Execute a registry loading script. HF datasets >= 3 removed
    GeneratorBasedBuilder script execution, so the registry protocol is a
    plain module exposing  load(name=None, **kwargs) -> Dataset/DatasetDict
    (same capability as the reference's scripts — arbitrary Python building
    the dataset — with an explicit entry point)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "easynlp_datahub_" + os.path.basename(script)[:-3], script)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not hasattr(mod, "load"):
        raise RuntimeError(
            "datahub script %s must define load(name=None, **kwargs)"
            % script)
    return mod.load(name, **kwargs)


def list_datasets():
    """Registry dataset names (reference appzoo/dataset.py:425-438). Reads
    datasets_list.txt from the registry root; the cached copy is the
    fallback."""
    local = os.path.join(datahub_dir(), "datasets_list.txt")
    remote = remote_root()
    if remote:
        try:
            _atomic_fetch(_join(remote, "datahub", "datasets_list.txt"),
                          local)
        except Exception as exc:  # noqa: BLE001 — stale-cache fallback
            if not os.path.exists(local):
                raise RuntimeError(
                    "no datasets_list.txt at registry root %r" % remote) \
                    from exc
    if not os.path.exists(local):
        return []
    with open(local) as f:
        return [ln.strip() for ln in f if ln.strip()]
