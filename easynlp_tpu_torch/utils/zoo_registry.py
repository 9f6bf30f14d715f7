"""Name -> artifact resolution for the model/app zoos (the PyTorch port's
own copy of easynlp_tpu/utils/zoo_registry.py).

Capability parity: reference easynlp/utils/__init__.py:101-202
(modelzoo_alibaba.json name->tgz resolution + download/untar into
$HOME/.easynlp/modelzoo) and reference easynlp/pipelines/__init__.py:161-249
(appzoo_config.json model->{app_name, model_path} + get_app_model_path).

TPU/zero-egress redesign: the "remote" is any root the pluggable io seam can
read — an oss:// bucket (OSSIO backend), or a plain local directory used as
the registry emulation in tests (same seam as LocalDirIO). Artifacts are
fetched once into $EASYNLP_CACHE_ROOT (default ~/.easynlp_tpu) and re-used;
.tgz artifacts are untarred, directory artifacts are copied. Fetches land in
a temp dir and are renamed into place so partial downloads never register as
complete.
"""

import json
import os
import shutil
import tarfile
import tempfile

from easynlp_tpu_torch.utils.io_utils import io
from easynlp_tpu_torch.utils.logger import logger

MODELZOO_MAPPING_NAME = "modelzoo_alibaba.json"
APPZOO_MAPPING_NAME = "appzoo_config.json"


def cache_root():
    return os.path.expanduser(
        os.environ.get("EASYNLP_CACHE_ROOT", "~/.easynlp_tpu"))


def remote_root():
    """Registry root readable through the io seam ('' disables remote
    resolution — only already-cached artifacts resolve)."""
    return os.environ.get("EASYNLP_REMOTE_MODELZOO", "")


def _join(root, *parts):
    return root.rstrip("/") + "/" + "/".join(p.strip("/") for p in parts)


def load_mapping(mapping_name):
    """Fetch the name->artifact mapping json from the remote root; fall back
    to the cached copy (reference pipelines/__init__.py:161-180 semantics)."""
    local = os.path.join(cache_root(), mapping_name)
    remote = remote_root()
    if remote:
        try:
            os.makedirs(cache_root(), exist_ok=True)
            with io.open(_join(remote, mapping_name)) as f:
                data = f.read()
            json.loads(data)  # never cache a truncated/invalid mapping
            fd, tmp = tempfile.mkstemp(dir=cache_root(), prefix=".map_")
            with os.fdopen(fd, "w") as f:
                f.write(data)
            os.replace(tmp, local)  # atomic: partial writes never register
        except Exception as exc:  # noqa: BLE001 — stale-cache fallback
            if os.path.exists(local):
                logger.info("using cached %s (remote fetch failed: %s)",
                            mapping_name, exc)
            else:
                raise RuntimeError(
                    "no %s at remote root %r and no cached copy"
                    % (mapping_name, remote)) from exc
    if not os.path.exists(local):
        return {}
    with open(local) as f:
        return json.load(f)


def _copy_tree_via_io(remote_dir, dst):
    """Recursive copy through the io seam (handles nested artifact dirs —
    tokenizer/, shard subdirs)."""
    os.makedirs(dst, exist_ok=True)
    for fname in io.listdir(remote_dir):
        src = _join(remote_dir, fname)
        if io.isdir(src):
            _copy_tree_via_io(src, os.path.join(dst, fname))
        else:
            io.copy(src, os.path.join(dst, fname))


def _rename_into_place(tmp, local_dir):
    """Atomic publish tolerant of a concurrent fetch of the same artifact:
    if another process won the rename, use its copy."""
    try:
        os.rename(tmp, local_dir)
    except OSError:
        if os.path.isdir(local_dir):
            shutil.rmtree(tmp, ignore_errors=True)
            return
        raise


def _fetch_tree(remote_dir, local_dir):
    os.makedirs(os.path.dirname(local_dir) or "/", exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.dirname(local_dir), prefix=".fetch_")
    try:
        _copy_tree_via_io(remote_dir, tmp)
        _rename_into_place(tmp, local_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def fetch_remote_dir(remote_dir):
    """A remote model directory (oss:// and the like) fetched once into
    <cache>/modelzoo/<bucket path> and re-used."""
    local_dir = os.path.join(cache_root(), "modelzoo",
                             remote_dir.split("://", 1)[1].strip("/"))
    if not os.path.isdir(local_dir):
        _fetch_tree(remote_dir, local_dir)
        logger.info("fetched %s -> %s", remote_dir, local_dir)
    return local_dir


def fetch_artifact(rel_path, subdir):
    """Resolve a mapping artifact path to a local directory: `x/y.tgz` is
    downloaded and untarred to <cache>/<subdir>/x/y; a directory artifact is
    copied. Idempotent — an existing local dir short-circuits."""
    base = os.path.join(cache_root(), subdir)
    local_dir = os.path.join(base, rel_path.replace(".tgz", ""))
    if os.path.isdir(local_dir):
        return local_dir
    remote = remote_root()
    if not remote:
        raise RuntimeError(
            "artifact %r not cached under %s and EASYNLP_REMOTE_MODELZOO is "
            "not set" % (rel_path, base))
    os.makedirs(os.path.dirname(local_dir), exist_ok=True)
    if rel_path.endswith(".tgz"):
        fd, tmp_tar = tempfile.mkstemp(suffix=".tgz",
                                       dir=os.path.dirname(local_dir))
        os.close(fd)
        tmp_dir = tempfile.mkdtemp(dir=os.path.dirname(local_dir),
                                   prefix=".untar_")
        try:
            io.copy(_join(remote, rel_path), tmp_tar)
            with tarfile.open(tmp_tar, "r:gz") as tar:
                tar.extractall(tmp_dir)  # noqa: S202 — registry is trusted
            # the tarball contains either a single top-level dir (any name)
            # or the artifact files directly
            entries = os.listdir(tmp_dir)
            if len(entries) == 1 and os.path.isdir(
                    os.path.join(tmp_dir, entries[0])):
                _rename_into_place(os.path.join(tmp_dir, entries[0]),
                                   local_dir)
            else:
                _rename_into_place(tmp_dir, local_dir)
        finally:
            if os.path.exists(tmp_tar):
                os.remove(tmp_tar)
            shutil.rmtree(tmp_dir, ignore_errors=True)
    else:
        _fetch_tree(_join(remote, rel_path), local_dir)
    logger.info("fetched %s -> %s", rel_path, local_dir)
    return local_dir


# ----------------------------------------------------------------- modelzoo
def resolve_pretrained_name(name):
    """modelzoo_alibaba.json name->path resolution (reference
    utils/__init__.py:146-199). Returns a local model dir, or None when the
    name is not in the mapping (caller decides how to proceed)."""
    try:
        mapping = load_mapping(MODELZOO_MAPPING_NAME)
    except RuntimeError:
        return None
    if name not in mapping:
        return None
    return fetch_artifact(mapping[name], "modelzoo")


def list_pretrained_models():
    try:
        return sorted(load_mapping(MODELZOO_MAPPING_NAME))
    except RuntimeError:
        return []


# ------------------------------------------------------------------- appzoo
def get_remote_app_model_mapping():
    """appzoo_config.json: model_name -> {app_name, model_path}
    (reference pipelines/__init__.py:161-180)."""
    return load_mapping(APPZOO_MAPPING_NAME)


def get_app_model_path(model_name, mapping=None):
    """Resolve a registered app-model name to a local dir (reference
    pipelines/__init__.py:200-249)."""
    mapping = mapping if mapping is not None else \
        get_remote_app_model_mapping()
    if model_name not in mapping:
        raise RuntimeError(
            "`%s` is not an existing pre-defined model name. Here's the "
            "list:\n%s" % (model_name,
                           "\n".join("\t" + k for k in sorted(mapping))))
    return fetch_artifact(mapping[model_name]["model_path"], "appzoo")


def get_supported_app_model():
    """The registered app models, by app name."""
    mapping = get_remote_app_model_mapping()
    by_app = {}
    for model, entry in mapping.items():
        by_app.setdefault(entry["app_name"], []).append(model)
    return by_app
