"""Row-schema parsing and pretrained-model path resolution for the PyTorch
port (its own copy of easynlp_tpu/utils/__init__.py's local part)."""

import os

from easynlp_tpu_torch.utils.logger import logger


def parse_schema(input_schema):
    """'name:type:len,name:type:len' -> list of (name, type, length).

    Types: str, int, float; int:N or float:N with N > 1 is a list column."""
    if not input_schema:
        return []
    out = []
    for col in input_schema.split(","):
        parts = col.split(":")
        name = parts[0]
        ctype = parts[1] if len(parts) > 1 else "str"
        clen = int(parts[2]) if len(parts) > 2 else 1
        out.append((name, ctype, clen))
    return out


def parse_row_by_schema(row, input_schema):
    """Split one TSV row into a {column: typed value} dict."""
    schema = input_schema if isinstance(input_schema, list) else parse_schema(input_schema)
    fields = row.rstrip("\n").split("\t")
    out = {}
    for (name, ctype, clen), value in zip(schema, fields):
        if ctype == "int":
            out[name] = int(value) if clen == 1 else [int(x) for x in value.split(" ") if x]
        elif ctype == "float":
            out[name] = float(value) if clen == 1 else [float(x) for x in value.split(" ") if x]
        else:
            out[name] = value
    return out


MODELZOO_CACHE_ENV = "EASYNLP_MODELZOO_BASE_DIR"


def get_pretrain_model_path(name_or_path):
    """Resolve a pretrained model name to a local directory: an existing
    path, then $EASYNLP_MODELZOO_BASE_DIR/<name>, then
    ~/.easynlp_tpu/modelzoo/<name>; otherwise the name itself, with a
    warning. Remote paths (oss:// and the like) and the JAX package's model
    zoo registry are not ported: a remote path raises."""
    if not name_or_path:
        return name_or_path
    if os.path.exists(name_or_path):
        return name_or_path
    if "://" in str(name_or_path):
        raise NotImplementedError(
            "remote model path %r: the port reads local directories only"
            % name_or_path)
    candidates = []
    base = os.environ.get(MODELZOO_CACHE_ENV)
    if base:
        candidates.append(os.path.join(base, name_or_path))
    candidates.append(os.path.join(
        os.path.expanduser("~/.easynlp_tpu/modelzoo"), name_or_path))
    for cand in candidates:
        if os.path.isdir(cand):
            return cand
    logger.warning("pretrained model %r not found locally; treating as "
                   "config name", name_or_path)
    return name_or_path
