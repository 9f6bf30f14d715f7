"""The port's global args and the typed user_defined_parameters parser (its
own copy of the parts of easynlp_tpu/utils/global_vars.py that it calls).
The port's args live here, apart from the JAX package's, so both CLIs can
run in one process."""

import json

_GLOBAL_ARGS = None

# Typed registry for app parameters carried in --user_defined_parameters.
# Everything else stays a string.
USER_DEFINED_PARAMETERS_TYPES = {
    "pretrain_model_name_or_path": str,
    "language": str,
    "multi_label": bool,
    "enable_distillation": bool,
    "enable_fewshot": bool,
    "type": str,
    "two_tower": bool,
    "siamese": bool,
    "enable_vit": bool,
    "enable_vqgan": bool,
    "loss_type": str,
    "margin": float,
    "gamma": float,
    "embedding_size": int,
    "temperature": float,
    "alpha": float,
    "logits_saved_path": str,
    "logits_name": str,
    "teacher_model_path": str,
    "pattern": str,
    "label_desc": str,
    "dkplm_model_prefix": bool,
    "kangaroo_model_prefix": bool,
    "contrast_learning_flag": bool,
    "mask_language_model": bool,
    "enable_lora": bool,
    "lora_rank": int,
    "lora_alpha": float,
    "lora_targets": str,
    "enable_controlnet": bool,
    "controlnet_hint": str,
    "controlnet_hint_column": str,
    "serve_quantize": str,
    "serve_params_dtype": str,
}


def parse_user_defined_parameters(raw):
    """Parse 'k1=v1 k2=v2' (and app_parameters={json}) into a typed dict."""
    if raw is None:
        return {}
    if isinstance(raw, dict):
        return raw
    params = {}
    raw = raw.strip()
    if not raw:
        return params
    # app_parameters may be a JSON object containing spaces; extract it first.
    key = "app_parameters="
    if key in raw:
        start = raw.index(key) + len(key)
        depth, end = 0, start
        if raw[start] == "{":
            for i in range(start, len(raw)):
                depth += raw[i] == "{"
                depth -= raw[i] == "}"
                if depth == 0:
                    end = i + 1
                    break
            params["app_parameters"] = json.loads(raw[start:end])
            raw = raw[: raw.index(key)] + raw[end:]
    for token in raw.split():
        k, _, v = token.partition("=")
        caster = USER_DEFINED_PARAMETERS_TYPES.get(k, str)
        if caster is bool:
            params[k] = v.lower() in ("true", "1", "yes")
        else:
            try:
                params[k] = caster(v)
            except ValueError:
                params[k] = v
    # app_parameters' keys also land in the flat namespace, typed, and the
    # nested dict stays
    for k, v in dict(params.get("app_parameters", {})).items():
        caster = USER_DEFINED_PARAMETERS_TYPES.get(k, None)
        if caster is bool and isinstance(v, str):
            v = v.lower() in ("true", "1", "yes")
        elif caster and not isinstance(v, caster):
            try:
                v = caster(v)
            except (TypeError, ValueError):
                pass
        params.setdefault(k, v)
    return params


def set_global_args(args):
    global _GLOBAL_ARGS
    _GLOBAL_ARGS = args
    return args


def get_args():
    if _GLOBAL_ARGS is None:
        raise RuntimeError("call easynlp_tpu_torch.initialize_easynlp() first")
    return _GLOBAL_ARGS
