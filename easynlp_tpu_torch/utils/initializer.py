"""Runtime initialisation for the PyTorch port.

Counterpart of easynlp_tpu/utils/initializer.py: parse the shared flag
surface (utils/arguments.py, plus the port's --device), set the
global args, seed numpy/random/torch, resolve the device and wire
--use_flash_attention to the attention kernel override. One process drives
one device; multi-GPU is ROADMAP A23.
"""

import random

import numpy as np
import torch

from easynlp_tpu_torch.ops.attention import set_kernel_override
from easynlp_tpu_torch.utils.arguments import parse_args
from easynlp_tpu_torch.utils.global_vars import (
    parse_user_defined_parameters,
    set_global_args,
)
from easynlp_tpu_torch.utils.logger import init_logger, logger


def _add_port_args(parser):
    group = parser.add_argument_group("torch", "PyTorch port arguments")
    group.add_argument("--device", default="cuda", type=str,
                       help="torch device to run on (cuda, cuda:N or cpu). "
                            "cuda needs a card: there is no CPU fallback.")


def resolve_device(name):
    """torch.device for --device; raises when a CUDA device is asked for and
    is not there."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "--device=%s but torch.cuda.is_available() is False; pass "
                "--device=cpu to run on the CPU" % name)
        index = 0 if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError("--device=%s but only %d CUDA device(s) are "
                               "visible" % (name, torch.cuda.device_count()))
        device = torch.device("cuda", index)
    elif device.type != "cpu":
        raise ValueError("--device=%s: the port runs on cuda or cpu" % name)
    return device


def initialize_easynlp(extra_args_provider=None, args_list=None):
    """Parse args, resolve the device, seed, set the attention override.
    Returns args, with args.device a torch.device."""
    def provider(parser):
        _add_port_args(parser)
        if extra_args_provider is not None:
            extra_args_provider(parser)

    args = parse_args(extra_args_provider=provider, args_list=args_list)
    set_global_args(args)
    init_logger(args.process_index)
    args.user_defined_parameters_dict = parse_user_defined_parameters(
        args.user_defined_parameters)
    args.device = resolve_device(args.device)

    random.seed(args.random_seed)
    np.random.seed(args.random_seed)
    torch.manual_seed(args.random_seed)

    # set on every call (auto included), so a second run in one process does
    # not inherit the first run's choice
    set_kernel_override({"auto": None, "true": True, "false": False}[
        args.use_flash_attention])

    if args.pretrained_model_name_or_path is None:
        args.pretrained_model_name_or_path = \
            args.user_defined_parameters_dict.get("pretrain_model_name_or_path")
    if args.pretrained_model_name_or_path:
        from easynlp_tpu_torch.utils import get_pretrain_model_path
        args.pretrained_model_name_or_path = get_pretrain_model_path(
            args.pretrained_model_name_or_path)

    logger.info("EasyNLP PyTorch port initialised: app=%s mode=%s dtype=%s "
                "device=%s", args.app_name, args.mode, args.dtype,
                args.device)
    return args
