"""Argument parsing for the PyTorch port: its own copy of the JAX package's
flag surface (easynlp_tpu/utils/arguments.py), so one command line drives
either CLI. Flags the port does not implement yet are parsed all the same
and refused where they would take effect (core/trainer.py)."""

import argparse
import os

APP_NAME_CHOICES = [
    "text_classify",
    "text_match",
    "sequence_labeling",
    "language_modeling",
    "vectorization",
    "data_augmentation",
    "geep_classify",
    "sequence_generation",
    "machine_reading_comprehension",
    "open_domain_dialogue",
    "information_extraction",
    "clip",
    "wukong_clip",
    "text2video_retrieval",
    "text2image_generation",
    "image2text_generation",
    "video2text_generation",
    "latent_diffusion",
]


def _add_easynlp_args(parser: argparse.ArgumentParser) -> None:
    group = parser.add_argument_group("easynlp", "core arguments")
    group.add_argument("--mode", default="train",
                       choices=["train", "evaluate", "predict", "export",
                                "serve"])
    group.add_argument("--app_name", default="text_classify",
                       choices=APP_NAME_CHOICES,
                       help="Application in the AppZoo to dispatch to")
    group.add_argument("--tables", default=None, type=str,
                       help="Input tables: train,valid for train mode; "
                            "single file otherwise")
    group.add_argument("--input_schema", default=None, type=str,
                       help="Column schema 'name:type:len,name:type:len,...'")
    group.add_argument("--first_sequence", default=None, type=str)
    group.add_argument("--second_sequence", default=None, type=str)
    group.add_argument("--label_name", default=None, type=str)
    group.add_argument("--label_enumerate_values", default=None, type=str)
    group.add_argument("--checkpoint_dir", "--checkpoint_path", default=None,
                       type=str, help="Directory to save/load checkpoints")
    group.add_argument("--pretrained_model_name_or_path", default=None,
                       type=str)
    group.add_argument("--outputs", default=None, type=str,
                       help="Prediction output table/file")
    group.add_argument("--output_schema", default="", type=str,
                       help="Comma-separated prediction output columns")
    group.add_argument("--append_cols", default=None, type=str,
                       help="Input columns to copy into prediction output")
    group.add_argument("--sequence_length", default=128, type=int)
    group.add_argument("--micro_batch_size", default=32, type=int,
                       help="Per-device batch size")
    group.add_argument("--predict_queue_size", default=1024, type=int)
    group.add_argument("--predict_slice_size", default=4096, type=int)
    group.add_argument("--predict_thread_num", default=1, type=int)
    group.add_argument("--predict_checkpoint_path", default=None, type=str)
    group.add_argument("--data_threads", default=4, type=int)
    group.add_argument("--user_defined_parameters", default=None, type=str,
                       help="Free-form 'k=v k2=v2' extension channel")

    group = parser.add_argument_group("train", "training arguments")
    group.add_argument("--epoch_num", default=3.0, type=float)
    group.add_argument("--learning_rate", default=5e-5, type=float)
    group.add_argument("--weight_decay", default=1e-4, type=float)
    group.add_argument("--adam_beta1", default=0.9, type=float)
    group.add_argument("--adam_beta2", default=0.999, type=float)
    group.add_argument("--adam_epsilon", default=1e-8, type=float)
    group.add_argument("--max_grad_norm", default=1.0, type=float)
    group.add_argument("--warmup_proportion", default=0.1, type=float)
    group.add_argument("--gradient_accumulation_steps", default=1, type=int)
    group.add_argument("--optimizer_type", default="AdamW", type=str,
                       choices=["AdamW", "BertAdam", "Adam", "SGD", "Lion",
                                "Adafactor"])
    group.add_argument("--lr_scheduler", default="warmup_linear", type=str,
                       choices=["none", "constant", "warmup_constant",
                                "warmup_linear", "warmup_cosine",
                                "warmup_cosine_with_hard_restarts"])
    group.add_argument("--save_checkpoint_steps", default=None, type=int)
    group.add_argument("--save_all_checkpoints", action="store_true")
    group.add_argument("--eval_batch_size", default=None, type=int)
    group.add_argument("--resume_from_checkpoint", default=None, type=str)
    group.add_argument("--export_tf_checkpoint_type", default=None, type=str)
    group.add_argument("--logging_steps", default=100, type=int)
    group.add_argument("--random_seed", "--seed", default=1234, type=int)
    group.add_argument("--skip_first_step", action="store_true")

    group = parser.add_argument_group("runtime", "runtime arguments")
    group.add_argument("--prng_impl", default="rbg", type=str,
                       choices=["rbg", "threefry2x32"],
                       help="JAX's dropout PRNG; ignored by the port")
    group.add_argument("--dtype", default="bfloat16", type=str,
                       choices=["float32", "bfloat16"],
                       help="Compute dtype (params stay fp32)")
    group.add_argument("--mesh", default=None, type=str,
                       help="Device mesh spec 'dp=4,fsdp=1,tp=2' (not "
                            "ported: the port runs on one device)")
    group.add_argument("--remat", default="none", type=str,
                       choices=["none", "full", "selective", "names"],
                       help="Activation rematerialisation policy (not "
                            "ported)")
    group.add_argument("--shard_optimizer_states", action="store_true")
    group.add_argument("--scan_unroll", default=1, type=int,
                       help="JAX's layers per scan iteration; ignored by "
                            "the port, which has one module per layer")
    group.add_argument("--use_flash_attention", default="auto", type=str,
                       choices=["auto", "true", "false"],
                       help="The hand-written attention kernels: auto/true "
                            "where they apply, false for the plain PyTorch "
                            "attention everywhere")
    group.add_argument("--num_host_prefetch", default=2, type=int,
                       help="Training batches staged ahead in pinned host "
                            "memory and copied to the device on a side "
                            "stream; 0 turns prefetching off")
    group.add_argument("--data_workers", default=0, type=int,
                       help="Threads for per-item featurisation inside the "
                            "DataLoader")
    group.add_argument("--profile_dir", default=None, type=str,
                       help="Write a torch.profiler trace of training steps "
                            "into this directory")
    group.add_argument("--profile_steps", default=10, type=int,
                       help="How many steps to trace when --profile_dir is "
                            "set")
    group.add_argument("--async_save", action="store_true",
                       help="Write checkpoints on a background thread (not "
                            "ported)")
    group.add_argument("--ema_decay", default=0.0, type=float,
                       help="Keep an EMA of the weights with this decay (not "
                            "ported). 0 disables.")

    group = parser.add_argument_group("distributed", "multi-host arguments")
    group.add_argument("--coordinator_address", default=None, type=str)
    group.add_argument("--num_processes", default=None, type=int)
    group.add_argument("--process_index", default=None, type=int)

    group = parser.add_argument_group("generation", "text generation arguments")
    group.add_argument("--max_decode_length", default=128, type=int)
    group.add_argument("--min_decode_length", default=0, type=int)
    group.add_argument("--num_beams", default=1, type=int)
    group.add_argument("--do_sample", action="store_true")
    group.add_argument("--top_k", default=50, type=int)
    group.add_argument("--top_p", default=1.0, type=float)
    group.add_argument("--temperature", default=1.0, type=float)
    group.add_argument("--repetition_penalty", default=1.0, type=float)
    group.add_argument("--no_repeat_ngram_size", default=0, type=int)
    group.add_argument("--length_penalty", default=1.0, type=float)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="easynlp", description="EasyNLP PyTorch port", allow_abbrev=False)
    _add_easynlp_args(parser)
    return parser


def parse_args(extra_args_provider=None, args_list=None):
    """Parse arguments; unknown ones are tolerated and reported."""
    parser = build_parser()
    if extra_args_provider is not None:
        extra_args_provider(parser)
    args, unknown = parser.parse_known_args(args=args_list)
    if unknown:
        from easynlp_tpu_torch.utils.logger import logger
        logger.warning("Unrecognized arguments (ignored): %s", unknown)

    args.process_index = args.process_index if args.process_index is not None else int(
        os.environ.get("EASYNLP_PROCESS_INDEX", os.environ.get("RANK", "0")))
    args.num_processes = args.num_processes if args.num_processes is not None else int(
        os.environ.get("EASYNLP_NUM_PROCESSES", os.environ.get("WORLD_SIZE", "1")))
    args.is_master_node = args.process_index == 0

    if args.eval_batch_size is None:
        args.eval_batch_size = args.micro_batch_size
    args.train_batch_size = args.micro_batch_size
    return args
