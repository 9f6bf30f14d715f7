"""Process-rank-aware logger for the PyTorch port (the port's own copy of
easynlp_tpu/utils/logger.py, under its own logger name)."""

import logging
import os
import sys

_LOGGER_NAME = "easynlp_tpu_torch"


def init_logger(local_rank: int = 0, level: int = logging.INFO) -> logging.Logger:
    """Initialise the package logger. Non-zero ranks log at WARNING so a
    multi-process run does not print N copies of every line."""
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(
        logging.Formatter(
            fmt="[%(asctime)s] [%(levelname)s] [rank{}] %(message)s".format(local_rank),
            datefmt="%Y-%m-%d %H:%M:%S",
        )
    )
    logger.addHandler(handler)
    if local_rank == 0 or os.environ.get("EASYNLP_LOG_ALL_RANKS"):
        logger.setLevel(level)
    else:
        logger.setLevel(logging.WARNING)
    logger.propagate = False
    return logger


logger = init_logger(int(os.environ.get("EASYNLP_PROCESS_INDEX", "0")))
