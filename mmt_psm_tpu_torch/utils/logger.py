"""Logging setup (the port's copy of ``mmt_psm_tpu/utils/logger.py``, after
the reference's maskrcnn_benchmark/utils/logger.py:7-28): one stdout
handler and one ``<save_dir>/log.txt`` file handler per logger, on rank 0
of a process group; the other ranks' loggers get no handler (Python's
last resort prints their warnings)."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(name)s %(levelname)s: %(message)s"


def setup_logger(name: str, save_dir: str | None = None, filename: str = "log.txt",
                 distributed_rank: int = 0) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False  # the root logger would print each line twice
    if distributed_rank > 0:
        return logger
    streams = [h for h in logger.handlers if isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)]
    if not streams:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(ch)
    if save_dir:
        path = os.path.abspath(os.path.join(save_dir, filename))
        have = any(isinstance(h, logging.FileHandler) and getattr(h, "baseFilename", None) == path
                   for h in logger.handlers)
        if not have:
            # a second run dir in the same process must not keep appending
            # to the first dir's log
            for h in [h for h in logger.handlers if isinstance(h, logging.FileHandler)]:
                logger.removeHandler(h)
                h.close()
            os.makedirs(save_dir, exist_ok=True)
            fh = logging.FileHandler(path)
            fh.setLevel(logging.DEBUG)
            fh.setFormatter(logging.Formatter(_FORMAT))
            logger.addHandler(fh)
    return logger
