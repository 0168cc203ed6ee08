"""Logging: the port's copies of drivescenegen_tpu/utils/logging.py
get_logger, configure_file_logging and MetricWriter."""

from __future__ import annotations

import json
import logging
import os
import time

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"

# The active rotating-file handler, if configure_file_logging has run;
# get_logger attaches it to loggers created later.
_file_handler = None


def get_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    if _file_handler is not None and _file_handler not in logger.handlers:
        logger.addHandler(_file_handler)
    logger.setLevel(level)
    return logger


def configure_file_logging(log_dir: str, max_bytes: int = 10 * 1024 * 1024,
                           backup_count: int = 20) -> str:
    """Attach a rotating-file handler (<log_dir>/drivescenegen.log) to the
    root logger and to every non-propagating logger, existing or created
    later by get_logger, in place of one an earlier call attached for
    another directory. Returns the log file's path."""
    import logging.handlers

    global _file_handler

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "drivescenegen.log")
    root = logging.getLogger()
    if root.level > logging.INFO or root.level == logging.NOTSET:
        root.setLevel(logging.INFO)
    if _file_handler is None or _file_handler.baseFilename != os.path.abspath(path):
        handler = logging.handlers.RotatingFileHandler(
            path, maxBytes=max_bytes, backupCount=backup_count, encoding="utf8")
        handler.setFormatter(logging.Formatter(_FORMAT))
        handler.setLevel(logging.INFO)
        if _file_handler is not None:
            # A run in another directory (several runs in one process):
            # stop writing to the previous run's log.
            for lg in [root, *logging.Logger.manager.loggerDict.values()]:
                if isinstance(lg, logging.Logger):
                    lg.removeHandler(_file_handler)
            _file_handler.close()
        root.addHandler(handler)
        _file_handler = handler
    for name in list(logging.Logger.manager.loggerDict):
        lg = logging.getLogger(name)
        if isinstance(lg, logging.Logger) and lg.handlers and not lg.propagate:
            if _file_handler not in lg.handlers:
                lg.addHandler(_file_handler)
    return path


class MetricWriter:
    """Writes scalar metrics to <log_dir>/metrics.jsonl and, where
    tensorboardX is installed and use_tensorboard is set, to TensorBoard."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                self._tb = None

    def write(self, step: int, metrics: dict) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for key, value in metrics.items():
                self._tb.add_scalar(key, float(value), int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
