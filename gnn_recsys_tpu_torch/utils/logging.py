"""Module-level logger factory (port of ``gnn_recsys_tpu/utils/logging.py``;
reference ``logging_config.get_logger``): one ``logging.Logger`` a module
name with a single INFO stream handler and a timestamped format."""

from __future__ import annotations

import logging

_FORMAT = "%(asctime)s-%(name)s-%(levelname)s: %(message)s"


def get_logger(name: str) -> logging.Logger:
    """Logger with one INFO stream handler; idempotent per name."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.propagate = False
        logger.setLevel(logging.DEBUG)
        handler = logging.StreamHandler()
        handler.setLevel(logging.INFO)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
    return logger
