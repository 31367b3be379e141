"""Logging-level helpers (counterpart of ``apex_tpu/transformer/log_util.py``,
apex's ``transformer/log_util.py``), under the port's ``apex_tpu_torch``
logger root."""

from __future__ import annotations

import logging

__all__ = ["get_transformer_logger", "set_logging_level"]


def get_transformer_logger(name: str) -> logging.Logger:
    """The ``apex_tpu_torch.transformer.<name>`` logger."""
    return logging.getLogger(f"apex_tpu_torch.transformer.{name}")


def set_logging_level(verbosity) -> None:
    """Set the level of the ``apex_tpu_torch`` root logger."""
    logging.getLogger("apex_tpu_torch").setLevel(verbosity)
