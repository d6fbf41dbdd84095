"""Logging setup.

Port of the JAX package's ``operator/logging.py`` (reference
pkg/operator/logging/logging.go: zap-via-knative there, stdlib logging
here): --log-level wires through, and debug-event suppression maps to the
events logger's level. The JAX package's ``quiet_xla_warnings`` quiets XLA's
C++ logger and has no counterpart here.
"""

from __future__ import annotations

import logging

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def configure(log_level: str = "info") -> logging.Logger:
    level = _LEVELS.get(log_level.lower(), logging.INFO)
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    logger = logging.getLogger("karpenter_tpu_torch")
    logger.setLevel(level)
    # debug-event suppression (logging.go): events stay quiet unless debug
    logging.getLogger("karpenter_tpu_torch.events").setLevel(
        logging.DEBUG if level == logging.DEBUG else logging.WARNING
    )
    return logger
