"""Logging for lightgbm_tpu_torch.

Analogue of the reference's static ``Log`` facade
(``include/LightGBM/utils/log.h:27-104``): four levels driven by a
``verbosity`` knob, plus CHECK helpers, backed by the stdlib ``logging``
module.
"""
from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("lightgbm_tpu_torch")
# attach exactly ONE handler that this module owns: the ownership flag
# keeps repeated imports/reloads from double-printing, whatever other
# handlers (pytest's, a user's) are attached to the same logger
_OWNED_FLAG = "_lightgbm_tpu_torch_owned"
if not any(getattr(h, _OWNED_FLAG, False) for h in _logger.handlers):
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[LightGBM-Torch] [%(levelname)s] %(message)s"))
    setattr(_h, _OWNED_FLAG, True)
    _logger.addHandler(_h)
    _logger.setLevel(logging.INFO)


def set_verbosity(verbosity: int) -> None:
    """Map the reference ``verbosity`` config (<0 fatal, 0 warn, 1 info, >1 debug)."""
    if verbosity < 0:
        _logger.setLevel(logging.CRITICAL)
    elif verbosity == 0:
        _logger.setLevel(logging.WARNING)
    elif verbosity == 1:
        _logger.setLevel(logging.INFO)
    else:
        _logger.setLevel(logging.DEBUG)


def debug(msg: str, *args) -> None:
    _logger.debug(msg, *args)


def info(msg: str, *args) -> None:
    _logger.info(msg, *args)


def warning(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def fatal(msg: str, *args) -> None:
    text = msg % args if args else msg
    _logger.critical(text)
    raise RuntimeError(text)
