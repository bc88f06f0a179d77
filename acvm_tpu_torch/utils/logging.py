"""Package logging (acvm_js/src/logging.rs analogue).

The reference exposes ``initLogLevel(level)`` with levels
OFF/ERROR/WARN/INFO/DEBUG/TRACE (`acvm_js/src/logging.rs:6-31`); this maps the
same level names onto the stdlib ``logging`` hierarchy under the
``acvm_tpu_torch`` root logger.  Engine components log through ``get_logger``.
"""

from __future__ import annotations

import logging

_LEVELS = {
    "OFF": logging.CRITICAL + 10,
    "ERROR": logging.ERROR,
    "WARN": logging.WARNING,
    "INFO": logging.INFO,
    "DEBUG": logging.DEBUG,
    "TRACE": 5,
}

logging.addLevelName(5, "TRACE")

_configured = False


def init_log_level(level: str) -> None:
    """Set the package's logging level (reference levels, case-insensitive;
    unknown names fall back to ERROR like the reference's
    ``Level::from_str(...).unwrap_or(Level::Error)``)."""
    global _configured
    root = logging.getLogger("acvm_tpu_torch")
    if not _configured:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(levelname)s %(name)s: %(message)s")
        )
        root.addHandler(handler)
        root.propagate = False
        _configured = True
    root.setLevel(_LEVELS.get(level.upper(), logging.ERROR))


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"acvm_tpu_torch.{name}")
