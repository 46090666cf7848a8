"""Leveled logger (ERR/WARN/INFO always on, DBG env-gated), the analogue of
reference src/utils/log.h:6-20 built on Python logging."""
from __future__ import annotations

import logging
import os

_level = logging.DEBUG if os.environ.get("SMTPU_DEBUG") else logging.INFO
logger = logging.getLogger("sparsematrix_tpu")
if not logger.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("[%(levelname).1s %(asctime)s] %(message)s",
                                     "%H:%M:%S"))
    logger.addHandler(h)
logger.setLevel(_level)

log_err = logger.error
log_warn = logger.warning
log_info = logger.info
log_dbg = logger.debug
