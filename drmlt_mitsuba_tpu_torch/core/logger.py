"""Logging setup (counterpart of drmlt_mitsuba_tpu/core/logger.py): one
named logger to stdout, at a level from the
reference's trace..error names, and `dump_config`, which logs every field
of a configuration at the start of a render (DRMLTConfiguration::dump)."""
from __future__ import annotations

import dataclasses
import logging
import sys

LOGGER = "drmlt_torch"


def setup_logging(level: str = "info",
                  quiet: bool = False) -> logging.Logger:
    """The port's logger at `level` ("debug", "info", "warning", ...),
    writing to stdout unless `quiet`; earlier handlers are dropped, so a
    second call reconfigures it."""
    logger = logging.getLogger(LOGGER)
    logger.setLevel(getattr(logging, level.upper()))
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s %(levelname).4s %(name)s: %(message)s", "%H:%M:%S")
    if not quiet:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger


def dump_config(logger: logging.Logger, name: str, cfg):
    """Log every field of a dataclass or dict configuration."""
    logger.info("%s configuration:", name)
    if dataclasses.is_dataclass(cfg):
        for f in dataclasses.fields(cfg):
            logger.info("   %s = %s", f.name, getattr(cfg, f.name))
    elif isinstance(cfg, dict):
        for k, v in cfg.items():
            logger.info("   %s = %s", k, v)
