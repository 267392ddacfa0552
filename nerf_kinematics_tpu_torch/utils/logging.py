"""Leveled structured logger: stdlib logging with two extra levels, SUCCESS
and PROGRESS (the banners of instant-ngp's console logger).

Counterpart of ``nerf_kinematics_tpu/utils/logging.py``; the loggers live
under ``nerf_kinematics_tpu_torch``.
"""

from __future__ import annotations

import logging
import sys

SUCCESS = 25
PROGRESS = 15
logging.addLevelName(SUCCESS, "SUCCESS")
logging.addLevelName(PROGRESS, "PROGRESS")

ROOT = "nerf_kinematics_tpu_torch"
_FORMAT = "%(asctime)s %(levelname)-8s %(name)s: %(message)s"
_configured = False


def _configure():
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root = logging.getLogger(ROOT)
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    # Propagation stays on: the stdlib root logger has no handler by default
    # (nothing prints twice), and pytest's caplog and host applications that
    # attach root handlers still see the records.
    _configured = True


def get_logger(name: str = ROOT) -> logging.Logger:
    _configure()
    if not name.startswith(ROOT):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)


def success(logger: logging.Logger, msg: str, *args) -> None:
    logger.log(SUCCESS, msg, *args)


def progress(logger: logging.Logger, msg: str, *args) -> None:
    logger.log(PROGRESS, msg, *args)
