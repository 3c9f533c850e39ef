"""Process-wide logger (port of ``rcf_tpu/utils/logging.py``)."""

import logging
import sys

_LOGGER_NAME = "rcf_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def set_loglevel(debug: bool = True) -> None:
    logger = get_logger()
    level = logging.DEBUG if debug else logging.WARNING
    logger.setLevel(level)
    logger.handlers.clear()
    handler = logging.StreamHandler(sys.stdout)
    handler.setLevel(level)
    handler.setFormatter(
        logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    )
    logger.addHandler(handler)
    logger.propagate = False
