"""
detex_tpu: a JAX/XLA waveform-similarity clustering and subspace detection
framework.

Re-implements the capabilities of Detex (github.com/d-chambers/Detex) with
an accelerator-first architecture: all compute-bound cores (pairwise
normalized cross-correlation, subspace detection statistics, SVD,
triggering) run as batched JAX/XLA programs on device, while I/O, catalogs
and SQLite persistence stay on host.

Public API mirrors the reference (`detex/__init__.py:42-43,57-153`):
    createCluster, createSubSpace, loadClusters, loadSubSpace,
    setLogger, log, closeLogger
"""
from __future__ import annotations

import inspect
import logging
import os

__version__ = "0.1.0"

# ---------------------------------------------------------------------------
# Global logging configuration (mirrors reference detex/__init__.py:42-153)
# ---------------------------------------------------------------------------
verbose = True   # print log messages with pri=True to stdout
makeLog = False  # write messages to the log file

_logger = None
_log_path = None
_MAX_LOG_BYTES = 10 * 1024 * 1024  # 10 MB cap; delete and restart if exceeded


class DetexError(Exception):
    """Raised by detex_tpu.log(level='error')."""


def setLogger(fileName="detex_tpu.log", deleteOld=False):
    """
    Set up the module-level logger writing to ``fileName``.

    Parameters
    ----------
    fileName : str
        Path to the log file.
    deleteOld : bool
        If True delete any existing log file first.

    Behavior follows reference ``detex.setLogger`` (__init__.py:57-93)
    including the 10 MB delete-and-restart size cap.
    """
    global _logger, _log_path, makeLog
    if os.path.exists(fileName):
        if deleteOld:
            os.remove(fileName)
        elif os.path.getsize(fileName) > _MAX_LOG_BYTES:
            os.remove(fileName)
    makeLog = True
    _log_path = fileName
    logger = logging.getLogger("detex_tpu")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
    fh = logging.FileHandler(fileName)
    fh.setLevel(logging.DEBUG)
    fmt = logging.Formatter(
        "%(asctime)s\t%(name)s\t%(levelname)s\t%(message)s")
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    _logger = logger
    return logger


def log(name, msg, level="info", pri=False, close=False, e=None):
    """
    Central logging/error funnel (mirrors reference ``detex.log``,
    __init__.py:95-148). ``level='error'`` logs then *raises* (DetexError or
    ``e`` if given) -- logging doubles as the error mechanism throughout.

    Parameters
    ----------
    name : str
        Module name (``__name__`` of the caller).
    msg : str
        The message.
    level : str
        'info' | 'debug' | 'warning'/'warn' | 'error'.
    pri : bool
        If True also print the message (when detex_tpu.verbose).
    close : bool
        If True close the logger after logging.
    e : Exception class or None
        Exception type to raise when level == 'error'.
    """
    # tag with calling function like the reference does via inspect
    try:
        cfun = inspect.stack()[1][3]
    except Exception:  # pragma: no cover - inspect can fail in exotic frames
        cfun = "?"
    full = "%s.%s: %s" % (name, cfun, msg)
    if makeLog and _logger is not None:
        lvl = level.lower()
        if lvl == "info":
            _logger.info(full)
        elif lvl == "debug":
            _logger.debug(full)
        elif lvl.startswith("warn"):
            _logger.warning(full)
        elif lvl == "error":
            _logger.error(full)
        else:
            raise ValueError("log level %s not supported" % level)
    if pri and verbose:
        print(msg)
    if close and makeLog and _logger is not None:
        closeLogger()
    if level.lower() == "error":
        if e is None:
            e = DetexError
        raise e(msg)


def closeLogger():
    """Close the file handlers of the module logger."""
    global _logger
    if _logger is not None:
        for h in list(_logger.handlers):
            h.close()
            _logger.removeHandler(h)
        _logger = None


# ---------------------------------------------------------------------------
# Submodule imports & API re-exports (after logging is defined: submodules
# call detex_tpu.log at import-error time)
# ---------------------------------------------------------------------------
# persistent XLA compile cache (detex_tpu/compile_cache.py): every bank
# shape is a fresh XLA compile, so caching programs across processes is a
# first-order performance feature, not a convenience.
from detex_tpu import compile_cache  # noqa: E402
compile_cache.enable()

from detex_tpu import core          # noqa: E402
from detex_tpu import ops           # noqa: E402
from detex_tpu import data          # noqa: E402
from detex_tpu import interop       # noqa: E402
from detex_tpu import util          # noqa: E402
from detex_tpu import native        # noqa: E402
from detex_tpu import profiling     # noqa: E402
from detex_tpu import quality_check  # noqa: E402
from detex_tpu import construct     # noqa: E402
from detex_tpu import subspace      # noqa: E402
from detex_tpu import fas           # noqa: E402
from detex_tpu import detect        # noqa: E402
from detex_tpu import results       # noqa: E402
from detex_tpu import parallel      # noqa: E402
from detex_tpu import oracle        # noqa: E402
from detex_tpu import migrate       # noqa: E402
from detex_tpu import stats         # noqa: E402
from detex_tpu import serving       # noqa: E402

# getdata is the reference's module name for the data layer; keep an alias so
# user code written against the reference API keeps working.
from detex_tpu.data import fetcher as getdata  # noqa: E402

from detex_tpu.construct import createCluster, createSubSpace  # noqa: E402
from detex_tpu.util import loadClusters, loadSubSpace          # noqa: E402
