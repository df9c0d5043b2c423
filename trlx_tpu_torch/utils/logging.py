"""Library-wide logging subsystem.

Capability parity with trlx's ``utils/logging.py``:
HF-transformers-style per-library verbosity controlled by the ``TRLX_VERBOSITY`` env var,
a multi-process adapter that can restrict records to specific process indices and prefixes
``[RANK n]``, and a switchable tqdm. Process identity comes from ``torch.distributed``
when a process group is up, else from the ``RANK`` environment variable.
"""

import logging
import os
import sys
import threading
from typing import Optional

log_levels = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}

_default_log_level = logging.INFO
_lock = threading.Lock()
_default_handler: Optional[logging.Handler] = None

_LIBRARY_NAME = "trlx_tpu_torch"


def _get_default_logging_level() -> int:
    env_level = os.environ.get("TRLX_VERBOSITY", None)
    if env_level:
        if env_level.lower() in log_levels:
            return log_levels[env_level.lower()]
        logging.getLogger().warning(
            f"Unknown TRLX_VERBOSITY={env_level}, must be one of {list(log_levels)}"
        )
    return _default_log_level


def _get_library_root_logger() -> logging.Logger:
    return logging.getLogger(_LIBRARY_NAME)


def _configure_library_root_logger() -> None:
    global _default_handler
    with _lock:
        if _default_handler:
            return
        _default_handler = logging.StreamHandler(sys.stdout)
        _default_handler.flush = sys.stdout.flush
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s", "%H:%M:%S"
        )
        _default_handler.setFormatter(formatter)
        root = _get_library_root_logger()
        root.addHandler(_default_handler)
        root.setLevel(_get_default_logging_level())
        root.propagate = False


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


class MultiProcessAdapter(logging.LoggerAdapter):
    """Logger adapter filtering records by process index.

    ``logger.info(msg, ranks=[0])`` only emits on process 0 (the default);
    ``ranks=[-1]`` emits on every process with a ``[RANK n]`` prefix.
    """

    @staticmethod
    def _should_log(ranks) -> bool:
        idx = _process_index()
        return idx in ranks or -1 in ranks

    def log(self, level, msg, *args, **kwargs):
        ranks = kwargs.pop("ranks", [0])
        idx = _process_index()
        if self.isEnabledFor(level) and self._should_log(ranks):
            if idx != 0 or -1 in ranks:
                msg = f"[RANK {idx}] {msg}"
            self.logger.log(level, msg, *args, **kwargs)

    def process(self, msg, kwargs):
        return msg, kwargs


def get_logger(name: Optional[str] = None) -> MultiProcessAdapter:
    """Return a ``MultiProcessAdapter`` for ``name`` (defaults to the library root)."""
    _configure_library_root_logger()
    if name is None:
        name = _LIBRARY_NAME
    return MultiProcessAdapter(logging.getLogger(name), {})


def get_verbosity() -> int:
    _configure_library_root_logger()
    return _get_library_root_logger().getEffectiveLevel()


def set_verbosity(verbosity: int) -> None:
    _configure_library_root_logger()
    _get_library_root_logger().setLevel(verbosity)


def set_verbosity_debug():
    set_verbosity(logging.DEBUG)


def set_verbosity_info():
    set_verbosity(logging.INFO)


def set_verbosity_warning():
    set_verbosity(logging.WARNING)


def set_verbosity_error():
    set_verbosity(logging.ERROR)


def disable_default_handler() -> None:
    _configure_library_root_logger()
    assert _default_handler is not None
    _get_library_root_logger().removeHandler(_default_handler)


def enable_default_handler() -> None:
    _configure_library_root_logger()
    assert _default_handler is not None
    _get_library_root_logger().addHandler(_default_handler)


_tqdm_active = True


class _EmptyTqdm:
    def __init__(self, *args, **kwargs):
        self._iterator = args[0] if args else None

    def __iter__(self):
        return iter(self._iterator)

    def __getattr__(self, _):
        def empty_fn(*args, **kwargs):
            return

        return empty_fn

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return


class _TqdmCls:
    def __call__(self, *args, **kwargs):
        if _tqdm_active and _process_index() == 0:
            try:
                from tqdm import tqdm as real_tqdm

                return real_tqdm(*args, **kwargs)
            except ImportError:
                pass
        return _EmptyTqdm(*args, **kwargs)


tqdm = _TqdmCls()


def enable_progress_bar():
    global _tqdm_active
    _tqdm_active = True


def disable_progress_bar():
    global _tqdm_active
    _tqdm_active = False
