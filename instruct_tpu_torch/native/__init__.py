"""Native (C) fast path for panel parsing, bound via ctypes.

Counterpart of ``instruct_tpu/native/__init__.py``.  ``tokenize.c`` is
compiled on first use with the host's C compiler into
``instruct_tpu_torch/build/native/`` (rebuilt when the source is newer) and
loaded from there, never from the JAX package's cache.  Everything degrades
to the pure-Python loader when the compiler or the fast path's
preconditions are unavailable.  Host parsing only: nothing here touches a
device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

NONINT = np.iinfo(np.int64).min

SRC = Path(__file__).resolve().parent / "tokenize.c"
BUILD = Path(__file__).resolve().parent.parent / "build" / "native"
LIB_NAME = "libinstruct_tokenize.so"

_LIB = None
_TRIED = False


def _build_lib() -> ctypes.CDLL:
    BUILD.mkdir(parents=True, exist_ok=True)
    so_path = BUILD / LIB_NAME
    if (not so_path.exists()
            or so_path.stat().st_mtime < SRC.stat().st_mtime):
        # build beside the target and rename: concurrent builders each
        # install a whole library
        with tempfile.TemporaryDirectory(dir=BUILD) as td:
            tmp_so = os.path.join(td, "lib.so")
            cc = os.environ.get("CC", "cc")
            subprocess.run([cc, "-O3", "-shared", "-fPIC", str(SRC), "-o",
                            tmp_so], check=True, capture_output=True)
            os.replace(tmp_so, so_path)
    lib = ctypes.CDLL(str(so_path))
    lib.tokenize_ints.restype = ctypes.c_longlong
    lib.tokenize_ints.argtypes = [
        ctypes.c_char_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_longlong,
    ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded tokenizer library, or None when it cannot be built."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        try:
            _LIB = _build_lib()
        except Exception:
            _LIB = None
    return _LIB


def tokenize_file(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(values int64[n_tokens], tokens_per_line int64[n_lines]) or None if
    the native library is unavailable.  Non-integer tokens are NONINT."""
    lib = get_lib()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        buf = fh.read()
    max_tokens = max(len(buf) // 2 + 16, 1024)
    values = np.empty(max_tokens, np.int64)
    max_lines = buf.count(b"\n") + 2
    line_tokens = np.empty(max_lines, np.int64)
    n_lines = lib.tokenize_ints(
        buf, len(buf),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_tokens,
        line_tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_lines)
    if n_lines < 0:
        return None
    line_tokens = line_tokens[:n_lines]
    values = values[:int(line_tokens.sum())]
    return values, line_tokens
