"""Build and load the repository's native host helpers for the PyTorch port.

The C++ sources in `native/` at the repository root (the mmap TSV reader and
the WordPiece tokenizer) are compiled with g++ on first use into
`build/native/` (listed in .gitignore), one library per source whose file
name carries a hash of the source and the flags, and loaded with ctypes.
The port does not run `native/Makefile`, which writes into the JAX
package's directory.
"""

import ctypes
import shutil
import threading
from pathlib import Path

from easynlp_tpu_torch.kernels import compile_library
from easynlp_tpu_torch.utils.logger import logger

REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = REPO_ROOT / "native"
BUILD_DIR = REPO_ROOT / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall")

_LOCK = threading.Lock()
_LIBS = {}


def _gxx():
    path = shutil.which("g++")
    if path is None:
        raise FileNotFoundError("g++ not found on PATH")
    return path


def load(name):
    """The ctypes library built from native/<name>.cpp, or None when the
    source or g++ is missing or the build fails (callers then take their
    pure-Python path, which gives the same output)."""
    with _LOCK:
        if name not in _LIBS:
            source = NATIVE_DIR / (name + ".cpp")
            try:
                path, _ = compile_library(source, BUILD_DIR, _gxx, GXX_FLAGS,
                                          [source])
                _LIBS[name] = ctypes.CDLL(str(path))
            except (FileNotFoundError, RuntimeError, OSError) as err:
                logger.warning("native %s unavailable (%s); using the Python "
                               "path", name, err)
                _LIBS[name] = None
        return _LIBS[name]
