"""Build and load the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain `extern "C"` launcher. On
first use it is compiled with nvcc for Hopper (`sm_90a`) into a shared
library under `build/kernels/` at the repository root (listed in
.gitignore) and loaded with ctypes. The library's file name carries a hash of
the sources and the flags, so an unchanged tree reuses it and an edited one
rebuilds. Only the sources in this package are compiled; nothing is
downloaded.

Nothing here runs at import time: the CPU tests import every module on
machines that have neither nvcc nor a card.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}
_BUILD_INFO = {}


def available():
    """True when a CUDA card is present, so the kernels can launch."""
    import torch
    return torch.cuda.is_available()


def _nvcc():
    for candidate in (shutil.which("nvcc"),
                      os.path.join(os.environ.get("CUDA_HOME",
                                                  "/usr/local/cuda"),
                                   "bin", "nvcc")):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the "
                       "CUDA toolkit is needed to build the port's kernels")


def compile_library(source, build_dir, compiler, flags, digest_paths):
    """Compile one source file into a shared library
    `build_dir/<stem>-<hash>.so`, the hash taken over `digest_paths` (the
    source and what it includes) and the flags, so an unchanged tree reuses
    the library and an edited one rebuilds. `compiler` is called for the
    compiler's path only when a build is needed. The library is written
    under a temporary name and renamed into place, so a concurrent build
    sees all of it or none, and the check-and-build holds an exclusive
    lock on `build_dir/<stem>.lock` (fcntl.flock, released when the process
    ends), so ranks that build the same library at once compile it once:
    the first builds, the others wait and find it built. Returns (path,
    {'seconds', 'cached', 'log'})."""
    source = Path(source)
    if not source.exists():
        raise FileNotFoundError("no source %s" % source)
    h = hashlib.sha256()
    for path in sorted(set(map(Path, digest_paths)) | {source}):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(flags).encode())
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / ("%s-%s.so" % (source.stem, h.hexdigest()[:16]))
    with open(build_dir / (source.stem + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _compile_locked(source, lib_path, compiler, flags)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _compile_locked(source, lib_path, compiler, flags):
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return lib_path, {"seconds": 0.0, "cached": True, "log": log}
    tmp = lib_path.with_name("%s.%d.tmp" % (lib_path.name, os.getpid()))
    cmd = [compiler(), *flags, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("%s failed (exit %d) building %s:\n%s\n%s"
                           % (cmd[0], proc.returncode, source, " ".join(cmd),
                              proc.stderr))
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, {"seconds": seconds, "cached": False, "log": log}


def _build(name):
    return compile_library(CSRC_DIR / (name + ".cu"), BUILD_DIR, _nvcc,
                           NVCC_FLAGS, CSRC_DIR.glob("*.cu*"))


def load(name):
    """The ctypes library built from csrc/<name>.cu (built on first call)."""
    with _LOCK:
        if name not in _LIBS:
            lib_path, info = _build(name)
            _LIBS[name] = ctypes.CDLL(str(lib_path))
            _BUILD_INFO[name] = dict(info, path=str(lib_path))
        return _LIBS[name]


def load_all(names):
    """Build the named kernels together (one nvcc per source, started at
    once), then load each; returns {name: library}."""
    names = [n for n in names if n not in _LIBS]
    if names:
        with ThreadPoolExecutor(max_workers=len(names)) as pool:
            built = list(pool.map(_build, names))
        with _LOCK:
            for name, (lib_path, info) in zip(names, built):
                if name not in _LIBS:
                    _LIBS[name] = ctypes.CDLL(str(lib_path))
                    _BUILD_INFO[name] = dict(info, path=str(lib_path))
    return {n: _LIBS[n] for n in _LIBS}


def build_info(name):
    """{'path', 'seconds', 'cached', 'log'} of a kernel loaded in this
    process; 'log' holds nvcc's output, with the `-Xptxas -v` register and
    shared-memory lines."""
    return dict(_BUILD_INFO[name])
