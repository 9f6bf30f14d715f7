"""File access for the PyTorch port.

The port's own copy of easynlp_tpu/utils/io_utils.py: an `IO` interface, the
local filesystem backend (`DefaultIO`, text opened as UTF-8) and a
process-wide `io` object that routes a path by its prefix to a backend
registered with `io.register(prefix, backend)` (utils/oss_io.py's
`LocalDirIO` and `OSSIO`), and everything else to the local filesystem. A
remote path (oss://, odps://) with no backend registered raises.
"""

import glob as glob_module
import os
import shutil

_REMOTE = ("oss://", "odps://")


class IO:
    """The interface every backend implements; paths are strings."""

    def open(self, path, mode="r", **kw):
        raise NotImplementedError

    def exists(self, path):
        raise NotImplementedError

    def isdir(self, path):
        raise NotImplementedError

    def isfile(self, path):
        raise NotImplementedError

    def listdir(self, path):
        raise NotImplementedError

    def makedirs(self, path, exist_ok=True):
        raise NotImplementedError

    def glob(self, pattern):
        raise NotImplementedError

    def remove(self, path):
        raise NotImplementedError

    def rmtree(self, path):
        raise NotImplementedError

    def copy(self, src, dst):
        raise NotImplementedError

    def copytree(self, src, dst):
        raise NotImplementedError

    def size(self, path):
        raise NotImplementedError


class DefaultIO(IO):
    """The local filesystem."""

    def open(self, path, mode="r", **kw):
        if "b" not in mode:
            kw.setdefault("encoding", "utf-8")
        return open(path, mode, **kw)

    def exists(self, path):
        return os.path.exists(path)

    def isdir(self, path):
        return os.path.isdir(path)

    def isfile(self, path):
        return os.path.isfile(path)

    def listdir(self, path):
        return sorted(os.listdir(path))

    def makedirs(self, path, exist_ok=True):
        os.makedirs(path, exist_ok=exist_ok)

    def glob(self, pattern):
        return sorted(glob_module.glob(pattern))

    def remove(self, path):
        os.remove(path)

    def rmtree(self, path):
        shutil.rmtree(path, ignore_errors=True)

    def copy(self, src, dst):
        shutil.copy(src, dst)

    def copytree(self, src, dst):
        shutil.copytree(src, dst, dirs_exist_ok=True)

    def size(self, path):
        return os.path.getsize(path)


class CompositeIO(IO):
    """Routes a path to the backend registered for its prefix, else to the
    local filesystem; a remote path with no backend raises."""

    def __init__(self):
        self.local = DefaultIO()
        self.backends = {}

    def register(self, prefix, backend):
        self.backends[prefix] = backend

    def _route(self, path):
        for prefix, backend in self.backends.items():
            if str(path).startswith(prefix):
                return backend
        if str(path).startswith(_REMOTE):
            raise RuntimeError(
                "No IO backend registered for remote path %r (register one "
                "with io.register(prefix, backend))" % path)
        return self.local

    def open(self, path, mode="r", **kw):
        return self._route(path).open(path, mode, **kw)

    def exists(self, path):
        return self._route(path).exists(path)

    def isdir(self, path):
        return self._route(path).isdir(path)

    def isfile(self, path):
        return self._route(path).isfile(path)

    def listdir(self, path):
        return self._route(path).listdir(path)

    def makedirs(self, path, exist_ok=True):
        return self._route(path).makedirs(path, exist_ok=exist_ok)

    def glob(self, pattern):
        return self._route(pattern).glob(pattern)

    def remove(self, path):
        return self._route(path).remove(path)

    def rmtree(self, path):
        return self._route(path).rmtree(path)

    def copy(self, src, dst):
        src_io, dst_io = self._route(src), self._route(dst)
        if src_io is dst_io:
            return src_io.copy(src, dst)
        with src_io.open(src, "rb") as fin, dst_io.open(dst, "wb") as fout:
            shutil.copyfileobj(fin, fout)

    def copytree(self, src, dst):
        return self._route(src).copytree(src, dst)

    def size(self, path):
        return self._route(path).size(path)


io = CompositeIO()
