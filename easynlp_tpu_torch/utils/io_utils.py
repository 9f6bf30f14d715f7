"""File access for the PyTorch port.

The port's own copy of the part of easynlp_tpu/utils/io_utils.py that it
calls: a process-wide `io` object over the local filesystem (text opened as
UTF-8). A remote path (oss://, odps://) raises, as in the JAX package when
no remote backend is registered; the port has none.
"""

import os

_REMOTE = ("oss://", "odps://")


class LocalIO:
    @staticmethod
    def _local(path):
        if str(path).startswith(_REMOTE):
            raise RuntimeError("No IO backend for remote path %r: the port "
                               "reads and writes local files" % path)
        return path

    def open(self, path, mode="r", **kw):
        if "b" not in mode:
            kw.setdefault("encoding", "utf-8")
        return open(self._local(path), mode, **kw)

    def exists(self, path):
        return os.path.exists(self._local(path))

    def isdir(self, path):
        return os.path.isdir(self._local(path))

    def makedirs(self, path, exist_ok=True):
        os.makedirs(self._local(path), exist_ok=exist_ok)


io = LocalIO()
