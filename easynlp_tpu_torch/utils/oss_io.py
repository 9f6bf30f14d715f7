"""OSS IO backends for the PyTorch port (its own copy of
easynlp_tpu/utils/oss_io.py).

Capability parity: reference easynlp/utils/io_utils.py OSSIO (:279-635 —
bucket-routed open/exists/listdir/copytree over Alibaba OSS). Two layers:

- `OSSIO` — the production backend over the `oss2` SDK when it is installed
  (PAI runtime); same surface as the reference class.
- `LocalDirIO` — a directory-backed emulation for any scheme
  (`io.register("oss://test-bucket/", LocalDirIO(root))`), so the whole
  oss:// code path (datasets, checkpoints, predictor IO) is testable without
  cloud credentials — the same seam a real deployment swaps for OSSIO.
"""

import os
import shutil

from easynlp_tpu_torch.utils.io_utils import IO


class LocalDirIO(IO):
    """Maps <scheme_prefix><rest> → <root>/<rest> on the local filesystem."""

    def __init__(self, scheme_prefix, root):
        self.prefix = scheme_prefix
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _local(self, path):
        path = str(path)
        if path.startswith(self.prefix):
            path = path[len(self.prefix):]
        return os.path.join(self.root, path.lstrip("/"))

    def open(self, path, mode="r", **kw):
        local = self._local(path)
        if any(m in mode for m in ("w", "a", "+")):
            os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        if "b" not in mode:
            kw.setdefault("encoding", "utf-8")
        return open(local, mode, **kw)

    def exists(self, path):
        return os.path.exists(self._local(path))

    def isdir(self, path):
        return os.path.isdir(self._local(path))

    def isfile(self, path):
        return os.path.isfile(self._local(path))

    def listdir(self, path):
        return sorted(os.listdir(self._local(path)))

    def makedirs(self, path, exist_ok=True):
        os.makedirs(self._local(path), exist_ok=exist_ok)

    def glob(self, pattern):
        import glob as g
        hits = g.glob(self._local(pattern))
        root = os.path.join(self.root, "")
        return sorted(self.prefix + h[len(root):] for h in hits)

    def remove(self, path):
        os.remove(self._local(path))

    def rmtree(self, path):
        shutil.rmtree(self._local(path), ignore_errors=True)

    def copy(self, src, dst):
        s = self._local(src) if str(src).startswith(self.prefix) else src
        d = self._local(dst) if str(dst).startswith(self.prefix) else dst
        os.makedirs(os.path.dirname(d) or ".", exist_ok=True)
        shutil.copy(s, d)

    def copytree(self, src, dst):
        s = self._local(src) if str(src).startswith(self.prefix) else src
        d = self._local(dst) if str(dst).startswith(self.prefix) else dst
        shutil.copytree(s, d, dirs_exist_ok=True)

    def size(self, path):
        return os.path.getsize(self._local(path))


class OSSIO(IO):
    """oss2-SDK backend (reference io_utils.py:279-635). Available only
    where the SDK is installed; construction mirrors the reference's
    access_key_id/secret/hosts/buckets config string."""

    def __init__(self, access_key_id, access_key_secret, hosts, buckets):
        try:
            import oss2
        except ImportError as e:
            raise RuntimeError(
                "OSSIO needs the oss2 SDK (pip install oss2); for tests use "
                "LocalDirIO via io.register()") from e
        self.oss2 = oss2
        auth = oss2.Auth(access_key_id, access_key_secret)
        if isinstance(hosts, str):
            hosts = [hosts] * len(buckets if isinstance(buckets, list)
                                  else [buckets])
        if isinstance(buckets, str):
            buckets = [buckets]
        self.buckets = {
            name: oss2.Bucket(auth, host, name)
            for name, host in zip(buckets, hosts)}

    def _parse(self, path):
        assert str(path).startswith("oss://"), path
        rest = str(path)[len("oss://"):]
        bucket, _, key = rest.partition("/")
        return self.buckets[bucket], key

    def open(self, path, mode="r", **kw):
        import io as _io
        bucket, key = self._parse(path)
        if "r" in mode:
            data = bucket.get_object(key).read()
            return _io.BytesIO(data) if "b" in mode else \
                _io.StringIO(data.decode("utf-8"))
        if "w" in mode:
            class _Writer(_io.BytesIO if "b" in mode else _io.StringIO):
                def close(inner):
                    payload = inner.getvalue()
                    if isinstance(payload, str):
                        payload = payload.encode("utf-8")
                    bucket.put_object(key, payload)
                    super(type(inner), inner).close()
            return _Writer()
        raise ValueError("unsupported mode %r for oss://" % mode)

    def exists(self, path):
        bucket, key = self._parse(path)
        return bucket.object_exists(key) or self.isdir(path)

    def isdir(self, path):
        bucket, key = self._parse(path)
        key = key.rstrip("/") + "/"
        for _ in self.oss2.ObjectIterator(bucket, prefix=key, max_keys=1):
            return True
        return False

    def isfile(self, path):
        bucket, key = self._parse(path)
        return bucket.object_exists(key)

    def listdir(self, path):
        bucket, key = self._parse(path)
        key = key.rstrip("/") + "/"
        names = set()
        for obj in self.oss2.ObjectIterator(bucket, prefix=key,
                                            delimiter="/"):
            name = obj.key[len(key):].rstrip("/")
            if name:
                names.add(name)
        return sorted(names)

    def makedirs(self, path, exist_ok=True):
        pass  # object stores have no directories

    def remove(self, path):
        bucket, key = self._parse(path)
        bucket.delete_object(key)

    def rmtree(self, path):
        bucket, key = self._parse(path)
        key = key.rstrip("/") + "/"
        for obj in self.oss2.ObjectIterator(bucket, prefix=key):
            bucket.delete_object(obj.key)

    def copy(self, src, dst):
        with self.open(src, "rb") as fin, self.open(dst, "wb") as fout:
            fout.write(fin.read())

    def copytree(self, src, dst):
        for name in self.listdir(src):
            self.copy(src.rstrip("/") + "/" + name,
                      dst.rstrip("/") + "/" + name)

    def size(self, path):
        bucket, key = self._parse(path)
        return bucket.head_object(key).content_length

    def glob(self, pattern):
        raise NotImplementedError("oss glob: list with prefixes instead")
