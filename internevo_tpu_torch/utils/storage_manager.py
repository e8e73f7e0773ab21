"""Storage manager: URI-prefixed backends with async upload (a copy of
``internevo_tpu/utils/storage_manager.py``, which imports no JAX; the port
imports nothing of that package).

Parity: reference ``internlm/utils/storage_manager.py`` — ``StorageManager``
(:984) with ``local:``, ``boto3:s3://``, ``volc:vc://``, ``oss2:ali://``
backends, async upload via tmp staging + thread pool (:1002-1021), md5
integrity for async uploads (:304), and a ``wait()`` barrier before the next
save (:1136+).

The cloud backends run against a filesystem-emulated object store (bucket ->
directory under ``IEVO_OBJECT_STORE_ROOT``): the URI routing, async staging,
upload queue and md5 verification all execute for real; only the wire
protocol is replaced.  Without the variable the cloud backends raise.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import shutil
import tempfile
from typing import Optional

from .logger import get_logger

logger = get_logger(__name__)


class LocalClient:
    @staticmethod
    def load(path: str):
        import pickle

        with open(path, "rb") as f:
            return pickle.load(f)

    @staticmethod
    def save(path: str, obj):
        import pickle

        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(obj, f)

    @staticmethod
    def assert_fp_exists(path: str):
        assert os.path.exists(path), path

    @staticmethod
    def get_fns(path: str):
        return os.listdir(path) if os.path.isdir(path) else []

    @staticmethod
    def delete_obj(path: str):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)


def _unsupported(backend: str):
    raise NotImplementedError(
        f"storage backend '{backend}' has no credentials in this zero-egress "
        f"environment; set IEVO_OBJECT_STORE_ROOT to run it against the "
        f"filesystem-emulated object store, or use 'local:' paths"
    )


class ObjectStoreClient:
    """Emulated boto3/volc/oss2 client: bucket/key -> file under a root dir.

    Mirrors the reference clients' behavior (``storage_manager.py:304,:984-1135``):
    uploads are staged (serialize to tmp, then 'upload'), an md5 sidecar is
    written with each object and verified on download.
    """

    SCHEMES = {"boto3": "s3://", "volc": "vc://", "oss2": "ali://"}

    def __init__(self, backend: str):
        root = os.environ.get("IEVO_OBJECT_STORE_ROOT")
        if root is None:
            _unsupported(backend)
        self.backend = backend
        self.root = os.path.join(root, backend)

    def _object_path(self, rest: str) -> str:
        scheme = self.SCHEMES[self.backend]
        if not rest.startswith(scheme):
            raise ValueError(f"{self.backend}: expected '{scheme}…', got {rest!r}")
        return os.path.join(self.root, rest[len(scheme):])

    @staticmethod
    def _md5(path: str) -> str:
        h = hashlib.md5()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()

    def _verify_md5(self, src: str, rest: str):
        """Check an object against its sidecar (no-op when none exists)."""
        md5_fp = src + ".md5"
        if os.path.exists(md5_fp):
            expect = open(md5_fp).read().strip()
            actual = self._md5(src)
            if actual != expect:
                raise IOError(f"md5 mismatch for {rest}: {actual} != {expect}")

    def upload(self, staged_file: str, rest: str):
        try:
            dst = self._object_path(rest)
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(staged_file, dst)
            with open(dst + ".md5", "w") as f:
                f.write(self._md5(dst))
        finally:
            # staged files must not accumulate in /dev/shm on failed uploads
            if os.path.exists(staged_file):
                os.remove(staged_file)

    def load(self, rest: str):
        import pickle

        src = self._object_path(rest)
        self._verify_md5(src, rest)
        with open(src, "rb") as f:
            return pickle.load(f)

    def get_fns(self, rest: str):
        d = self._object_path(rest)
        return [fn for fn in LocalClient.get_fns(d) if not fn.endswith(".md5")]

    def delete_obj(self, rest: str):
        LocalClient.delete_obj(self._object_path(rest))
        LocalClient.delete_obj(self._object_path(rest) + ".md5")

    # raw-file transfer (orbax checkpoint trees are opaque bytes, not pickles)

    def upload_file(self, local_file: str, rest: str):
        """Raw local file -> object (+ md5 sidecar); the SOURCE is kept (tree
        uploads walk a staging dir the caller disposes of as a whole)."""
        dst = self._object_path(rest)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(local_file, dst)
        with open(dst + ".md5", "w") as f:
            f.write(self._md5(dst))

    def download_file(self, rest: str, local_file: str):
        """Object -> raw local file, md5-verified when a sidecar exists."""
        src = self._object_path(rest)
        self._verify_md5(src, rest)
        os.makedirs(os.path.dirname(local_file) or ".", exist_ok=True)
        shutil.copyfile(src, local_file)

    def walk(self, rest: str):
        """Relative keys of every object under the prefix (recursive, md5
        sidecars excluded) — the reference's paginated list_objects scan."""
        base = self._object_path(rest)
        out = []
        for root, _dirs, files in os.walk(base):
            for fn in files:
                if fn.endswith(".md5"):
                    continue
                out.append(os.path.relpath(os.path.join(root, fn), base))
        return out


def _move_staged(staged: str, dst: str):
    """Publish a staged pickle to its local destination; staged file removed."""
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    try:
        shutil.move(staged, dst)
    finally:
        if os.path.exists(staged):
            os.unlink(staged)


class StorageManager:
    """Routes URI-prefixed paths (``local:/path``, ``boto3:s3://..`` etc.) and
    runs async uploads on a small thread pool.

    Async cloud saves follow the reference's two-phase protocol
    (:1002-1021): serialize synchronously into the staging folder
    (``/dev/shm`` when available), enqueue the upload, ``wait()`` barriers
    before the next save.
    """

    BACKENDS = ("local", "boto3", "volc", "oss2")

    def __init__(self, enable_save: bool = True, async_upload: bool = True,
                 async_upload_tmp_folder: Optional[str] = None):
        self.enable_save = enable_save
        self.async_upload = async_upload
        self.tmp_folder = async_upload_tmp_folder or (
            "/dev/shm/ievo_staging" if os.path.isdir("/dev/shm") else
            os.path.join(tempfile.gettempdir(), "ievo_staging"))
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=4) if async_upload else None
        self._futures: list[concurrent.futures.Future] = []
        self._clients: dict[str, ObjectStoreClient] = {}

    @staticmethod
    def _parse(path: str) -> tuple[str, str]:
        if ":" in path and path.split(":", 1)[0] in StorageManager.BACKENDS:
            backend, rest = path.split(":", 1)
            return backend, rest
        return "local", path

    def _client(self, backend: str) -> ObjectStoreClient:
        if backend not in self._clients:
            self._clients[backend] = ObjectStoreClient(backend)
        return self._clients[backend]

    def _stage(self, obj) -> str:
        import pickle

        os.makedirs(self.tmp_folder, exist_ok=True)
        fd, fp = tempfile.mkstemp(dir=self.tmp_folder, suffix=".staged")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(obj, f)
        return fp

    def save(self, path: str, obj, async_upload: Optional[bool] = None):
        backend, fp = self._parse(path)
        use_async = self.async_upload if async_upload is None else async_upload
        if backend == "local":
            if use_async and self._pool is not None:
                # serialize NOW (two-phase protocol): pickling on the worker
                # thread would capture post-save mutations of the live object
                staged = self._stage(obj)
                self._futures.append(self._pool.submit(_move_staged, staged, fp))
            else:
                LocalClient.save(fp, obj)
            return
        client = self._client(backend)
        staged = self._stage(obj)  # serialize NOW; upload later (ref :1002-1021)
        if use_async and self._pool is not None:
            self._futures.append(self._pool.submit(client.upload, staged, fp))
        else:
            client.upload(staged, fp)

    def load(self, path: str):
        backend, fp = self._parse(path)
        if backend == "local":
            return LocalClient.load(fp)
        return self._client(backend).load(fp)

    def get_fns(self, path: str):
        backend, fp = self._parse(path)
        if backend == "local":
            return LocalClient.get_fns(fp)
        return self._client(backend).get_fns(fp)

    def delete_obj(self, path: str):
        backend, fp = self._parse(path)
        if backend == "local":
            LocalClient.delete_obj(fp)
        else:
            self._client(backend).delete_obj(fp)

    # directory trees (orbax checkpoints routed to object-store backends)

    def upload_dir(self, local_dir: str, path: str):
        """Upload a whole local directory tree to ``path`` (URI prefix).
        Synchronous — checkpoint finalization barriers on it before writing
        the completeness stamp.  Local backend: plain tree copy."""
        backend, prefix = self._parse(path)
        if backend == "local":
            shutil.copytree(local_dir, prefix, dirs_exist_ok=True)
            return
        client = self._client(backend)
        for root, _dirs, files in os.walk(local_dir):
            for fn in files:
                fp = os.path.join(root, fn)
                rel = os.path.relpath(fp, local_dir)
                client.upload_file(fp, prefix.rstrip("/") + "/" + rel)

    def download_dir(self, path: str, local_dir: str) -> str:
        """Fetch a URI-prefixed tree into ``local_dir`` and return the local
        root to read from.  Local backend: returns the path in place."""
        backend, prefix = self._parse(path)
        if backend == "local":
            return prefix
        client = self._client(backend)
        keys = client.walk(prefix)
        if not keys:
            raise FileNotFoundError(f"no objects under {path}")
        for rel in keys:
            client.download_file(prefix.rstrip("/") + "/" + rel,
                                 os.path.join(local_dir, rel))
        return local_dir

    def walk(self, path: str):
        """Recursive relative keys under a URI prefix (both backends)."""
        backend, prefix = self._parse(path)
        if backend == "local":
            out = []
            for root, _dirs, files in os.walk(prefix):
                for fn in files:
                    out.append(os.path.relpath(os.path.join(root, fn), prefix))
            return out
        return self._client(backend).walk(prefix)

    def put_text(self, path: str, text: str):
        """Write a small text object (the ``.step`` completeness stamp)."""
        backend, fp = self._parse(path)
        if backend == "local":
            os.makedirs(os.path.dirname(fp) or ".", exist_ok=True)
            with open(fp, "w") as f:
                f.write(text)
            return
        os.makedirs(self.tmp_folder, exist_ok=True)
        fd, staged = tempfile.mkstemp(dir=self.tmp_folder, suffix=".stamp")
        with os.fdopen(fd, "w") as f:
            f.write(text)
        try:
            self._client(backend).upload_file(staged, fp)
        finally:
            os.remove(staged)

    def wait(self):
        """Barrier: block until all queued async uploads finish (ref :1136+).
        Drains the queue even when an upload failed (a stale future must not
        re-raise on every later barrier); the first error propagates."""
        futs, self._futures = self._futures, []
        first_err = None
        for fut in futs:
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 - collect, re-raise first
                first_err = first_err or e
        if first_err is not None:
            raise first_err


_storage_manager: Optional[StorageManager] = None


def init_storage_manager(enable_save: bool = True, async_upload: bool = True,
                         async_upload_tmp_folder: Optional[str] = None) -> StorageManager:
    global _storage_manager
    _storage_manager = StorageManager(enable_save, async_upload, async_upload_tmp_folder)
    return _storage_manager


def get_storage_manager() -> StorageManager:
    global _storage_manager
    if _storage_manager is None:
        _storage_manager = StorageManager()
    return _storage_manager


def llm_save(path: str, obj, **kwargs):
    get_storage_manager().save(path, obj, **kwargs)


def llm_load(path: str, **kwargs):
    return get_storage_manager().load(path)
