"""Work-dir staging for the pipeline: ``run --bucket_dir``.

Counterpart of hygeia_tpu/utils/staging.py. ``WorkdirMirror`` mirrors a
run's output tree (stage outputs and ``.done`` markers) to a store after
every completed stage and restores it before a resumed run, so a fresh
machine resumes where another left off. The semantics are the JAX
module's:

* uploads are incremental by (size, mtime): a sync walks the tree and
  sends only new or changed files;
* a restore first snapshots the local ``.done*`` markers, then fetches
  every bucket file, except a local file of the bucket copy's size whose
  stage directory (or a parent) held a marker before the restore began: a
  stale local file of equal size in an unfinished stage is fetched again.

Stores. A plain path or a ``file://`` URL is a local directory, handled
with ``os`` and ``shutil`` and no import of ``fsspec``. Any other scheme
(``s3://``, ``gs://``, ...) goes through ``fsspec``, imported only then;
without it the mirror raises and names the scheme. Nothing falls back to a
local copy.
"""

from __future__ import annotations

import os
import posixpath
import re
import shutil
from pathlib import Path

_SCHEME = re.compile(r"^([A-Za-z][A-Za-z0-9+.-]*)://")


class _LocalStore:
    """The subset of fsspec's filesystem interface the mirror uses, on a
    local directory."""

    def exists(self, path):
        return os.path.exists(path)

    def find(self, path):
        """Every file under ``path``, sorted (fsspec's ``find``)."""
        out = []
        for dirpath, _dirs, files in os.walk(path):
            out += [posixpath.join(Path(dirpath).as_posix(), f) for f in files]
        return sorted(out)

    def info(self, path):
        return {"size": os.stat(path).st_size}

    def get_file(self, rpath, lpath):
        shutil.copyfile(rpath, lpath)

    def put_file(self, lpath, rpath):
        shutil.copyfile(lpath, rpath)

    def makedirs(self, path, exist_ok=False):
        os.makedirs(path, exist_ok=exist_ok)


def open_store(url):
    """(store, base path) for a bucket URL: a local directory for plain
    paths and ``file://``, else an fsspec filesystem."""
    url = str(url)
    m = _SCHEME.match(url)
    scheme = m.group(1).lower() if m else "file"
    if scheme == "file":
        local = url[len(m.group(0)):] if m else url
        return _LocalStore(), Path(os.path.abspath(local)).as_posix()
    try:
        import fsspec
    except ImportError as e:
        raise RuntimeError(
            f"--bucket_dir {url}: the {scheme}:// scheme needs the fsspec package, which is not "
            "installed (plain paths and file:// need nothing)"
        ) from e
    fs, base = fsspec.core.url_to_fs(url)
    return fs, str(base)


class WorkdirMirror:
    """Incremental two-way mirror between a local results tree and a URL."""

    def __init__(self, url):
        self.fs, base = open_store(url)
        self.base = base.rstrip("/")
        # (size, mtime) of files known synced, keyed by tree-relative path.
        self._seen: dict[str, tuple[int, float]] = {}

    def _rpath(self, rel: str) -> str:
        return posixpath.join(self.base, rel) if rel else self.base

    def restore(self, root) -> int:
        """Fetch the mirrored tree into ``root``; returns the number of
        files fetched. A local file is kept only when its size matches the
        bucket copy AND its stage directory held a local ``.done*`` marker
        before the restore began (bucket mtimes are not comparable with
        local ones, so the marker is the trust signal)."""
        root = Path(root)
        if not self.fs.exists(self.base):
            return 0
        # The bucket mirrors markers too: restoring one ahead of its stage's
        # files must not make them trusted mid-restore, hence the snapshot.
        done_dirs = {p.parent for p in root.rglob(".done*")} if root.is_dir() else set()

        def _stage_done_locally(dst: Path) -> bool:
            d = dst.parent
            while True:
                if d in done_dirs:
                    return True
                if d == root or d.parent == d:
                    return False
                d = d.parent

        fetched = 0
        for rpath in self.fs.find(self.base):
            rel = rpath[len(self.base):].lstrip("/")
            if not rel:
                continue
            dst = root / rel
            size = self.fs.info(rpath).get("size")
            if dst.is_file() and dst.stat().st_size == size and _stage_done_locally(dst):
                st = dst.stat()
                self._seen[rel] = (st.st_size, st.st_mtime)
                continue
            dst.parent.mkdir(parents=True, exist_ok=True)
            self.fs.get_file(rpath, str(dst))
            st = dst.stat()
            self._seen[rel] = (st.st_size, st.st_mtime)
            fetched += 1
        return fetched

    def sync_up(self, root) -> int:
        """Upload the files under ``root`` that are new or changed since the
        last sync or restore; returns the number uploaded."""
        root = Path(root)
        uploaded = 0
        made_dirs: set[str] = set()
        for p in sorted(root.rglob("*")):
            if not p.is_file():
                continue
            rel = p.relative_to(root).as_posix()
            st = p.stat()
            sig = (st.st_size, st.st_mtime)
            if self._seen.get(rel) == sig:
                continue
            parent = posixpath.dirname(self._rpath(rel))
            if parent and parent not in made_dirs:
                self.fs.makedirs(parent, exist_ok=True)
                made_dirs.add(parent)
            self.fs.put_file(str(p), self._rpath(rel))
            self._seen[rel] = sig
            uploaded += 1
        return uploaded
