"""Pluggable GCS table storage (reference: `StoreClient`
`src/ray/gcs/store_client/store_client.h` with its InMemory and Redis
implementations, `{in_memory,redis}_store_client.h`).

The GCS keeps its working set in process memory; a StoreClient is the
DURABILITY backend written through at every table mutation — unlike the
periodic snapshot, a mutation is on disk before anything observes its
effects, so a GCS killed at any instant restarts with current tables.

`FileStoreClient` plays the Redis role with zero dependencies: one
directory per table, one file per key, atomic-rename writes. The
interface is the seam where an actual Redis/etcd client would slot in
(zero-egress environments get the file backend).
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Any, Dict, Optional
from urllib.parse import quote, unquote

logger = logging.getLogger(__name__)


class StoreClient:
    """Key/value-per-table durability backend."""

    def put(self, table: str, key: bytes, value: Any) -> None:
        self.put_blob(table, key, pickle.dumps(value))

    def put_blob(self, table: str, key: bytes, blob: bytes) -> None:
        """Store an already-pickled value (the GCS serializes on its
        event loop for a consistent view, then hands the blob to a
        writer thread)."""
        raise NotImplementedError

    def delete(self, table: str, key: bytes) -> None:
        raise NotImplementedError

    def get_all(self, table: str) -> Dict[bytes, Any]:
        raise NotImplementedError

    def tables(self) -> list:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStoreClient(StoreClient):
    """No durability — the default when no store is configured (kept for
    interface parity with the reference's InMemoryStoreClient)."""

    def __init__(self):
        self._tables: Dict[str, Dict[bytes, Any]] = {}

    def put_blob(self, table, key, blob):
        self._tables.setdefault(table, {})[key] = pickle.loads(blob)

    def delete(self, table, key):
        self._tables.get(table, {}).pop(key, None)

    def get_all(self, table):
        return dict(self._tables.get(table, {}))

    def tables(self):
        return list(self._tables)


class FileStoreClient(StoreClient):
    """File-per-key store: `root/<table>/<key hex>` holding the pickled
    value. Writes go through a temp file + `os.replace`, so a reader (or
    a restarting GCS) never sees a torn record."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # Migrate table dirs written by the pre-quote encoding (which
        # left ':' etc. intact): without this, a store created before
        # the reversible encoding restores every kv namespace empty —
        # 'kv:default' would be read back but fetched as 'kv%3Adefault'.
        for name in os.listdir(root):
            canon = quote(unquote(name), safe="")
            if canon != name:
                src = os.path.join(root, name)
                dst = os.path.join(root, canon)
                if not os.path.isdir(src):
                    continue
                if not os.path.exists(dst):
                    os.replace(src, dst)
                    continue
                # Mixed-version writes left BOTH dirs: merge the legacy
                # dir's key files into the canonical one (existing keys
                # win — they were written by the newer GCS) instead of
                # silently orphaning the legacy keys on restore.
                merged = 0
                for key_name in os.listdir(src):
                    path = os.path.join(src, key_name)
                    target = os.path.join(dst, key_name)
                    if (".tmp." in key_name or os.path.exists(target)):
                        # torn leftover, or superseded by a newer write
                        # in the canonical dir — either way dead data;
                        # removing it lets the legacy dir go away (a
                        # lingering dir would double-list the table)
                        os.unlink(path)
                        continue
                    os.replace(path, target)
                    merged += 1
                logger.warning(
                    "FileStoreClient: merged %d legacy key file(s) from "
                    "%r into %r (keys already present in the canonical "
                    "dir were kept)", merged, name, canon)
                try:
                    os.rmdir(src)
                except OSError:
                    pass

    def _table_dir(self, table: str) -> str:
        # Reversible path-safe encoding: tables() reconstructs kv
        # namespaces from directory names after a GCS restart, so the
        # mapping must be injective ('a/b' and 'a_b' must not collide,
        # and a namespace containing '/' must round-trip exactly).
        return os.path.join(self.root, quote(table, safe=""))

    def put_blob(self, table, key, blob):
        d = self._table_dir(table)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, key.hex())
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)

    def delete(self, table, key):
        try:
            os.unlink(os.path.join(self._table_dir(table), key.hex()))
        except FileNotFoundError:
            pass

    def get_all(self, table):
        d = self._table_dir(table)
        out: Dict[bytes, Any] = {}
        try:
            names = os.listdir(d)
        except FileNotFoundError:
            return out
        for name in names:
            if ".tmp." in name:
                continue
            try:
                with open(os.path.join(d, name), "rb") as f:
                    out[bytes.fromhex(name)] = pickle.load(f)
            except (OSError, ValueError, pickle.PickleError):
                continue  # torn leftover; atomic writes make this rare
        return out

    def tables(self):
        try:
            return [unquote(n) for n in os.listdir(self.root)
                    if os.path.isdir(os.path.join(self.root, n))]
        except FileNotFoundError:
            return []


def make_store_client(path: Optional[str]) -> Optional[StoreClient]:
    """Factory for the GCS: a path selects the file backend; None means
    no external store (snapshot-only persistence, if configured)."""
    return FileStoreClient(path) if path else None
