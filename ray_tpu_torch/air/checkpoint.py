"""Directory-backed checkpoints.

The port's own copy of `ray_tpu/air/checkpoint.py` (which imports no
JAX; the port imports nothing of `ray_tpu`), unchanged in behaviour.

Reference: `python/ray/train/_checkpoint.py:56` — a Checkpoint is "a
directory plus a filesystem". Here the filesystem abstraction is a plain
local path (shared-filesystem or per-node session dir); cloud filesystems
can layer in behind the same path string later. Convenience dict round-trip
helpers cover the common "small state" case; array checkpoints of a tensor
tree go through `ray_tpu_torch.train.array_checkpoint` (per-process shard
files + index, in the JAX package's format).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional


class Checkpoint:
    """An immutable reference to a checkpoint directory."""

    _METADATA_FILE = ".metadata.json"
    _DICT_FILE = "_dict_checkpoint.pkl"

    # Lifecycle hints consumed by train/tune sessions (not user API):
    # _persisted — already in durable trial storage, pass by reference;
    # _temp_source — staged in a throwaway tempdir, delete after persist.
    _persisted = False
    _temp_source = False

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    def __repr__(self) -> str:
        return f"Checkpoint(path={self.path!r})"

    # -- construction ------------------------------------------------------

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"not a directory: {path}")
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any],
                  base_dir: Optional[str] = None) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="ckpt_", dir=base_dir)
        with open(os.path.join(d, cls._DICT_FILE), "wb") as f:
            pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
        ckpt = cls(d)
        # The tempdir exists only to carry this data to a persist step;
        # sessions reclaim it after copying (session._persist_checkpoint).
        ckpt._temp_source = True
        return ckpt

    # -- access ------------------------------------------------------------

    @contextmanager
    def as_directory(self) -> Iterator[str]:
        """Yield a local directory containing the checkpoint files."""
        yield self.path

    def to_directory(self, path: Optional[str] = None) -> str:
        dest = path or tempfile.mkdtemp(prefix="ckpt_copy_")
        os.makedirs(dest, exist_ok=True)
        for name in os.listdir(self.path):
            src = os.path.join(self.path, name)
            dst = os.path.join(dest, name)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
        return dest

    def to_dict(self) -> Dict[str, Any]:
        p = os.path.join(self.path, self._DICT_FILE)
        if not os.path.exists(p):
            raise ValueError(
                f"{self.path} was not created via Checkpoint.from_dict")
        with open(p, "rb") as f:
            return pickle.load(f)

    # -- metadata ----------------------------------------------------------

    def set_metadata(self, metadata: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, self._METADATA_FILE), "w") as f:
            json.dump(metadata, f)

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, self._METADATA_FILE)
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    def update_metadata(self, metadata: Dict[str, Any]) -> None:
        merged = self.get_metadata()
        merged.update(metadata)
        self.set_metadata(merged)


def _new_checkpoint_dir(base: str, index: int) -> str:
    d = os.path.join(base, f"checkpoint_{index:06d}_{uuid.uuid4().hex[:6]}")
    os.makedirs(d, exist_ok=True)
    return d
