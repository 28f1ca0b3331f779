"""Array checkpoints of a tree of torch tensors, in the JAX package's
format.

Port of `ray_tpu/train/array_checkpoint.py` (`save_sharded`,
`restore_sharded`, `is_sharded_checkpoint`, `is_usable`,
`save_to_checkpoint`). The on-disk format is the same, so a checkpoint
written by either package restores bit-identically in the other:

  * each tensor leaf contributes its shards to ``asv_data.<proc>.npz``,
    stored as raw ``uint8`` views so that bfloat16 round-trips without an
    npy dtype for it;
  * non-tensor leaves (Python scalars, numpy arrays) are pickled by
    process 0 into ``asv_host.<proc>.pkl``;
  * ``asv_index.<proc>.json`` is written LAST, atomically: its presence
    marks the process's contribution complete, which `is_usable` checks;
  * leaves are named by their path in JAX's ``keystr`` form
    (``['params']['wte']``, ``[0]``) over dicts (sorted keys), lists and
    tuples, in `jax.tree_util`'s flattening order; None is an empty
    subtree.

Save records the process as ``torch.distributed``'s rank of its world
(0 of 1 when no process group is initialised). A plain tensor leaf is a
replicated value (a data-parallel carry), so process 0 writes it whole
(one shard) and every other process writes the leaf's record with no
shards. A DTensor leaf is sharded over the port's device mesh: each
process writes its local shard with its global index, the offsets by
DTensor's own split rule (uneven splits included), and only if its
coordinate is 0 on every mesh dimension where the leaf is `Replicate`,
so that each distinct block is written once: the JAX package's
``replica_id == 0`` rule. Host values are saved by process 0 only.
`is_usable` then sees one index per process, as it does for the JAX
package's multi-process checkpoints. Restore reads every index
(the rank-0 directory and ``<dir>_shards/rank_*``) and assembles each
leaf from whatever shard grid was saved, in numpy, so it also reads the
multi-rank checkpoints the JAX package writes. It returns NEW tensors on
the device of each ``like`` leaf; for a DTensor ``like`` leaf, a DTensor
with its placements whose local shard is this rank's block of the saved
value, read from whatever grid was saved (no collective: each rank
reads the files). To resume a runner whose step is a
captured CUDA graph, ``copy_`` them into the live carry (as
``load_state_dict`` does): the graph holds the carry's addresses, and a
carry in other storages would not be accepted by the next replay.

Torch is imported where a function first touches a tensor: `is_usable`
and `is_sharded_checkpoint`, which the train controller calls, run
without it.
"""

from __future__ import annotations

import functools
import glob as glob_mod
import json
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

_INDEX_FMT = "asv_index.{proc}.json"
_DATA_FMT = "asv_data.{proc}.npz"
_HOST_FMT = "asv_host.{proc}.pkl"
_FORMAT_VERSION = 1

# dtype names as JAX writes them (torch's dtype names without "torch.")
_DTYPES = ("bool", "uint8", "int8", "int16", "int32", "int64", "float16",
           "bfloat16", "float32", "float64")


@functools.lru_cache(maxsize=None)
def _dtype_names() -> Dict[Any, str]:
    """torch dtype -> its name as JAX writes it."""
    import torch

    return {getattr(torch, name): name for name in _DTYPES}


def _dtype_name(dtype) -> str:
    name = _dtype_names().get(dtype)
    if name is None:
        raise TypeError(f"array checkpoint: unsupported dtype {dtype}")
    return name


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf's bytes are assembled in: the dtype itself,
    or for bfloat16 (which numpy lacks) int16, whose bits a torch view
    turns back into bfloat16."""
    if name == "bfloat16":
        return np.dtype(np.int16)
    return np.dtype(name)


def _to_torch(arr: np.ndarray, name: str, device):
    import torch

    t = torch.from_numpy(arr)
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _to_numpy(t) -> np.ndarray:
    import torch

    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _keystr(path: Tuple[Any, ...]) -> str:
    """`jax.tree_util.keystr`: ``[repr(key)]`` per dict key, ``[i]`` per
    sequence index."""
    return "".join(f"[{p!r}]" if isinstance(p, str) else f"[{p}]"
                   for p in path)


def _leaves_with_paths(tree, path=()) -> List[Tuple[str, Any]]:
    """(keystr, leaf) in `_flatten`'s (JAX's) order."""
    if type(tree) in (tuple, list):
        return [kv for i, x in enumerate(tree)
                for kv in _leaves_with_paths(x, path + (i,))]
    if type(tree) is dict:
        return [kv for k in sorted(tree)
                for kv in _leaves_with_paths(tree[k], path + (k,))]
    if tree is None:
        return []
    return [(_keystr(path), tree)]


def _treedef_str(struct) -> str:
    """`str(jax.tree_util.tree_structure(tree))` of a `_flatten`
    structure (recorded in the index; restore does not read it)."""
    def inner(s):
        if s is None:
            return "None"
        if isinstance(s, str):
            return "*"
        if s[0] is dict:
            return "{" + ", ".join(f"{k!r}: {inner(c)}"
                                   for k, c in zip(s[1], s[2])) + "}"
        items = ", ".join(inner(c) for c in s[1])
        if s[0] is list:
            return f"[{items}]"
        return f"({items},)" if len(s[1]) == 1 else f"({items})"
    return f"PyTreeDef({inner(struct)})"


def _norm_index(index: Sequence[slice], shape: Sequence[int]
                ) -> List[Tuple[int, int]]:
    """Normalize a shard index (tuple of slices) to explicit [start, stop)
    per dimension; dimensions the index does not mention are whole."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else sl.start
        stop = dim if sl.stop is None else sl.stop
        out.append((int(start), int(stop)))
    for dim in shape[len(out):]:
        out.append((0, int(dim)))
    return out


def _process() -> Tuple[int, int]:
    """(rank, world size) of this process's `torch.distributed` group,
    or (0, 1) when none is initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_block(leaf):
    """A DTensor leaf's (local shard, its [start, stop) per dimension) on
    this rank."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(
        leaf.shape, leaf.device_mesh, leaf.placements)
    return leaf.to_local(), [(int(o), int(o) + int(n))
                             for o, n in zip(offset, shape)]


def _own_shard(leaf, proc: int):
    """(data, index) of the block of tensor `leaf` that this process
    writes, or None: a plain tensor's whole value on process 0; a
    DTensor's local shard where this rank's mesh coordinate is 0 on every
    `Replicate` dimension (and the shard is not empty)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(leaf, DTensor):
        return (leaf, _norm_index((), leaf.shape)) if proc == 0 else None
    coord = leaf.device_mesh.get_coordinate()
    if coord is None:
        return None
    for c, p in zip(coord, leaf.placements):
        if p.is_partial():
            raise ValueError("array checkpoint: a Partial DTensor has no "
                             "value to save; reduce it first")
        if p.is_replicate() and c != 0:
            return None
    data, index = _local_block(leaf)
    if any(stop <= start for start, stop in index):
        return None
    return data, index


def save_sharded(dir_path: str, tree: Any) -> None:
    """Write THIS process's contribution of `tree` into `dir_path`.

    Every process of the group calls this with the same tree structure.
    Process 0 writes every plain tensor leaf whole and the host values;
    each process writes its own blocks of the DTensor leaves (module
    docstring). A caller with no process group saves everything as
    process 0 of 1."""
    import torch

    from ray_tpu_torch.parallel.compile_cache import _flatten

    os.makedirs(dir_path, exist_ok=True)
    proc, nproc = _process()
    index: Dict[str, Any] = {
        "format": _FORMAT_VERSION,
        "process": proc,
        "num_processes": nproc,
        "treedef": _treedef_str(_flatten(tree, [])),
        "leaves": [],
    }
    blobs: Dict[str, np.ndarray] = {}
    host_values: Dict[int, Any] = {}
    for pos, (keystr, leaf) in enumerate(_leaves_with_paths(tree)):
        if isinstance(leaf, torch.Tensor):
            shape = list(leaf.shape)
            shards_meta: List[dict] = []
            own = _own_shard(leaf, proc)
            if own is not None:
                key = f"l{pos}s0"
                # as the JAX package writes it: a 0-d leaf's shard is [1]
                data = np.ascontiguousarray(_to_numpy(own[0]))
                # flatten before the uint8 view: a 0-d array cannot change
                # itemsize in place, and the shard record keeps the shape
                blobs[key] = data.reshape(-1).view(np.uint8)
                shards_meta.append({"key": key, "index": own[1],
                                    "shape": list(data.shape)})
            index["leaves"].append({
                "pos": pos,
                "path": keystr,
                "kind": "array",
                "shape": shape,
                "dtype": _dtype_name(leaf.dtype),
                "shards": shards_meta,
            })
        else:
            index["leaves"].append({"pos": pos, "path": keystr,
                                    "kind": "host"})
            if proc == 0:
                host_values[pos] = leaf
    np.savez(os.path.join(dir_path, _DATA_FMT.format(proc=proc)), **blobs)
    if proc == 0:
        with open(os.path.join(dir_path, _HOST_FMT.format(proc=proc)),
                  "wb") as f:
            pickle.dump(host_values, f, protocol=pickle.HIGHEST_PROTOCOL)
    # the index is the commit marker: write it last, atomically
    ipath = os.path.join(dir_path, _INDEX_FMT.format(proc=proc))
    tmp = f"{ipath}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(index, f)
    os.replace(tmp, ipath)


def _checkpoint_dirs(source: Any) -> List[str]:
    """Rank-0 checkpoint dir + the sibling per-rank shard dirs."""
    path = getattr(source, "path", source)
    dirs = [path]
    dirs.extend(sorted(glob_mod.glob(path + "_shards/rank_*")))
    return [d for d in dirs if os.path.isdir(d)]


def _load_indexes(source: Any) -> List[Tuple[str, dict]]:
    out = []
    for d in _checkpoint_dirs(source):
        for ipath in sorted(glob_mod.glob(os.path.join(d,
                                                       "asv_index.*.json"))):
            with open(ipath) as f:
                out.append((d, json.load(f)))
    return out


def is_sharded_checkpoint(source: Any) -> bool:
    return bool(_load_indexes(source))


def is_usable(source: Any) -> bool:
    """True when every process's contribution is present and readable —
    the guard a restart applies before trusting a checkpoint whose
    writers may have been killed mid-persist. Checkpoints without an
    index are trusted (their single dict file is written atomically)."""
    indexes = _load_indexes(source)
    if not indexes:
        return True
    want = indexes[0][1].get("num_processes", 1)
    if len(indexes) != want:
        return False
    for d, idx in indexes:
        data_path = os.path.join(d, _DATA_FMT.format(proc=idx["process"]))
        try:
            with np.load(data_path) as z:
                have = set(z.files)
        except (OSError, ValueError):
            return False
        for leaf in idx["leaves"]:
            for sh in leaf.get("shards", ()):
                if sh["key"] not in have:
                    return False
    return True


class _ShardSource:
    """Lazily-opened npz files keyed by directory, with the merged
    per-leaf shard map built from every process's index."""

    def __init__(self, source: Any):
        self.indexes = _load_indexes(source)
        if not self.indexes:
            path = getattr(source, "path", source)
            raise FileNotFoundError(
                f"no sharded-array checkpoint found under {path!r}")
        self._npz: Dict[str, Any] = {}
        # pos -> {"meta": leaf record, "shards": [(dir, proc, record)]}
        self.leaves: Dict[int, dict] = {}
        for d, idx in self.indexes:
            for leaf in idx["leaves"]:
                ent = self.leaves.setdefault(
                    leaf["pos"], {"meta": leaf, "shards": []})
                for sh in leaf.get("shards", ()):
                    ent["shards"].append((d, idx["process"], sh))
        self.host_values: Dict[int, Any] = {}
        for d, idx in self.indexes:
            hpath = os.path.join(d, _HOST_FMT.format(proc=idx["process"]))
            if os.path.exists(hpath):
                with open(hpath, "rb") as f:
                    self.host_values.update(pickle.load(f))

    def blob(self, d: str, proc: int, key: str, shape, dtype) -> np.ndarray:
        npz_path = os.path.join(d, _DATA_FMT.format(proc=proc))
        z = self._npz.get(npz_path)
        if z is None:
            z = self._npz[npz_path] = np.load(npz_path)
        return z[key].view(dtype).reshape(shape)

    def close(self):
        for z in self._npz.values():
            z.close()


def _assemble(src: _ShardSource, pos: int, req: Sequence[slice]
              ) -> np.ndarray:
    """Materialize the requested block of leaf `pos` from whichever saved
    shards overlap it (saved and requested shard grids need not match)."""
    ent = src.leaves[pos]
    meta = ent["meta"]
    shape = meta["shape"]
    dtype = _np_dtype(meta["dtype"])
    want = _norm_index(req, shape)
    out_shape = [stop - start for start, stop in want]
    out = np.empty(out_shape, dtype=dtype)
    filled = 0
    for d, proc, sh in ent["shards"]:
        have = [(s, e) for s, e in sh["index"]]
        inter = [(max(ws, hs), min(we, he))
                 for (ws, we), (hs, he) in zip(want, have)]
        if any(s >= e for s, e in inter):
            continue
        blob = src.blob(d, proc, sh["key"], sh["shape"], dtype)
        if not shape:
            blob = blob.reshape(())  # a 0-d leaf's shard is stored as [1]
        src_sel = tuple(slice(s - hs, e - hs)
                        for (s, e), (hs, _) in zip(inter, have))
        dst_sel = tuple(slice(s - ws, e - ws)
                        for (s, e), (ws, _) in zip(inter, want))
        out[dst_sel] = blob[src_sel]
        vol = 1
        for s, e in inter:
            vol *= e - s
        filled += vol
    total = 1
    for s in out_shape:
        total *= s
    if filled != total:
        raise ValueError(
            f"sharded checkpoint leaf {meta['path']!r}: requested block "
            f"{want} only {filled}/{total} elements covered — checkpoint "
            f"incomplete (use is_usable() before restoring)")
    return out


def restore_sharded(source: Any, like: Any) -> Any:
    """Restore a tree saved by `save_sharded` (of either package).

    `source` is a checkpoint directory or an `air.Checkpoint` whose path
    is the rank-0 directory (sibling ``_shards/rank_*`` directories are
    found). `like` has the SAME structure; each tensor leaf gives the
    shape, dtype and device of the restored tensor (a new tensor, bit
    identical to what was saved); a DTensor leaf gives its mesh and
    placements too, and this rank reads only its block. A `like` leaf
    that is no tensor gets
    the saved host value, or for a saved array a numpy array (bfloat16
    as its int16 bits). Copy the result into a graphed runner's live
    carry with ``copy_`` (see the module docstring)."""
    import torch
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.compile_cache import _flatten, _unflatten

    src = _ShardSource(source)
    try:
        struct = _flatten(like, [])
        leaves_with_paths = _leaves_with_paths(like)
        n_saved = max(src.leaves) + 1 if src.leaves else 0
        n_saved = max(n_saved, (max(src.host_values) + 1)
                      if src.host_values else 0)
        if len(leaves_with_paths) != n_saved:
            raise ValueError(
                f"restore structure mismatch: checkpoint has {n_saved} "
                f"leaves, `like` has {len(leaves_with_paths)}")
        out_leaves = []
        for pos, (keystr, leaf) in enumerate(leaves_with_paths):
            ent = src.leaves.get(pos)
            if ent is None or ent["meta"]["kind"] == "host":
                out_leaves.append(src.host_values.get(pos, leaf))
                continue
            meta = ent["meta"]
            if meta["path"] != keystr:
                raise ValueError(
                    f"restore structure mismatch at leaf {pos}: saved "
                    f"{meta['path']!r} vs requested {keystr!r}")
            shape = tuple(meta["shape"])
            if hasattr(leaf, "shape") and tuple(leaf.shape) != shape:
                raise ValueError(
                    f"shape mismatch for {keystr}: saved {shape}, "
                    f"`like` has {tuple(leaf.shape)}")
            tgt_dtype = getattr(leaf, "dtype", None)
            if isinstance(leaf, torch.Tensor):
                tgt_dtype = _dtype_names().get(leaf.dtype, leaf.dtype)
            if tgt_dtype is not None and str(tgt_dtype) != meta["dtype"]:
                raise ValueError(
                    f"dtype mismatch for {keystr}: saved {meta['dtype']}, "
                    f"`like` has {tgt_dtype} — restore is bit-exact, "
                    f"cast after restoring if intended")
            if isinstance(leaf, DTensor):
                _, index = _local_block(leaf)
                block = _assemble(src, pos, tuple(slice(a, b)
                                                  for a, b in index))
                out_leaves.append(DTensor.from_local(
                    _to_torch(block, meta["dtype"], leaf.device),
                    leaf.device_mesh, leaf.placements, run_check=False,
                    shape=leaf.shape, stride=leaf.stride()))
                continue
            block = _assemble(src, pos, (slice(None),) * len(shape))
            out_leaves.append(
                _to_torch(block, meta["dtype"], leaf.device)
                if isinstance(leaf, torch.Tensor) else block)
        return _unflatten(struct, iter(out_leaves))
    finally:
        src.close()


def save_to_checkpoint(tree: Any, base_dir: Optional[str] = None):
    """Stage this process's contribution into a throwaway dir and wrap it
    as an `air.Checkpoint` ready for `train.report(checkpoint=...)` — the
    train session then persists rank 0's dir as the canonical checkpoint
    and every other rank's into the `_shards/rank_k` sibling, and
    reclaims the staging dir."""
    import tempfile

    from ray_tpu_torch.air.checkpoint import Checkpoint

    d = tempfile.mkdtemp(prefix="ackpt_", dir=base_dir)
    save_sharded(d, tree)
    ckpt = Checkpoint(d)
    ckpt._temp_source = True
    return ckpt
