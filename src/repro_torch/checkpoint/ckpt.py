"""Checkpoints in the JAX package's on-disk format, with its commit protocol.

A checkpoint directory holds ``manifest.json`` and one
``arrays-<uuid>.npz`` whose members ``leaf_i`` are the tree's leaves in
flatten order (a ``Ball`` is w, r, xi2, m). bfloat16 leaves are stored as a
uint16 view under dtype ``"bfloat16"``. The two packages read each other's
checkpoints.

Commit protocol: a crash at any point leaves either the previous or the new
checkpoint, never a torn mix.

  1. the arrays payload is written to a fresh, uniquely named file through
     ``.tmp`` + fsync + ``os.replace``;
  2. the manifest, which names its arrays file, is written the same way:
     that replace is the single commit point;
  3. arrays files of earlier commits are removed last.

A truncated or corrupt payload raises a ``ValueError`` naming the file.
"""
from __future__ import annotations

import json
import os
import uuid
from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import pick_device


def _flatten(tree) -> tuple[list, str]:
    """Leaves in flatten order (tuples and lists in order, dicts by sorted
    key, as the JAX package flattens them) and a description of the tree."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        desc = "{" + ", ".join(f"{k!r}: {p[1]}" for k, p in zip(keys, parts)) + "}"
    elif isinstance(tree, (tuple, list)):
        parts = [_flatten(x) for x in tree]
        inner = ", ".join(p[1] for p in parts)
        desc = f"{type(tree).__name__}({inner})" if hasattr(tree, "_fields") else f"[{inner}]"
    else:
        return [tree], "*"
    return [leaf for p in parts for leaf in p[0]], desc


def _unflatten(tree, leaves: list):
    """``tree`` with its leaves replaced, in flatten order, from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        vals = [_unflatten(x, leaves) for x in tree]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return leaves.pop(0)


def _to_numpy(x) -> tuple[np.ndarray, str]:
    """A leaf as a host array, and the dtype name the manifest records."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:  # numpy .npz cannot hold bf16
            return x.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    a = np.asarray(x)
    return a, str(a.dtype)


def save(path: str, tree, *, meta: Optional[Dict[str, Any]] = None):
    """Write ``tree`` (tensors or arrays in tuples, NamedTuples, lists,
    dicts) and ``meta`` as a checkpoint at ``path``, atomically."""
    os.makedirs(path, exist_ok=True)
    leaves, desc = _flatten(tree)
    arrays, dtypes = {}, []
    for i, x in enumerate(leaves):
        a, dt = _to_numpy(x)
        dtypes.append(dt)
        arrays[f"leaf_{i}"] = a
    arrays_file = f"arrays-{uuid.uuid4().hex[:12]}.npz"
    arrays_tmp = os.path.join(path, arrays_file + ".tmp")
    with open(arrays_tmp, "wb") as f:  # file object: savez must not append .npz
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(arrays_tmp, os.path.join(path, arrays_file))
    manifest = {
        "treedef": desc,
        "n_leaves": len(leaves),
        "dtypes": dtypes,
        "shapes": [list(a.shape) for a in arrays.values()],
        "arrays_file": arrays_file,
        "meta": meta or {},
    }
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, "manifest.json"))  # atomic commit
    for name in os.listdir(path):  # GC arrays of superseded commits
        if (
            name != arrays_file
            and name.startswith("arrays")
            and (name.endswith(".npz") or name.endswith(".tmp"))
        ):
            try:
                os.remove(os.path.join(path, name))
            except OSError:
                pass  # concurrent cleanup / permissions: orphans are harmless


def load_manifest(path: str) -> Dict[str, Any]:
    """The full manifest: treedef, n_leaves, dtypes, shapes, arrays_file, meta."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def load_meta(path: str) -> Dict[str, Any]:
    return load_manifest(path)["meta"]


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} has no torch counterpart")
    return dt


def zeros_like_manifest(manifest: Dict[str, Any], lo: int = 0, hi: Optional[int] = None,
                        *, device=None) -> list:
    """Zero tensors matching the manifest's leaf slots ``[lo:hi)``, in
    flatten order, on ``device`` (None: CUDA): a restore target built from
    the recorded shapes and dtypes."""
    dev = pick_device(device)
    return [
        torch.zeros(tuple(s), dtype=_torch_dtype(dt), device=dev)
        for s, dt in zip(manifest["shapes"][lo:hi], manifest["dtypes"][lo:hi])
    ]


def exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, "manifest.json"))


def _load_arrays(path: str, manifest: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Read every leaf now, so a torn payload fails here with a ValueError."""
    arrays_path = os.path.join(path, manifest.get("arrays_file", "arrays.npz"))
    try:
        with np.load(arrays_path) as data:
            return {name: data[name] for name in data.files}
    except Exception as e:  # BadZipFile / EOFError / zlib / OSError ...
        raise ValueError(
            f"checkpoint at {path!r}: arrays payload {arrays_path!r} is "
            f"unreadable ({type(e).__name__}: {e}) — the file is torn or "
            "corrupt; refusing to restore garbage. Restore from an older "
            "checkpoint or re-save."
        ) from e


def restore(path: str, target_tree, *, device=None):
    """Restore into the structure of ``target_tree`` (values replaced).

    Each leaf takes its target leaf's dtype, and goes to ``device`` if
    given, else to its target leaf's device.
    """
    manifest = load_manifest(path)
    dtypes = manifest["dtypes"]
    data = _load_arrays(path, manifest)
    leaves, _ = _flatten(target_tree)
    if len(leaves) != len(data):
        raise ValueError(
            f"checkpoint at {path!r} holds {len(data)} leaves but the "
            f"restore target has {len(leaves)} — the target tree's structure "
            "does not match what was saved (wrong checkpoint, or a "
            "differently-shaped restore target)"
        )
    new_leaves = []
    for i, ref in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        if dtypes[i] == "bfloat16":
            x = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            x = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))  # keeps 0-d
        dev = pick_device(device, ref)
        dt = ref.dtype if isinstance(ref, torch.Tensor) else x.dtype
        new_leaves.append(x.to(device=dev, dtype=dt))
    return _unflatten(target_tree, new_leaves)
