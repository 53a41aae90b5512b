"""Atomic checkpoints with a manifest and resume from the latest, the
counterpart of ``repro/training/checkpoint.py``, in its layout:

    ckpt_dir/
      step_00000100/
        manifest.json       # step, time, arrays' shapes and dtypes, and the
                            # caller's metadata (the data position)
        arrays.npz          # flattened path -> array
      LATEST                # the last durable step directory's name

A save writes ``step_XXXXXXXX.tmp`` and renames it into place with
``os.replace``, so a crash mid-write never corrupts a durable checkpoint,
and keeps the last ``keep`` steps.  numpy has no bfloat16: a bf16 tensor
is stored through an ``int16`` view of its bits and the manifest records
``bfloat16`` as its dtype.  One process writes everything.

Elastic: a save from the ranks of a mesh (``placement=``, a
``sharding.partition.Placement``) gathers each leaf's shards over both
axes and rank 0 writes the same files, in the same layout and dtypes, as
a one-device save of the same state; a restore with ``placement=`` slices
each full array by that placement's mesh, whatever mesh wrote it.  The
tree's leaves are keyed ``<part>/<parameter name>``.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "/"))
        else:
            out[name] = val
    return out


def _unflatten_into(template: Mapping, arrays: Dict[str, Any], prefix: str = "") -> Dict:
    out = {}
    for key, val in template.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out[key] = _unflatten_into(val, arrays, name + "/")
        elif name not in arrays:
            raise KeyError(f"checkpoint missing array {name!r}")
        else:
            out[key] = arrays[name]
    return out


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array stored, the dtype the manifest records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _name(key: str) -> str:
    """The parameter name of a flattened leaf key ``<part>/<name>``."""
    return key.split("/", 1)[-1]


def save(ckpt_dir: str, step: int, tree: Mapping, *, metadata: Optional[Dict] = None,
         keep: int = 3, placement=None) -> str:
    """Atomically persist ``tree`` (nested dicts of tensors or arrays) for
    ``step``; returns the final directory.  With ``placement`` every rank
    of its mesh calls this with its shards; rank 0 writes the whole
    arrays and the others wait for it."""
    if placement is not None:
        flat = {}
        for key, leaf in _flatten(tree).items():  # every rank gathers; rank 0 keeps
            full = placement.gather(_name(key), leaf)
            if placement.mesh.rank == 0:
                flat[key] = full
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        if placement.mesh.rank == 0:
            save(ckpt_dir, step, flat, metadata=metadata, keep=keep)
        placement.mesh.barrier()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    host, dtypes = {}, {}
    for key, leaf in _flatten(tree).items():
        host[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    manifest = {
        "step": step,
        "time": time.time(),
        "process_count": 1,
        "arrays": {k: {"shape": list(v.shape), "dtype": dtypes[k]} for k, v in host.items()},
    }
    manifest.update(metadata or {})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"), os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step ``LATEST`` names, if its directory exists (a ``.tmp`` left
    by a crash is never named)."""
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, template: Mapping, *, step: Optional[int] = None,
            device="cpu", placement=None) -> Tuple[Dict, Dict]:
    """Load a checkpoint (the latest by default) into ``template``'s
    structure, each leaf a tensor on ``device`` in the dtype it was saved
    in (with ``placement``, the rank's slice of it); returns (tree,
    manifest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    def place(key, arr):
        if placement is not None:
            arr = np.ascontiguousarray(placement.slice(_name(key), arr))
        return _from_numpy(arr, manifest["arrays"][key]["dtype"], device)

    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = {k: place(k, z[k]) for k in z.files}
    return _unflatten_into(template, arrays), manifest
