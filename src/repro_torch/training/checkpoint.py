"""Fault-tolerant checkpointing, in the JAX package's layout.

- **atomic**: written to ``step_XXXXXXXX.tmp``, then renamed, so a
  preemption mid-write never corrupts the latest checkpoint;
- **integrity-checked**: ``manifest.json`` records each array's shape,
  dtype and CRC32, verified on restore before anything is handed back;
- **by logical name**: ``arrays.npz`` holds one array per leaf of the
  state tree, keyed by its path ("/"-joined dict keys; the port's
  state-dict names below ``params``), on the host, whatever device the run
  used;
- **resumable data**: the data state rides in the manifest's ``extra``;
- retention: the newest ``keep`` checkpoints stay, stale ``.tmp`` writes go.

numpy has no bfloat16: a bf16 tensor is stored as its 16 bits (uint16),
with ``"bfloat16"`` as its manifest dtype, and restored bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "CheckpointError"]


class CheckpointError(RuntimeError):
    pass


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(stored array, manifest dtype) of one leaf: a tensor or a number."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str, like) -> Any:
    if not isinstance(like, torch.Tensor):
        return type(like)(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(
    ckpt_dir: str,
    step: int,
    tree: Any,
    *,
    extra: dict | None = None,
    keep: int = 3,
) -> str:
    """Atomically write the checkpoint of ``step``: ``tree`` is a nested
    dict of tensors and numbers. Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = {}
    manifest = {"step": step, "extra": extra or {}, "arrays": {}}
    for k, leaf in _flatten(tree).items():
        a, dtype = _to_numpy(leaf)
        flat[k] = a
        manifest["arrays"][k] = {
            "shape": list(a.shape),
            "dtype": dtype,
            "crc32": zlib.crc32(np.ascontiguousarray(a).tobytes()),
        }
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    for d in os.listdir(ckpt_dir):  # stale partial writes
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, *, step: int | None = None) -> tuple[Any, dict]:
    """Restore into the structure of ``template`` (a nested dict whose
    leaves give each array's shape: tensors, or numbers); verify metadata
    and CRCs. Returns (tree of CPU tensors and numbers, extra)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise CheckpointError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out: dict = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, like in _flatten(template).items():
            if key not in manifest["arrays"]:
                raise CheckpointError(f"missing array {key!r} in checkpoint")
            meta = manifest["arrays"][key]
            arr = data[key]
            stored = "uint16" if meta["dtype"] == "bfloat16" else meta["dtype"]
            if list(arr.shape) != meta["shape"] or str(arr.dtype) != stored:
                raise CheckpointError(f"metadata mismatch for {key!r}")
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != meta["crc32"]:
                raise CheckpointError(f"CRC mismatch for {key!r} (corrupt file)")
            want = tuple(like.shape) if isinstance(like, torch.Tensor) else ()
            if tuple(arr.shape) != want:
                raise CheckpointError(
                    f"shape mismatch for {key!r}: ckpt {arr.shape} vs model {want}"
                )
            node = out
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = _from_numpy(arr, meta["dtype"], like)
    return out, manifest["extra"]
