"""Two-tier checkpoints and restart, in the reference's on-disk format.

Tier 1 is a frequent ring of fast local snapshots (``tier1_keep`` of
them), tier 2 an infrequent durable copy. A snapshot is a directory
``step_%08d`` of ``leaf_%05d.npy`` files, one a leaf of the state in JAX's
pytree order (:mod:`repro_torch.training.tree`), and a ``manifest.json``
with each leaf's shape, dtype and the CRC32 of its bytes; it is written
to ``<dir>.tmp`` and published by a rename. Restore takes the newest
valid snapshot across both tiers (tier 1 on a tie) and falls back past
one whose manifest, leaf count or checksums do not hold.

The files are the reference's (``repro.training.checkpoint``) byte for
byte: a bf16 leaf is a 2-byte void ``.npy`` (``'<V2'``, as numpy saves
``ml_dtypes.bfloat16``) with manifest dtype ``"bfloat16"``, written and
read with numpy alone. A checkpoint written by either package restores
in the other.

Elastic restores, as the reference's: leaves are saved in the global
view, so a checkpoint taken on one mesh restores onto any other mesh or
onto one card. Under a mesh a leaf of the tree may be a callable that
returns the global leaf (a gather across the ranks, every rank calling
it), and only the rank that ``write`` s writes it
(:func:`repro_torch.launch.spmd.save_sharded_checkpoint`); the restored
global tree is then cut for the target mesh
(:func:`repro_torch.launch.spmd.restore_sharded_checkpoint`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.training.tree import flatten, unflatten

__all__ = ["CheckpointConfig", "save_checkpoint", "restore_checkpoint",
           "latest_step"]


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    dir_tier1: str = "ckpt/fast"    # frequent ring (fast restart)
    dir_tier2: str = "ckpt/durable"  # infrequent durable
    tier1_every: int = 20
    tier2_every: int = 100
    tier1_keep: int = 2


def _host_array(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """The leaf's bytes as a host array and its manifest dtype name (a
    bf16 leaf as its raw 16-bit words)."""
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _write_leaf(fn: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(fn, arr)
        return
    with open(fn, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        arr.tofile(f)


def _save_tree(tree: Any, path: str, step: int, write: bool = True
               ) -> None:
    """Write ``tree``'s leaves (a callable leaf is called for its tensor,
    also when ``write`` is False: the ranks gather together)."""
    tmp = path + ".tmp"
    if write:
        os.makedirs(tmp, exist_ok=True)
    leaves, _ = flatten(tree)
    manifest = {"step": step, "n_leaves": len(leaves), "time": time.time(),
                "leaves": []}
    for i, leaf in enumerate(leaves):
        leaf = leaf() if callable(leaf) else leaf
        if not write:
            continue
        arr, dtype = _host_array(leaf)
        _write_leaf(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr, dtype)
        manifest["leaves"].append({
            "i": i, "shape": list(arr.shape), "dtype": dtype,
            "crc": zlib.crc32(arr) & 0xFFFFFFFF,
        })
    if not write:
        return
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # atomic publish


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if arr.dtype.kind == "V":  # bf16 (or another 2-byte float) as raw words
        if dtype != "bfloat16":
            raise ValueError(f"unsupported checkpoint dtype {dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _load_tree(like: Any, path: str) -> Any:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, treedef = flatten(like)
    if len(leaves) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint/model mismatch in {path}: "
                         f"{manifest['n_leaves']} leaves, expected "
                         f"{len(leaves)}")
    out = []
    for i, spec in enumerate(manifest["leaves"]):
        arr = np.load(os.path.join(path, f"leaf_{i:05d}.npy"))
        if zlib.crc32(arr) & 0xFFFFFFFF != spec["crc"]:
            raise IOError(f"checksum mismatch in {path} leaf {i}")
        out.append(_tensor(arr, spec["dtype"]).to(leaves[i].device))
    return unflatten(treedef, out)


def _valid_ckpts(d: str) -> list[tuple[int, str]]:
    if not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        p = os.path.join(d, name)
        if name.startswith("step_") and os.path.exists(
                os.path.join(p, "manifest.json")):
            try:
                out.append((int(name.split("_")[1]), p))
            except ValueError:
                continue
    return sorted(out)


def save_checkpoint(state: Any, step: int, cfg: CheckpointConfig, *,
                    write: bool = True) -> list[str]:
    """Save per tier cadence; returns the paths written. With ``write``
    False the leaves are produced (see :func:`_save_tree`) and nothing is
    written."""
    written = []
    if step % cfg.tier1_every == 0:
        p = os.path.join(cfg.dir_tier1, f"step_{step:08d}")
        _save_tree(state, p, step, write)
        written.append(p)
        # Ring eviction: keep the newest tier1_keep snapshots.
        for _, old in (_valid_ckpts(cfg.dir_tier1)[:-cfg.tier1_keep]
                       if write else ()):
            shutil.rmtree(old, ignore_errors=True)
    if step % cfg.tier2_every == 0:
        p = os.path.join(cfg.dir_tier2, f"step_{step:08d}")
        _save_tree(state, p, step, write)
        written.append(p)
    return written


def latest_step(cfg: CheckpointConfig) -> Optional[int]:
    c = _valid_ckpts(cfg.dir_tier1) + _valid_ckpts(cfg.dir_tier2)
    return max(s for s, _ in c) if c else None


def restore_checkpoint(like: Any, cfg: CheckpointConfig) -> tuple[Any, int]:
    """Newest valid checkpoint across both tiers (tier 1 preferred on a
    tie), each leaf on the device of ``like``'s; falls back to older
    snapshots if a newer one is corrupt."""
    cands = sorted(
        _valid_ckpts(cfg.dir_tier1) + _valid_ckpts(cfg.dir_tier2),
        key=lambda t: (t[0], "fast" in t[1]),
    )
    for step, path in reversed(cands):
        try:
            return _load_tree(like, path), step
        except (OSError, EOFError, ValueError, KeyError):
            continue
    raise FileNotFoundError("no valid checkpoint found")
