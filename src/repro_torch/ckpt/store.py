"""Fault-tolerant checkpointing: atomic sharded npz, async writer, resume.
The JAX package's `ckpt/store.py`, with the same layout on disk:

    <dir>/step_<N>/shard_<p>.npz     one file per host process, leaf_<i>
    <dir>/step_<N>/MANIFEST.json     step, leaf count, tree structure
    <dir>/step_<N>/COMMITTED         sentinel written LAST (atomic commit)
    <dir>/latest                     text file -> "step_<N>"

A tree is nested dicts (keys sorted, as JAX flattens them), lists, tuples
and NamedTuples of tensors; its leaves are numbered in JAX's
flatten order, so a checkpoint of the same tree written by either package
restores in the other (`convert.train_state_tree` builds the JAX layout of
a net and its optimizer state).  bf16 leaves are stored as the 2-byte void
records that numpy writes for the JAX package's bf16 arrays, and read back
by viewing those bytes as bf16 (numpy has no bf16 of its own).

A step directory without COMMITTED is ignored by `latest_step` and
removed at the next save, so a writer killed mid-flight never corrupts a
restart.  `save` copies every leaf to host memory before its writer
thread starts, so training may update the tensors in place at once;
`wait()` joins the writer.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

SENTINEL = "COMMITTED"
_BF16_BYTES = np.dtype("V2")


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, structure) in JAX's order: dict values by sorted key, list,
    tuple and NamedTuple items in order; None is an empty subtree."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, subs = [], []
        for k in keys:
            sub_leaves, sub = tree_flatten(tree[k])
            leaves += sub_leaves
            subs.append(sub)
        return leaves, ("dict", tuple(keys), tuple(subs))
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for item in tree:
            sub_leaves, sub = tree_flatten(item)
            leaves += sub_leaves
            subs.append(sub)
        kind = type(tree) if hasattr(tree, "_fields") else type(tree).__name__
        return leaves, (kind, len(tree), tuple(subs))
    return [tree], "*"


def tree_unflatten(structure: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == "*":
            return next(it)
        kind, keys_or_n, subs = s
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(keys_or_n, subs)}
        items = [build(sub) for sub in subs]
        if kind == "list":
            return items
        if kind == "tuple":
            return tuple(items)
        return kind(*items)                       # a NamedTuple class

    return build(structure)


def _structure_str(s: Any) -> str:
    if s is None:
        return "None"
    if s == "*":
        return "*"
    kind, keys_or_n, subs = s
    inner = ", ".join(_structure_str(x) for x in subs)
    if kind == "dict":
        return "{" + ", ".join(f"'{k}': {_structure_str(x)}"
                               for k, x in zip(keys_or_n, subs)) + "}"
    name = kind if isinstance(kind, str) else kind.__name__
    return f"{name}({inner})"


def to_host(leaf: torch.Tensor) -> np.ndarray:
    """A copy of the tensor in host memory; bf16 as 2-byte void records."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().copy().view(_BF16_BYTES)
    return t.cpu().numpy().copy()


def from_host(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """`arr` in the dtype and on the device of `like`; 2-byte void records
    are bf16 bytes."""
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {arr.shape} for a "
                         f"tensor of shape {tuple(like.shape)}")
    if arr.dtype == _BF16_BYTES:
        t = torch.from_numpy(np.asarray(arr, order="C").view(np.int16)) \
            .view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(arr, order="C"))
    return t.to(device=like.device, dtype=like.dtype)


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3, process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.proc = process_index
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = False) -> None:
        """Snapshot `tree` for `step`.  Device tensors are copied to host
        memory before the writer thread starts, so training can update
        them while the write happens."""
        self.wait()
        leaves, structure = tree_flatten(tree)
        host_leaves = [to_host(l) for l in leaves]
        manifest = {
            "step": step,
            "n_leaves": len(host_leaves),
            "treedef": _structure_str(structure),
        }

        def write():
            path = os.path.join(self.dir, f"step_{step}")
            tmp = path + f".tmp_{self.proc}"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, f"shard_{self.proc}.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
            # atomic commit: rename, then the sentinel, then latest
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            with open(os.path.join(path, SENTINEL), "w") as f:
                f.write("ok")
            lat_tmp = os.path.join(self.dir, ".latest_tmp")
            with open(lat_tmp, "w") as f:
                f.write(f"step_{step}")
            os.replace(lat_tmp, os.path.join(self.dir, "latest"))
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ---- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        lat = os.path.join(self.dir, "latest")
        if not os.path.exists(lat):
            return None
        with open(lat) as f:
            name = f.read().strip()
        path = os.path.join(self.dir, name)
        if not os.path.exists(os.path.join(path, SENTINEL)):
            # crashed mid-commit: scan for the newest committed step
            return self._scan_latest()
        return int(name.split("_")[1])

    def _scan_latest(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, SENTINEL)):
                steps.append(int(name.split("_")[1]))
        return max(steps) if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """The checkpoint of `step` in the structure of `like`, each leaf in
        the dtype and on the device of like's leaf."""
        self.wait()
        path = os.path.join(self.dir, f"step_{step}")
        if not os.path.exists(os.path.join(path, SENTINEL)):
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        leaves, structure = tree_flatten(like)
        with np.load(os.path.join(path, f"shard_{self.proc}.npz")) as data:
            if len(data.files) != len(leaves):
                raise ValueError(f"checkpoint at step {step} holds "
                                 f"{len(data.files)} leaves, the tree "
                                 f"{len(leaves)}")
            out = [from_host(data[f"leaf_{i}"], l)
                   for i, l in enumerate(leaves)]
        return tree_unflatten(structure, out)

    def restore_latest(self, like: Any) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, like
        return step, self.restore(step, like)

    # ---- gc ---------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.dir)
            if n.startswith("step_") and ".tmp_" not in n
            and os.path.exists(os.path.join(self.dir, n, SENTINEL)))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
        # sweep uncommitted debris
        for n in os.listdir(self.dir):
            p = os.path.join(self.dir, n)
            if ".tmp_" in n and os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
            elif n.startswith("step_") and os.path.isdir(p) and \
                    not os.path.exists(os.path.join(p, SENTINEL)):
                shutil.rmtree(p, ignore_errors=True)
