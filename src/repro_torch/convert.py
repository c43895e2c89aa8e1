"""Carry weights from the JAX package's param trees into the port.

`from_jax_params(tree)` takes a JAX param tree whose leaves are numpy
arrays (`jax.tree.map(np.asarray, params)` on the JAX side) and returns a
`state_dict` for the port's module: nested dict keys are joined with '.',
and the DiT's layer stack — one leading L axis per leaf under "layers" —
is unstacked into "layers.<i>.…" entries.  Dense weights keep their
(d_in, d_out) orientation, which is the port's too.  This is the only way
the two packages compute the same net.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, val in tree.items():
        key = f"{prefix}{name}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, key + "."))
        else:
            out[key] = np.asarray(val)
    return out


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> torch state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in _flatten(tree).items():
        if key.startswith("layers."):
            rest = key[len("layers."):]
            for i in range(arr.shape[0]):
                sd[f"layers.{i}.{rest}"] = _tensor(arr[i])
        else:
            sd[key] = _tensor(arr)
    return sd


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: go through its f32 value (exact)
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())
