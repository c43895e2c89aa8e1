"""Carry weights from the JAX package's param trees into the port.

Both functions take a JAX param tree whose leaves are numpy arrays
(`jax.tree.map(np.asarray, params)` on the JAX side).  Dense weights keep
their (d_in, d_out) orientation, which is the port's too.  This is the
only way the two packages compute the same net.

  * `from_jax_params(tree)` returns a `state_dict` for the DiT module:
    nested dict keys are joined with '.', and the layer stack — one
    leading L axis per leaf under "layers" — is unstacked into
    "layers.<i>.…" entries.
  * `from_jax_transformer(tree, cfg)` returns the transformer's params:
    `embed`, `ln_f` (and `unembed` when untied) and `layers`, the list of
    per-layer dicts in the order the JAX forward runs them — for each
    group g and pattern position pos, `layer_stacks[pos]` sliced at g
    (layer g * P + pos), then `rem_layers`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

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


def _tree_tensors(tree: Any) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_tensors(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree))


def _tree_slice(tree: Any, g: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_slice(v, g) for k, v in tree.items()}
    return np.asarray(tree)[g]


def from_jax_transformer(tree: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """JAX transformer param tree (numpy leaves) -> the port's params."""
    P = cfg.pattern
    layers: List[Any] = []
    for g in range(cfg.n_groups):
        for pos in range(P):
            layers.append(_tree_tensors(_tree_slice(tree["layer_stacks"][pos],
                                                    g)))
    layers += [_tree_tensors(lp) for lp in tree["rem_layers"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config says "
                         f"{cfg.n_layers}")
    out = {k: _tensor(np.asarray(tree[k])) for k in ("embed", "ln_f")}
    if "unembed" in tree:
        out["unembed"] = _tensor(np.asarray(tree["unembed"]))
    out["layers"] = layers
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: go through its f32 value (exact)
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())
