"""Carry weights from the JAX package's param trees into the port.

The `from_*` functions take a JAX param tree whose leaves are numpy
arrays (`jax.tree.map(np.asarray, params)` on the JAX side).  Dense
weights keep their (d_in, d_out) orientation, which is the port's too.
This is the only way the two packages compute the same net.

  * `from_jax_params(tree)` returns a `state_dict` for the DiT or the MLP
    score net: nested dict keys and list indices are joined with '.'
    ("blocks.<i>.…" for the MLP's list of blocks), and the DiT's layer
    stack — one leading L axis per leaf under "layers" — is unstacked
    into "layers.<i>.…" entries.
  * `to_jax_params(state_dict)` is its inverse, as numpy arrays: the
    layers stacked again, the blocks a list.  numpy has no bf16, so a bf16
    tensor comes back as float32 holding the same values (cast it with
    `.astype(jnp.bfloat16)` on the JAX side: exact).
  * `jax_tree(named)` is the same layout over tensors, and
    `train_state_tree(net, opt_state)` the (params, AdamWState) tree of a
    net and its optimizer state as the JAX training loop checkpoints it;
    `load_train_state` copies such a tree back in place.
  * `from_jax_transformer(tree, cfg)` returns the transformer's params:
    `embed`, `ln_f` (and `unembed` when untied) and `layers`, the list of
    per-layer dicts in the order the JAX forward runs them — for each
    group g and pattern position pos, `layer_stacks[pos]` sliced at g
    (layer g * P + pos), then `rem_layers`.  `to_jax_transformer(params,
    cfg)` is its inverse, as numpy arrays (`jax_transformer_tree` over
    tensors: the layers of each pattern position stacked over the
    groups, the remainder a list).
    An MoE layer's "moe" dict (the f32 router, the (E, D, F) expert
    stacks, "shared") carries over as any other leaf does, each leaf in
    its own dtype (the router stays f32 in a bf16 config).
  * `from_jax_encdec(tree, cfg)` returns the encoder-decoder's params:
    the stacked `enc_layers` / `dec_layers` unstacked into lists of
    per-layer dicts, the rest as it is; `to_jax_encdec(params, cfg)` is
    its inverse, as numpy arrays.  `from_jax_rwkv` / `to_jax_rwkv` and
    `from_jax_zamba` / `to_jax_zamba` do the same with the one (L, ...)
    `layers` stack (zamba's shared block stays one dict); all are
    `from_jax_lm` / `to_jax_lm`, which pick the layout by `cfg`'s type
    (the transformer's too), and `from_jax_cache(cache, cfg)` carries a
    JAX serving cache of rwkv, zamba or encdec into the port's lists.
  * `lm_train_state_tree(params, opt_state, cfg)` is the (params,
    AdamWState) tree of a token arch of any family (by `cfg`'s type) and
    its optimizer state as the JAX `train_lm` checkpoints it,
    on the host; `load_lm_train_state` copies such a tree back in place.
    The optimizer state's lists follow `transformer.param_list`'s order.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch


def from_jax_params(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy leaves) -> torch state_dict."""
    return {k: _tensor(np.asarray(v)) for k, v in _unstack(tree).items()}


def jax_tree(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Tensors named as in a state_dict -> the JAX package's param tree of
    the same tensors: dotted names nest, numbered children become a list
    ("blocks.<i>.…"), and the DiT's numbered "layers" are stacked along a
    new leading axis (new tensors), as JAX holds them."""
    tree: Dict[str, Any] = {}
    for key, t in named.items():
        *path, last = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = t
    return _listify(tree)


def _listify(node: Any, key: str = "") -> Any:
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v, k) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        items = [node[str(i)] for i in range(len(node))]
        return _stack(items) if key == "layers" else items
    return node


def _stack(items: List[Any]) -> Any:
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def to_jax_params(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's state_dict (DiT or MLP) -> the JAX param tree as numpy
    arrays (bf16 as float32 of the same values)."""
    return _map(jax_tree(state_dict), _to_numpy)


def train_state_tree(net: torch.nn.Module, opt_state) -> tuple:
    """(params, AdamWState(step, m, v, master)) in the JAX package's tree
    layout: the tree its training loop checkpoints.  `opt_state` is the
    port's AdamW state over `list(net.parameters())`."""
    from .optim.adamw import AdamWState
    names = [n for n, _ in net.named_parameters()]
    tree = lambda ts: jax_tree(dict(zip(names, ts)))
    params = [p.detach() for p in net.parameters()]
    return (tree(params),
            AdamWState(step=opt_state.step, m=tree(opt_state.m),
                       v=tree(opt_state.v), master=tree(opt_state.master)))


def load_train_state(net: torch.nn.Module, opt_state, tree: tuple) -> None:
    """Copy a (params, AdamWState) tree of `train_state_tree`'s layout (as
    `CheckpointStore.restore` returns it) into `net` and `opt_state`, in
    place."""
    names = [n for n, _ in net.named_parameters()]
    params, state = tree
    with torch.no_grad():
        opt_state.step.copy_(state.step)
        for dest, sub in ((list(net.parameters()), params),
                          (opt_state.m, state.m), (opt_state.v, state.v),
                          (opt_state.master, state.master)):
            src = _unstack(sub)
            if sorted(src) != sorted(names):
                raise ValueError("the train state's tree does not match the "
                                 f"net: {sorted(set(src) ^ set(names))}")
            for name, t in zip(names, dest):
                t.copy_(src[name])


def _unstack(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Inverse of `jax_tree` (tensor or numpy leaves): a state_dict's
    names for a param tree's leaves, the "layers" stack sliced per layer."""
    out: Dict[str, Any] = {}
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for name, val in items:
        key = f"{prefix}{name}"
        if isinstance(val, (Mapping, list, tuple)):
            out.update(_unstack(val, key + "."))
        elif key.startswith("layers."):
            rest = key[len("layers."):]
            for i in range(val.shape[0]):
                out[f"layers.{i}.{rest}"] = val[i]
        else:
            out[key] = val
    return out


def _from_jax_layout(tree: Mapping[str, Any], cfg, leaf) -> Dict[str, Any]:
    """A tree in the JAX transformer layout -> the port's, each leaf (a
    numpy array or a tensor; a group's slice for a stacked one) passed
    through `leaf`."""
    P = cfg.pattern
    layers: List[Any] = []
    for g in range(cfg.n_groups):
        for pos in range(P):
            layers.append(_map(tree["layer_stacks"][pos],
                               lambda a: leaf(a[g])))
    layers += [_map(lp, leaf) for lp in tree["rem_layers"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, config says "
                         f"{cfg.n_layers}")
    out = {k: leaf(tree[k]) for k in ("embed", "ln_f", "unembed")
           if k in tree}
    out["layers"] = layers
    return out


def from_jax_transformer(tree: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """JAX transformer param tree (numpy leaves) -> the port's params."""
    return _from_jax_layout(tree, cfg, lambda a: _tensor(np.asarray(a)))


def jax_transformer_tree(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The port's transformer params (or a tree of that structure) -> the
    JAX layout over the same tensors: `layer_stacks[pos]` stacks layers
    g * P + pos over the groups g (new tensors), `rem_layers` lists the
    remainder's dicts."""
    layers = params["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers, config says "
                         f"{cfg.n_layers}")
    P, G = cfg.pattern, cfg.n_groups
    tree = {k: v for k, v in params.items() if k != "layers"}
    with torch.no_grad():
        tree["layer_stacks"] = [
            _stack([layers[g * P + pos] for g in range(G)]) if G else {}
            for pos in range(P)]
    tree["rem_layers"] = list(layers[G * P:])
    return tree


def to_jax_transformer(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The port's transformer params -> the JAX param tree as numpy arrays
    (bf16 as float32 of the same values), the inverse of
    `from_jax_transformer`."""
    return _map(jax_transformer_tree(params, cfg), _to_numpy)


def _stacks(cfg):
    """(key, count) of each layer list of a family's params, one stack
    along a leading axis in the JAX tree (the rest of the tree carries
    over leaf by leaf: zamba's one shared block too); None for the
    transformer, whose JAX layout groups layers by pattern position."""
    from .models.zoo import EncDecCfg, RWKV6LMCfg, Zamba2Cfg
    if isinstance(cfg, EncDecCfg):
        return (("enc_layers", cfg.n_enc_layers),
                ("dec_layers", cfg.n_dec_layers))
    if isinstance(cfg, (RWKV6LMCfg, Zamba2Cfg)):
        return (("layers", cfg.n_layers),)
    return None


def _from_jax_stacked(tree: Mapping[str, Any], cfg, leaf) -> Dict[str, Any]:
    """A tree in the JAX layout of a family with layer stacks -> the
    port's, each leaf (a layer's slice for a stacked one) passed through
    `leaf`."""
    stacks = dict(_stacks(cfg))
    out = {k: _map(v, leaf) for k, v in tree.items() if k not in stacks}
    for key, n in stacks.items():
        out[key] = [_map(tree[key], lambda a, i=i: leaf(a[i]))
                    for i in range(n)]
    return out


def _jax_stacked_tree(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The port's params of a family with layer stacks (or a tree of that
    structure) -> the JAX layout over the same tensors: each layer list
    stacked along a new leading axis (new tensors)."""
    stacks = dict(_stacks(cfg))
    tree = {k: v for k, v in params.items() if k not in stacks}
    with torch.no_grad():
        for key, n in stacks.items():
            if len(params[key]) != n:
                raise ValueError(f"{len(params[key])} {key}, config says "
                                 f"{n}")
            tree[key] = _stack(list(params[key]))
    return tree


def from_jax_lm(tree: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """A JAX token arch's param tree (numpy leaves) -> the port's params,
    by `cfg`'s family: the transformer's layout (`from_jax_transformer`),
    or each layer stack unstacked into a list of per-layer dicts."""
    if _stacks(cfg) is None:
        return from_jax_transformer(tree, cfg)
    return _from_jax_stacked(tree, cfg, lambda a: _tensor(np.asarray(a)))


def to_jax_lm(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The port's params of a token arch -> its JAX param tree as numpy
    arrays (bf16 as float32 of the same values), the inverse of
    `from_jax_lm`."""
    return _map(_jax_lm_tree(params, cfg), _to_numpy)


# each family's own name for the rule: whisper's enc_layers / dec_layers
# stacks, rwkv's and zamba's one layers stack (zamba's Mamba2 layers in the
# order the JAX forward regroups them, (G, share_every): layer g *
# share_every + j; its shared block one dict)
from_jax_encdec = from_jax_rwkv = from_jax_zamba = from_jax_lm
to_jax_encdec = to_jax_rwkv = to_jax_zamba = to_jax_lm


def from_jax_cache(cache: Any, cfg) -> Any:
    """A JAX serving cache (numpy leaves, layers stacked) -> the port's,
    for the rwkv, zamba and encdec families: rwkv's (x_prev_t, S,
    x_prev_c), each (L, B, ...), -> a list of L tuples; zamba's ((conv,
    ssm), (k, v)), (L, B, ...) and (G, B, ...), -> (a list of L (conv,
    ssm), a list of G (k, v)); encdec's (k, v), (L, B, ...), -> a list
    of L pairs."""
    from .models.zoo import EncDecCfg, RWKV6LMCfg, Zamba2Cfg
    t = lambda a: _tensor(np.asarray(a))
    unstack = lambda leaves: [tuple(t(a[i]) for a in leaves)
                              for i in range(np.asarray(leaves[0]).shape[0])]
    if isinstance(cfg, (RWKV6LMCfg, EncDecCfg)):
        return unstack(list(cache))
    if isinstance(cfg, Zamba2Cfg):
        return unstack(list(cache[0])), unstack(list(cache[1]))
    raise ValueError(f"no cache conversion for {type(cfg).__name__}")


def _jax_lm_tree(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    if _stacks(cfg) is None:
        return jax_transformer_tree(params, cfg)
    return _jax_stacked_tree(params, cfg)


def _from_jax_lm_layout(tree: Mapping[str, Any], cfg, leaf) -> Dict[str, Any]:
    if _stacks(cfg) is None:
        return _from_jax_layout(tree, cfg, leaf)
    return _from_jax_stacked(tree, cfg, leaf)


def lm_train_state_tree(params: Mapping[str, Any], opt_state, cfg) -> tuple:
    """(params, AdamWState(step, m, v, master)) in the JAX layout of
    `cfg`'s family: the tree the JAX `train_lm` checkpoints, on the host.  Each
    leaf is copied to the host before the layers are stacked, so neither a
    save nor a resume's template takes device memory, and a restore into
    this tree's structure lands on the host too.  `opt_state` is the
    port's AdamW state over `transformer.param_list(params)`."""
    from .ckpt.store import tree_flatten, tree_unflatten
    from .optim.adamw import AdamWState
    structure = tree_flatten(params)[1]
    tree = lambda ts: _jax_lm_tree(
        tree_unflatten(structure, [t.detach().cpu() for t in ts]), cfg)
    return (tree(tree_flatten(params)[0]),
            AdamWState(step=opt_state.step.cpu(), m=tree(opt_state.m),
                       v=tree(opt_state.v), master=tree(opt_state.master)))


def load_lm_train_state(params: Mapping[str, Any], opt_state, tree: tuple,
                        cfg) -> None:
    """Copy a (params, AdamWState) tree of `lm_train_state_tree`'s layout
    (as `CheckpointStore.restore` returns it) into `params` and
    `opt_state`, in place."""
    from .ckpt.store import tree_flatten
    p_tree, state = tree
    with torch.no_grad():
        opt_state.step.copy_(state.step)
        for dest, sub in ((tree_flatten(params)[0], p_tree),
                          (opt_state.m, state.m), (opt_state.v, state.v),
                          (opt_state.master, state.master)):
            src = tree_flatten(_from_jax_lm_layout(sub, cfg,
                                                   lambda t: t))[0]
            if len(src) != len(dest) or any(
                    a.shape != b.shape for a, b in zip(dest, src)):
                raise ValueError("the train state's tree does not match "
                                 "the params")
            for a, b in zip(dest, src):
                a.copy_(b)


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: go through its f32 value (exact)
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())
