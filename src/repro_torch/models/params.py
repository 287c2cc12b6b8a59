"""Parameter trees shared by the port's models.

A model's weights live in a `ParamTree`, an `nn.Module` whose `state_dict`
keys are the reference's parameter-tree paths joined by "."
(`enc.0.blocks.1.n1.scale`, `sa1.mlp.fc0.w`); `tree()` gives the nested
dict the forward reads, and `load_jax_params` copies a reference tree (as
numpy) into it.  An LM's stacked body leaves (`layers.sub0.mix.wq.w` of
shape (n_bodies, d, h * hd), made by `jax.vmap` in the reference) stay
stacked, so keys and shapes match one to one.
"""

from __future__ import annotations

import numpy as np
import torch


class ParamTree(torch.nn.Module):
    """A nested dict/list of tensors registered as parameters and
    submodules, named by their keys / list indices."""

    def __init__(self, tree):
        super().__init__()
        self._is_list = isinstance(tree, (list, tuple))
        for k, v in (enumerate(tree) if self._is_list else tree.items()):
            if isinstance(v, torch.Tensor):
                self.register_parameter(
                    str(k), torch.nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(str(k), ParamTree(v))

    def tree(self):
        """The nested dict/list view of the parameters."""
        out = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        if self._is_list:
            return [out[str(i)] for i in range(len(out))]
        return out


def tree_map(fn, *trees):
    """`fn` over the leaves of nested dicts / lists / NamedTuples of
    tensors with the same structure; the result keeps that structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, tuple) and hasattr(t0, "_fields"):
        return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def flatten_tree(tree, prefix=""):
    """(dotted path, leaf) pairs of a nested dict/list."""
    items = enumerate(tree) if isinstance(tree, (list, tuple)) \
        else tree.items()
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            yield from flatten_tree(v, key + ".")
        else:
            yield key, v


def load_jax_params(module: ParamTree, tree) -> ParamTree:
    """Copy a reference parameter tree (nested dicts/lists of numpy arrays,
    e.g. `jax.tree_util.tree_map(np.asarray, params)`) into `module`, on
    the module's device.  Keys and shapes must match exactly."""
    flat = {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flatten_tree(tree)}
    own = module.state_dict()
    if set(flat) != set(own):
        raise KeyError(
            f"parameter trees differ: missing {sorted(set(own) - set(flat))}"
            f", unexpected {sorted(set(flat) - set(own))}")
    for k, v in flat.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                             f"{tuple(own[k].shape)}")
    module.load_state_dict(flat)
    return module
