"""Weight bridge: the JAX package's flax param tree -> this port's state_dict.

The port's modules carry the flax module names, so a key is the flax path
joined with dots, with three renames:
- `layer_<i>` -> `layers.<i>` (an nn.ModuleList);
- a Dense `kernel` (in, out) -> a Linear `weight` (out, in);
- a LayerNorm `scale` and an Embed `embedding` -> `weight`.

The decoder's `word_embedding`, tied to its LM head, stays one parameter
(`decoder.word_embedding`); `lm_head/bias` and the MLM head carry across,
and so do the template heads of TemplateBasedModel: `head/atom_head`,
`head/bond_head_left` (kernel and bias) and `head/bond_head_right` (kernel
only) become `head.atom_head.{weight,bias}` and so on.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LAYER = re.compile(r"^layer_(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (name,))
        else:
            yield prefix + (name,), value


def from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{'params': tree} or the tree itself, leaves array-like -> f32 state_dict
    (load_state_dict casts to each parameter's dtype)."""
    if set(params) == {"params"}:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(params):
        *mods, leaf_name = path
        mods = [f"layers.{m.group(1)}" if (m := _LAYER.match(p)) else p
                for p in mods]
        arr = np.asarray(leaf, dtype=np.float32)
        if leaf_name == "kernel":
            name, arr = "weight", arr.T
        elif leaf_name in ("scale", "embedding"):
            name = "weight"
        else:
            name = leaf_name
        state[".".join(mods + [name])] = torch.tensor(arr)
    return state


def grads_from_flax(grads: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax gradient tree keyed like `module.named_parameters()`: a
    gradient takes the renames and transposes of its parameter."""
    return from_flax(grads)
