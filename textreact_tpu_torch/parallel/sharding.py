"""Parameter partitioning (twin of textreact_tpu/parallel/sharding.py):
Megatron-style tensor parallelism and ZeRO-1.

`param_spec` keeps the JAX package's rules, on the port's names (a torch
`Linear` keeps its weight as (out, in), the transpose of a flax kernel):

| flax path (sharding.py:30-43)              | port name                      | split   |
|--------------------------------------------|--------------------------------|---------|
| .../{query,key,value,intermediate}/kernel   | .../{...}.weight  (out, in)    | axis 0  |
|   (in, out) -> P(None, 'tp')               |                                |         |
| .../{query,key,value,intermediate}/bias     | .../{...}.bias                 | axis 0  |
| .../output/kernel (in, out) -> P('tp', None) | .../output.weight (out, in)   | axis 1  |
| everything else (embeddings, LayerNorm      | the same                       | none    |
|   scales and biases, output biases, heads)  |                                |         |

`shard_params(mesh, module)` cuts those tensors in place to this rank's
slice and turns on the explicit Megatron operators: the input of every
column-split block passes `TensorParallel.enter` (identity forward,
all-reduce of the gradient backward) and every row-split output `Linear`
passes `TensorParallel.reduce` (all-reduce forward, identity backward) and
adds its bias once, after the sum. Attention then runs on H / tp local
heads whose dropout masks are those of heads tp_rank * H / tp onward.
DTensor is not used: the kernels take raw device pointers.

ZeRO-1 (`zero_axis`): each dp rank keeps the AdamW moments of its slice of
every parameter along the parameter's first axis that dp divides
(sharding.py:54-76); the optimizer updates that slice and all-gathers the
parameter over the dp group (`train/optim.py`).

`full_state_dict` / `load_full_state_dict` move between a sharded module
and the full tensors a checkpoint holds, so that a checkpoint does not
depend on the mesh it was written from.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import FeedForward, MultiHeadAttention
from .mesh import Mesh

COLUMN_SPLIT = ("query", "key", "value", "intermediate")   # out features
ROW_SPLIT_HINT = ("output",)                                # in features


def param_spec(name: str, value: torch.Tensor) -> Optional[int]:
    """The axis of the port's tensor `name` that tp splits, or None for a
    replicated tensor."""
    parts = name.split(".")
    leaf, parents = parts[-1], set(parts[:-1])
    if leaf == "weight" and value.dim() == 2:
        if parents & set(COLUMN_SPLIT):
            return 0
        if parents & set(ROW_SPLIT_HINT):
            return 1
    if leaf == "bias" and value.dim() == 1 and parents & set(COLUMN_SPLIT):
        return 0
    return None


class _Enter(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _Reduce(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class TensorParallel:
    """The tp group of a sharded module: the f and g operators."""

    def __init__(self, mesh: Mesh):
        self.group = mesh.tp_group
        self.size = mesh.tp_size
        self.rank = mesh.tp_rank

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the tp group of the ranks' partial products, in
        float32 (a bfloat16 partial is rounded once, then summed)."""
        return _Reduce.apply(x.float(), self.group)


def _narrow(t: torch.Tensor, axis: int, parts: int, index: int
            ) -> torch.Tensor:
    n = t.shape[axis]
    assert n % parts == 0, (tuple(t.shape), axis, parts)
    return t.narrow(axis, index * (n // parts), n // parts)


def shard_params(mesh: Optional[Mesh], module: nn.Module) -> nn.Module:
    """Cut `module`'s tp-split parameters to this rank's slices, in place,
    and switch its attention and feed-forward blocks to the tp operators.
    With no mesh, or tp_size 1, nothing is cut. Records the mesh and the
    split axes on the module (`module.mesh`, `module.tp_axes`). Build the
    optimizer after this call."""
    module.mesh = mesh
    module.tp_axes = {}
    if mesh is None or mesh.tp_size == 1:
        return module
    tp = TensorParallel(mesh)
    for m in module.modules():
        if isinstance(m, MultiHeadAttention):
            if m.num_heads % tp.size:
                raise ValueError(f"{m.num_heads} heads do not split over "
                                 f"tp={tp.size}")
            m.set_tensor_parallel(tp)
        elif isinstance(m, FeedForward):
            m.set_tensor_parallel(tp)
    with torch.no_grad():
        for name, p in module.named_parameters():
            axis = param_spec(name, p)
            if axis is None:
                continue
            module.tp_axes[name] = axis
            p.data = _narrow(p.data, axis, tp.size, tp.rank).clone()
    return module


def _gather(t: torch.Tensor, axis: int, parts: int, group) -> torch.Tensor:
    pieces = [torch.empty_like(t) for _ in range(parts)]
    dist.all_gather(pieces, t.contiguous(), group=group)
    return torch.cat(pieces, axis)


def tp_gather(t: torch.Tensor, axis: Optional[int], mesh: Mesh
              ) -> torch.Tensor:
    """The whole tensor of which `t` is this rank's tp slice along `axis`
    (None: `t` is whole)."""
    if axis is None:
        return t
    return _gather(t, axis, mesh.tp_size, mesh.tp_group)


def tp_slice(t: torch.Tensor, axis: Optional[int], mesh: Mesh
             ) -> torch.Tensor:
    """This rank's tp slice along `axis` of the whole tensor `t`."""
    if axis is None:
        return t
    return _narrow(t, axis, mesh.tp_size, mesh.tp_rank)


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with every tp-split tensor gathered whole (a
    collective over the tp group: every rank calls it)."""
    axes = getattr(module, "tp_axes", {})
    return {name: tp_gather(t, axes.get(name), module.mesh) if axes else t
            for name, t in module.state_dict().items()}


def load_full_state_dict(module: nn.Module,
                         state: Dict[str, torch.Tensor]) -> None:
    """Load whole tensors into a (possibly tp-sharded) module: each rank
    takes its slices."""
    axes = getattr(module, "tp_axes", {})
    module.load_state_dict({
        name: tp_slice(t, axes.get(name), module.mesh) if axes else t
        for name, t in state.items()})


def zero_axis(shape, dp: int) -> Optional[int]:
    """ZeRO-1: the first axis of a moment of `shape` that dp divides (and is
    at least dp long), or None: that moment stays whole on every rank
    (sharding.py:54-76)."""
    for axis, n in enumerate(shape):
        if n % dp == 0 and n >= dp:
            return axis
    return None


def dp_slice(t: torch.Tensor, axis: Optional[int], mesh: Mesh
             ) -> torch.Tensor:
    """This dp rank's ZeRO-1 slice of `t` (a view)."""
    if axis is None:
        return t
    return _narrow(t, axis, mesh.dp_size, mesh.dp_rank)


def dp_gather(t: torch.Tensor, axis: Optional[int], mesh: Mesh
              ) -> torch.Tensor:
    """The whole tensor of which `t` is this rank's ZeRO-1 slice."""
    if axis is None:
        return t
    return _gather(t, axis, mesh.dp_size, mesh.dp_group)
