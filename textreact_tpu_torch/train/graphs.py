"""The train and eval steps' compiled execution on the card: CUDA graphs in
place of the JAX package's one jitted program per shape bucket
(textreact_tpu/train/step.py `make_train_step`, `make_accum_train_step`,
`make_eval_step`).

A train step (train/step.py `TrainStep`) is two parts. `TrainGraphs`
holds a train step's graphs, all drawing their memory from one pool:
- per shape key, a `GraphedTrainStep`: static inputs and the graph of the
  micro-batch part (forward, backward into the `.grad` buffers, the
  weighted loss sum), replayed once per real micro-batch;
- one graph of the update part (gradients over the weight sum, norm,
  clip, AdamW, gradients zeroed), replayed once a step. It reads no input
  of a key, so every key shares it.
The first time a part runs, it runs uncaptured on the capture stream, as
a real part of the step (the warm-up a capture needs), and is then
captured (ops/launches.py `GraphedPart`); it is replayed from then on. A
capture or a replay that fails raises: nothing falls back to the
uncaptured route.

The graphs read and write their buffers where they lie. Every buffer that
outlives a part (the gradients, the moments, the rate and the count, the
static inputs, the loss sum, the metric outputs) is allocated outside the
pool, so a graph leaves nothing in the pool that another graph's replay
could overwrite, and any order of replays is safe. Each micro-batch is
staged in pinned host memory from torch's caching host allocator, which
hands a block out again only after the copies that read it have run, and
copied into the static inputs of its key just before its replay.

Every dropout mask comes from the step's one `torch.Generator`, which is
registered with each micro-batch graph: the host reseeds it before each
replay (`manual_seed` cannot run inside a capture), and the replay's
prologue takes up the seed and offset the generator holds then, so a
replay draws what the uncaptured part draws from a generator seeded the
same.

An eval step (train/step.py `EvalStep`) is one part, its forward, and
`EvalGraphs` holds its graphs in a pool of its own: per shape key, a
`GraphedEvalStep` with static inputs, the graph of the forward and the
buffers of its outputs. Those buffers are allocated at the key's first,
uncaptured run, outside the pool, as the train step's are; the step hands
back clones of them. The forward draws no mask (no dropout runs in eval
mode), so no generator is registered.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.launches import GraphedPart

Key = Tuple[Tuple[str, Tuple[int, ...], str], ...]


def _host_array(value) -> np.ndarray:
    if torch.is_tensor(value):
        return value.numpy()
    return np.asarray(value)


def static_dtype(value) -> torch.dtype:
    """The dtype a batch array has on the device (train/step.py
    `to_device`): int64 for integers and booleans, else its own."""
    dtype = (value.dtype if torch.is_tensor(value)
             else torch.from_numpy(np.asarray(value)[:0]).dtype)
    return dtype if dtype.is_floating_point else torch.int64


class StaticInputs:
    """One shape key's static inputs. `load(arrays, i)` copies micro-batch
    `i` of a step's arrays (stacked on a leading micro-batch axis; all of
    them when `i` is None) into `inputs` on the current stream, a host
    array through pinned memory. Each micro-batch is converted and pinned
    at its own `load`, so that the host prepares micro-batch i + 1 while
    the card runs micro-batch i."""

    def __init__(self, graphs: "KeyedGraphs", key: Key):
        self.key = key
        self.inputs: Dict[str, torch.Tensor] = {
            name: torch.zeros(shape, dtype=getattr(torch, dtype),
                              device=graphs.device)
            for name, shape, dtype in key}

    def load(self, arrays: Mapping[str, Any], i: Optional[int]) -> None:
        for name, value in arrays.items():
            src = value if i is None else value[i]
            if not (torch.is_tensor(src) and src.is_cuda):
                host = torch.from_numpy(np.ascontiguousarray(_host_array(src)))
                src = torch.empty(host.shape, dtype=self.inputs[name].dtype,
                                  pin_memory=True)
                src.copy_(host)
            self.inputs[name].copy_(src, non_blocking=True)


class GraphedTrainStep(StaticInputs):
    """One shape key's static inputs and micro-batch graph."""

    def __init__(self, graphs: "TrainGraphs", key: Key):
        super().__init__(graphs, key)
        self.micro = GraphedPart(graphs.pool, graphs.stream,
                                 graphs.generator)


class GraphedEvalStep(StaticInputs):
    """One shape key's static inputs, forward graph and output buffers."""

    def __init__(self, graphs: "EvalGraphs", key: Key):
        super().__init__(graphs, key)
        self.forward = GraphedPart(graphs.pool, graphs.stream)
        self.outputs: Dict[str, torch.Tensor] = {}

    def store(self, results: Mapping[str, torch.Tensor]) -> None:
        """Copy a forward's results into the output buffers, allocating
        them at the first, uncaptured run (so outside the pool)."""
        for name, value in results.items():
            out = self.outputs.get(name)
            if out is None:
                out = self.outputs[name] = torch.empty_like(value)
            out.copy_(value)


class KeyedGraphs:
    """A step's pool, capture stream and one `part` (a `StaticInputs`
    class) per shape key."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.keys: Dict[Key, Any] = {}

    @staticmethod
    def key_of(arrays: Mapping[str, Any], stacked: bool) -> Key:
        """The sorted (name, per-micro-batch shape, device dtype) of the
        arrays: the MLM prefix's length is the shape of `mlm_labels`."""
        return tuple(sorted(
            (name, tuple(value.shape[1:] if stacked else value.shape),
             str(static_dtype(value)).replace("torch.", ""))
            for name, value in arrays.items()))

    def key(self, arrays: Mapping[str, Any], stacked: bool = False):
        key = self.key_of(arrays, stacked)
        part = self.keys.get(key)
        if part is None:
            part = self.keys[key] = self.part(self, key)
        return part


class EvalGraphs(KeyedGraphs):
    """An eval step's graphs (see the module's docstring): the pool, the
    capture stream and one `GraphedEvalStep` per shape key."""

    part = GraphedEvalStep


class TrainGraphs(KeyedGraphs):
    """A train step's graphs (see the module's docstring): the pool, the
    capture stream, the dropout generator, the update part's graph and one
    `GraphedTrainStep` per shape key."""

    part = GraphedTrainStep

    def __init__(self, device: torch.device, generator: torch.Generator):
        super().__init__(device)
        self.generator = generator
        self.update = GraphedPart(self.pool, self.stream)
        self._grads: Optional[list] = None

    def check_grads(self, optimizer) -> None:
        """The graphs accumulate into the `.grad` buffers they were
        captured with: raise if a caller put others in their place."""
        grads = [p.grad for p in optimizer.params]
        if self._grads is None:
            self._grads = grads
        elif any(a is not b for a, b in zip(grads, self._grads)):
            raise RuntimeError("a parameter's .grad is no longer the buffer "
                               "the train step's graphs were captured with")
