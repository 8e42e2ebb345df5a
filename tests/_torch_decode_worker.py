"""Rank body of tests/test_torch_decode_loop.py's tensor-parallel case,
started by `textreact_tpu_torch.parallel.multihost.spawn` over gloo on the
CPU. It imports torch and the port only."""

from __future__ import annotations

import json
import os

from textreact_tpu_torch.entry import _flagship, _generate_inputs
from textreact_tpu_torch.inference import Generator
from textreact_tpu_torch.parallel import make_mesh, shard_params


def tp_generate(rank: int, world_size: int, device: str, out: str) -> None:
    """Beam 3 over 8 positions on entry's tiny flagship (f32, seed 2) cut
    tp=world_size; rank 0 writes the route, the beams and the steps."""
    import torch
    mesh = make_mesh(1, world_size)
    module = shard_params(mesh, _flagship(tiny=True, dtype=torch.float32,
                                          seed=2, device=device))
    gen = Generator(module, num_beams=3, max_length=8)
    seqs, scores = gen.generate(_generate_inputs(module))
    if rank == 0:
        with open(os.path.join(out, "generate.json"), "w") as f:
            json.dump({"route": gen.route, "tp": mesh.tp_size,
                       "steps": gen.last_steps, "seqs": seqs.tolist(),
                       "scores": scores.tolist()}, f)
