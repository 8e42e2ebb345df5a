"""Multi-process support (twin of textreact_tpu/parallel/multihost.py).

One process per device, joined by torch.distributed: NCCL between CUDA
devices, gloo on the CPU (and between processes that share one card, which
NCCL refuses). `initialize_distributed` reads `RANK`, `WORLD_SIZE` and
`MASTER_ADDR` / `MASTER_PORT` as `torchrun` sets them, or takes an explicit
`init_method`; with one process it does nothing.

Evaluation outputs are unioned id-keyed across ranks (`gather_score_dict`,
`gather_prediction_dict`): ids repeated by the loader's wrap-around padding
and by the tp replicas of a row collapse in the dict merge, as in the
reference's dict merge of `dist.all_gather_object` (main.py:259-268).

`spawn` starts a world of processes on this host, each running one
function, for the multi-process gate legs and tests.

What takes the place of `device_put_global` / `device_put_global_spanning`:
nothing is assembled. Each rank loads the rows of its dp index
(`DataLoader.shard_across_processes(mesh.dp_rank, mesh.dp_size)`: the dp
rank, never the global rank, so the tp ranks of one row load the same
rows), and the step reduces what must be global (the loss denominators,
the gradients, the gradient norm) over the dp group.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """`init_process_group` for this process. Returns whether a process
    group exists afterwards. A no-op when one exists already, and for one
    process unless `init_method` asks for a group even then (a world of
    one, whose collectives are identities). The backend is NCCL when
    `device` is a CUDA device, else gloo, unless `backend` names one."""
    if dist.is_initialized():
        return True
    world_size = int(os.environ.get("WORLD_SIZE", 1)
                     if world_size is None else world_size)
    if world_size <= 1 and init_method is None:
        return False
    rank = int(os.environ.get("RANK", 0) if rank is None else rank)
    if backend is None:
        cuda = device is not None and torch.device(device).type == "cuda"
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl" and device is not None:
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def local_device(device=None) -> torch.device:
    """This process's device: `device` as given, except that a bare 'cuda'
    becomes card LOCAL_RANK (torchrun's) modulo the cards present."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", process_index()))
        device = torch.device("cuda", local % max(1, torch.cuda.device_count()))
    return device


def barrier(group=None) -> None:
    """Wait for every rank of `group` (default: the world)."""
    if dist.is_initialized():
        dist.barrier(group=group)


def _allgather_objects(obj: Any) -> List[Any]:
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def gather_prediction_dict(local: Dict[int, Dict]) -> Dict[int, Dict]:
    """Union id-keyed test-prediction dicts over every rank (reference
    gather_outputs, main.py:259-268); one process: the dict itself."""
    if process_count() == 1:
        return local
    merged: Dict[int, Dict] = {}
    for d in _allgather_objects(local):
        merged.update(d)
    return merged


def gather_score_dict(local: Dict[int, float]) -> Dict[int, float]:
    """Union per-example {index: score} dicts over every rank; one process:
    the dict itself."""
    if process_count() == 1:
        return local
    merged: Dict[int, float] = {}
    for d in _allgather_objects({int(k): float(v) for k, v in local.items()}):
        merged.update(d)
    return merged


# ---------------------------------------------------------------------------
# a world of processes on this host
# ---------------------------------------------------------------------------

def spawn(target: str, world_size: int, kwargs: Optional[Dict] = None,
          backend: str = "gloo", devices: Optional[Sequence[str]] = None,
          pythonpath: Sequence[str] = (), timeout: float = 600.0,
          threads: Optional[int] = 1) -> List[str]:
    """Run `target` ("module:function") in `world_size` fresh processes
    joined by `backend` through a file store, each called as
    function(rank=..., world_size=..., device=..., **kwargs) after
    `initialize_distributed`. `devices[r]` is rank r's device (default:
    'cpu'). Raises, with the logs, if any rank fails; returns the logs.
    `threads` caps each CPU rank's intra-op threads (None: torch's
    default), so that several ranks share the host's cores."""
    work = tempfile.mkdtemp(prefix="tr_spawn_")   # the store and the logs
    init = "file://" + os.path.join(work, "rendezvous")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_REPO, *pythonpath] + ([env["PYTHONPATH"]]
                                if env.get("PYTHONPATH") else []))
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    logs = [os.path.join(work, f"rank{r}.log") for r in range(world_size)]
    procs = []
    for r in range(world_size):
        spec = dict(target=target, rank=r, world_size=world_size, init=init,
                    backend=backend, kwargs=kwargs or {},
                    device=(devices[r] if devices else "cpu"),
                    threads=threads)
        with open(logs[r], "wb") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "textreact_tpu_torch.parallel.multihost",
                 json.dumps(spec)], env=env, cwd=_REPO, stdout=f,
                stderr=subprocess.STDOUT))
    failed: List[int] = []
    deadline = time.monotonic() + timeout
    try:
        # a rank that fails leaves the others waiting in a collective:
        # stop them all at the first failure or at the deadline
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for path in logs:
        with open(path, errors="replace") as f:
            texts.append(f.read())
    shutil.rmtree(work, ignore_errors=True)
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(
            f"{target}: ranks {sorted(failed)} of {world_size} failed\n"
            + "\n".join(f"--- rank {r} ---\n{texts[r][-6000:]}"
                        for r in sorted(failed)))
    return texts


def _worker(spec: Dict[str, Any]) -> None:
    if spec.get("threads"):
        torch.set_num_threads(int(spec["threads"]))
    device = spec["device"]
    initialize_distributed(spec["init"], spec["world_size"], spec["rank"],
                           backend=spec["backend"], device=device)
    module, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    try:
        fn(rank=spec["rank"], world_size=spec["world_size"], device=device,
           **spec["kwargs"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    _worker(json.loads(sys.argv[1]))
