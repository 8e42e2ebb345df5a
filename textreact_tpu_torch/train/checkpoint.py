"""Checkpointing: best/last semantics on the val metric (twin of
textreact_tpu/train/checkpoint.py, `torch.save` in place of orbax).

Parity: reference main.py:358-360 (ModelCheckpoint monitor=val_metric,
save_top_k=1 -> 'best', save_last -> 'last'), main.py:389-397 (resume from
save_path/best|last unless --overwrite), utils.py:47-52 (clear_path).

Same names, files and policy as the JAX package: `{name}.ckpt` (one file
here, a directory there), `{name}.meta.json`, a `.ckpt.tmp` while a write is
under way, `save_eval` keeping 'last' always and 'best' on improvement.

What is saved: the module's parameters, the optimizer's moments and update
count, and `TrainState.step`. Parameters and moments are saved whole, keyed
by parameter name, whatever mesh the run has: on a mesh every rank takes
part in gathering them from their tp and ZeRO-1 shards, and rank 0 alone
writes. `restore` places the whole tensors into any (dp, tp) shape, so a
run may resume on another mesh than the one that saved it. A train step updates all of these IN PLACE, so
`save` copies them to host memory before it returns, and the copy is
complete, not merely queued, when it does (a blocking device-to-host copy
per tensor): the next optimizer step cannot reach into a checkpoint. A
background thread then writes the host copy into the tmp name and publishes
it by rename, meta last: a crash mid-write never leaves a visible half
checkpoint, and a crash after the write loses nothing. At most one write is
in flight; its error, if any, is re-raised at the next flush point.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import torch

from ..parallel.multihost import barrier, is_primary
from ..parallel.sharding import full_state_dict, load_full_state_dict
from .step import TrainState, _check_device

METRIC_MODE = {"val_loss": "min", "val_acc": "max"}


def _to_host(tree: Any) -> Any:
    """A copy of `tree` with every tensor in host memory, sharing nothing
    with the original. `Tensor.to("cpu", copy=True)` blocks until a device
    tensor's bytes have arrived."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, save_path: str, val_metric: str = "val_acc",
                 async_save: bool = True, mesh=None):
        """`mesh`: the ranks that save and restore together (default: the
        whole world); its rank 0 writes."""
        self.save_path = os.path.abspath(save_path)
        self.group = None if mesh is None else mesh.group
        self.val_metric = val_metric
        self.mode = METRIC_MODE[val_metric]
        os.makedirs(self.save_path, exist_ok=True)
        self.async_save = async_save
        self._publisher: Optional[threading.Thread] = None
        self._publish_error: Optional[BaseException] = None
        # seconds of the last save: the part `save` blocks for (the copy to
        # the host) and the background part (write, rename, meta)
        self.last_blocking_seconds = 0.0
        self.last_write_seconds = 0.0

    def _publish(self, payload: dict, tmp: str, final: str, meta_path: str,
                 meta: dict) -> None:
        try:
            t0 = time.perf_counter()
            torch.save(payload, tmp)
            os.replace(tmp, final)
            tmp_meta = meta_path + ".tmp"
            with open(tmp_meta, "w") as f:
                json.dump(meta, f)
            os.replace(tmp_meta, meta_path)
            self.last_write_seconds = time.perf_counter() - t0
        except BaseException as e:  # re-raised at the next flush point
            self._publish_error = e

    def _flush(self) -> None:
        """Wait for the in-flight write+publish (at most one)."""
        if self._publisher is not None:
            self._publisher.join()
            self._publisher = None
        if self._publish_error is not None:
            err, self._publish_error = self._publish_error, None
            raise err

    # --- paths ---
    def _file(self, name: str) -> str:
        return os.path.join(self.save_path, f"{name}.ckpt")

    def _meta_path(self, name: str) -> str:
        return os.path.join(self.save_path, f"{name}.meta.json")

    def exists(self, name: str) -> bool:
        self._flush()
        barrier(self.group)   # every rank sees what rank 0 has published
        return os.path.isfile(self._file(name))

    def clear(self) -> None:
        """--overwrite: delete stale checkpoints (reference utils.py:47-52)."""
        self._flush()
        if not is_primary():
            barrier(self.group)
            return
        for entry in os.listdir(self.save_path):
            if (entry.endswith(".ckpt") or entry.endswith(".meta.json")
                    or entry.endswith(".ckpt.tmp")):
                full = os.path.join(self.save_path, entry)
                shutil.rmtree(full) if os.path.isdir(full) else os.remove(full)
        barrier(self.group)

    # --- save/load ---
    def save(self, name: str, state: TrainState,
             meta: Optional[dict] = None) -> None:
        self._flush()  # at most one write in flight
        t0 = time.perf_counter()
        payload = {"module": full_state_dict(state.module),
                   "optimizer": state.optimizer.state_dict(),
                   "step": state.step}
        if not is_primary():
            return
        payload = _to_host(payload)
        self.last_blocking_seconds = time.perf_counter() - t0
        final = self._file(name)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            os.remove(tmp)
        self._publisher = threading.Thread(
            target=self._publish,
            args=(payload, tmp, final, self._meta_path(name), meta or {}),
            daemon=True)
        self._publisher.start()
        if not self.async_save:
            self._flush()

    def restore(self, name: str, target: TrainState,
                device=None) -> Tuple[TrainState, dict]:
        """Load checkpoint `name` into `target` (its module, optimizer and
        step, in place) and hand it back with the meta record. Runs on the
        CUDA card unless `device` names another, and raises where
        `target.module` lies elsewhere; the tensors are read straight onto
        that device. Flushes pending writes first (a just-saved 'best' must
        be restorable)."""
        self._flush()
        device = _check_device(target.module, device)
        barrier(self.group)
        payload = torch.load(self._file(name), map_location=device,
                             weights_only=True)
        load_full_state_dict(target.module, payload["module"])
        target.optimizer.load_state_dict(payload["optimizer"])
        target.step = int(payload["step"])
        meta = {}
        if os.path.exists(self._meta_path(name)):
            with open(self._meta_path(name)) as f:
                meta = json.load(f)
        return target, meta

    def finalize(self) -> None:
        """Publish any in-flight save (call at the end of training)."""
        self._flush()

    # --- best/last policy ---
    def is_improvement(self, score: float, best: Optional[float]) -> bool:
        if best is None:
            return True
        return score > best if self.mode == "max" else score < best

    def save_eval(self, state: TrainState, score: float,
                  best_score: Optional[float], epoch: int) -> Optional[float]:
        """Save 'last' always; save 'best' on improvement. Returns the new
        best score (or the old one)."""
        meta = {"epoch": epoch, self.val_metric: score}
        self.save("last", state, meta)
        if self.is_improvement(score, best_score):
            self.save("best", state, meta)
            return score
        return best_score
