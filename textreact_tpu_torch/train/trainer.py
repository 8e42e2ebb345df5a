"""Training/eval/test orchestration (twin of textreact_tpu/train/trainer.py).

Role of reference main.py:100-412 (LightningModule + DataModule + Trainer):
epoch loop with one eager update per optimizer step, dual-corpus evaluation
every eval_per_epoch epochs, best/last checkpointing on the val metric,
resume, beam-search testing with prediction JSON + accuracy dicts.

One process per device. Started alone it runs on one device; started by
`torchrun` (`python -m torch.distributed.run --nproc_per_node N -m
textreact_tpu_torch ...`; NCCL between cards, gloo with `--device cpu`)
its processes form the (dp, tp) mesh of cfg.dp_size x cfg.tp_size
(trainer.py:49-50): the parameters are cut by `shard_params`, each rank
loads the rows of its dp index (batch_size / dp of them a step, a global
batch of batch_size), the step reduces over the mesh (train/step.py), the
validation scores and test predictions are gathered id-keyed from every
rank, and rank 0 alone writes metrics, predictions and checkpoints. With
dp > 1 the collator pads every batch to one shape (`static_shapes`), so
that the ranks' accumulation windows stay in step. The trainer runs on the
CUDA card unless the caller passes `device=`; without a card it raises.

Parameters come from `build_model`, drawn from `cfg.seed`. With
`--encoder_pretrained` and an `--encoder` that is a local HF checkpoint
directory, and with `--decoder_pretrained` (whose `--decoder` must be one),
`models/import_hf.py` then copies the checkpoint's weights in, before
`shard_params` cuts them and before any checkpoint is restored.

Template-based retrosynthesis (--template_based) trains the encoder and the
atom/bond template heads, validates with the greedy template top-1, and
tests by ranking the top 500 edits on the device and decoding them through
the template engine.
"""

from __future__ import annotations

import json
import math
import os
import random as _random
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..data import (DATASET_CLS, Batch, Collator, DataLoader,
                    gather_prediction_each_neighbor,
                    generate_train_label_corpus, read_corpus)
from ..evaluation import (edits_from_topk, evaluate_reaction_condition,
                          evaluate_retrosynthesis)
from ..inference.predictor import Generator, predictions_from_beams
from ..models import build_model
from ..models.factory import resolve_device
from ..models.import_hf import load_pretrained_decoder, load_pretrained_encoder
from ..parallel.mesh import make_mesh
from ..parallel.multihost import (gather_prediction_dict, gather_score_dict,
                                  initialize_distributed, is_primary,
                                  local_device)
from ..parallel.sharding import shard_params
from ..tokenizers import get_tokenizers
from ..utils.logging import MetricLogger, log, setup_logging
from ..utils.profiling import StepTimer, span, trace
from .checkpoint import CheckpointManager
from .optim import make_optimizer
from .step import (TrainState, make_accum_train_step, make_eval_step,
                   make_train_step)


class _NoMetrics:
    """The metric log of a rank other than 0: writes nothing."""

    def log(self, metrics, step) -> None:
        pass


class Trainer:
    def __init__(self, cfg: ExperimentConfig, device=None):
        setup_logging()
        cfg.validate()
        self.cfg = cfg
        self.train_route: Optional[str] = None   # fit's train step's route
        # the template-based test pass's eval step (`_eval_record`)
        self.test_eval: Dict[str, Any] = {}
        # under torchrun: card LOCAL_RANK, and the process group
        self.device = local_device(resolve_device(device))
        initialize_distributed(device=self.device)
        # None: one process, no collective
        self.mesh = (make_mesh(cfg.dp_size, cfg.tp_size)
                     if torch.distributed.is_initialized() else None)
        if self.mesh is None and (cfg.dp_size > 1 or cfg.tp_size > 1):
            raise ValueError(f"dp_size={cfg.dp_size} x tp_size="
                             f"{cfg.tp_size} needs that many processes: "
                             f"start the run with torchrun")
        _random.seed(cfg.seed)
        np.random.seed(cfg.seed)

        if cfg.decoder_pretrained:
            # reference model.py:22-24: decoder half loaded from a BERT
            # checkpoint (cross-attention freshly initialized)
            if cfg.template_based:
                raise ValueError("--decoder_pretrained requires a seq2seq "
                                 "decoder (not --template_based)")
            if not (cfg.decoder and os.path.isdir(cfg.decoder)):
                raise ValueError(
                    "--decoder_pretrained needs --decoder to point at a local "
                    f"HF checkpoint directory, got {cfg.decoder!r}")
        self.enc_tokenizer, self.dec_tokenizer = get_tokenizers(cfg)
        # parameters are initialised here, from cfg.seed, then the
        # pretrained ones imported whole, then cut for the mesh
        self.module, self.enc_config, self.dec_config = build_model(
            cfg, self.enc_tokenizer, self.dec_tokenizer, device=self.device)
        self.pretrained_keys = self._import_pretrained()
        shard_params(self.mesh, self.module)
        self.ckpt = CheckpointManager(cfg.save_path, cfg.val_metric,
                                      mesh=self.mesh)
        self.metrics = (MetricLogger(cfg.save_path, use_wandb=not cfg.debug)
                        if is_primary() else _NoMetrics())
        if cfg.template_based:
            self.dec_pad_id = 0
        else:
            self.dec_pad_id = self.dec_tokenizer.pad_token_id
        self.dp_size = 1 if self.mesh is None else self.mesh.dp_size
        self.collator = Collator(cfg, self.enc_tokenizer.pad_token_id,
                                 self.dec_pad_id,
                                 static_shapes=self.dp_size > 1)
        self.train_dataset = None
        self.val_dataset = None
        self.test_dataset = None
        self._state: Optional[TrainState] = None

    def _import_pretrained(self) -> Dict[str, set]:
        """Copy the HF checkpoints' weights into the module; returns, by
        part, the names of the file's tensors that were read."""
        cfg = self.cfg
        read: Dict[str, set] = {}
        t0 = time.perf_counter()
        if cfg.encoder_pretrained and cfg.encoder and os.path.isdir(cfg.encoder):
            read["encoder"] = load_pretrained_encoder(
                self.module.encoder, cfg.encoder, self.enc_config)
        if cfg.decoder_pretrained:
            read["decoder"] = load_pretrained_decoder(
                self.module.decoder, cfg.decoder, self.dec_config)
        self.import_seconds = time.perf_counter() - t0
        if read:
            log.info("imported %s from HF checkpoints in %.2f s",
                     {k: len(v) for k, v in read.items()},
                     self.import_seconds)
        return read

    # ------------------------------------------------------------------
    # data (reference main.py:279-346)
    # ------------------------------------------------------------------
    def prepare_data(self) -> None:
        cfg = self.cfg
        dataset_cls = DATASET_CLS[cfg.task]

        def build(file, split):
            ds = dataset_cls(cfg, os.path.join(cfg.data_path, file),
                             self.enc_tokenizer, self.dec_tokenizer, split=split)
            log.info("%s dataset: %d", split, len(ds))
            return ds

        if cfg.do_train:
            self.train_dataset = build(cfg.train_file, "train")
        if cfg.do_train or cfg.do_valid:
            self.val_dataset = build(cfg.valid_file, "val")
        if cfg.do_test:
            self.test_dataset = build(cfg.test_file, "test")
        if cfg.corpus_file:
            if cfg.train_label_corpus:
                corpus = generate_train_label_corpus(
                    os.path.join(cfg.data_path, cfg.train_file))
            else:
                corpus = read_corpus(cfg.corpus_file, cfg.cache_path)
            nn = lambda f: os.path.join(cfg.nn_path, f)
            if self.train_dataset is not None:
                self.train_dataset.load_corpus(corpus, nn(cfg.train_nn_file))
                self._print_example(self.train_dataset)
            if self.val_dataset is not None:
                self.val_dataset.load_corpus(corpus, nn(cfg.valid_nn_file))
            if self.test_dataset is not None:
                self.test_dataset.load_corpus(corpus, nn(cfg.test_nn_file))

    def _print_example(self, dataset) -> None:
        """Decode + log the first train example (reference dataset.py:154-168)."""
        ex = dataset.example(0, rng=_random.Random(0), augment=False)
        log.info("example encoder input: %s",
                 self.enc_tokenizer.decode(ex["input_ids"]))
        if not self.cfg.template_based and "decoder_input_ids" in ex:
            log.info("example decoder input: %s",
                     self.dec_tokenizer.decode(ex["decoder_input_ids"]))

    def _loaders(self, dataset, eval_mode: bool) -> List[DataLoader]:
        cfg = self.cfg
        bs = cfg.test_batch_size if dataset is self.test_dataset else cfg.batch_size
        # background-thread prefetch overlaps host batch assembly with device
        # steps; the loader's fork-pool mode (num_workers>1) is for offline
        # use: forking after the CUDA runtime initializes is unsafe
        # on a mesh: the rows of this rank's dp index, a 1/dp share of the
        # global batch (the tp ranks of a row load the same rows)
        kw = dict(collator=self.collator, batch_size=bs // self.dp_size,
                  seed=cfg.seed)
        if not eval_mode:
            loaders = [DataLoader(dataset, shuffle=True, **kw)]
        else:
            loaders = [DataLoader(dataset, shuffle=False, augment=False, **kw)]
            if cfg.corpus_file:
                # dual-corpus eval: full + gold-removed (main.py:330-340)
                loaders.append(DataLoader(dataset.with_skip_gold(),
                                          shuffle=False, augment=False, **kw))
        if self.mesh is not None:
            for loader in loaders:
                loader.shard_across_processes(self.mesh.dp_rank,
                                              self.mesh.dp_size)
        return loaders

    # ------------------------------------------------------------------
    # model state
    # ------------------------------------------------------------------
    def _new_state(self, num_steps: int) -> TrainState:
        optimizer = make_optimizer(self.cfg, num_steps,
                                   self.module.named_parameters(),
                                   mesh=self.mesh,
                                   tp_axes=self.module.tp_axes)
        return TrainState.create(self.module, optimizer)

    def _num_training_steps(self) -> int:
        cfg = self.cfg
        steps_per_epoch = math.ceil(
            len(self.train_dataset)
            / (cfg.batch_size * cfg.gradient_accumulation_steps))
        return steps_per_epoch * cfg.epochs

    # ------------------------------------------------------------------
    # fit (reference main.py:386-397)
    # ------------------------------------------------------------------
    def fit(self) -> None:
        cfg = self.cfg
        num_steps = self._num_training_steps()
        log.info("num training steps: %d", num_steps)
        accum = max(1, cfg.gradient_accumulation_steps)

        start_epoch, best_score = 0, None
        if cfg.overwrite:
            self.ckpt.clear()
        state = self._new_state(num_steps)
        if self.ckpt.exists(cfg.load_ckpt):
            state, meta = self.ckpt.restore(cfg.load_ckpt, state,
                                            device=self.device)
            start_epoch = int(meta.get("epoch", -1)) + 1
            best_score = meta.get(cfg.val_metric)
            log.info("resumed from %s at epoch %d", cfg.load_ckpt, start_epoch)
            # durable resume record (crash-recovery evidence)
            self.metrics.log({"resumed_from": cfg.load_ckpt,
                              "resumed_at_epoch": start_epoch},
                             int(state.step))

        if accum > 1:
            train_step = make_accum_train_step(
                self.module, cfg, state.optimizer, self.dec_pad_id,
                device=self.device)
        else:
            train_step = make_train_step(
                self.module, cfg, state.optimizer, self.dec_pad_id,
                device=self.device)
        # on one card the step's two parts run as CUDA graphs, captured at
        # each shape bucket's first step (after the restore above, which
        # copies into the buffers they read) and replayed after
        # (a caller's wrapper around `make_train_step` may not carry it);
        # the eval step's forward the same, one step for every epoch's
        # validation, so its graphs persist across epochs
        self.train_route = getattr(train_step, "route", None)
        eval_step = self._eval_step(edit_topk=1)
        log.info("train step route: %s; eval step route: %s",
                 self.train_route, eval_step.route)

        # every dropout mask of a step is drawn from a generator reseeded
        # from (this seed, state.step), and state.step is in the checkpoint:
        # a resumed run replays the masks of an uninterrupted one
        seed = cfg.seed
        loader = self._loaders(self.train_dataset, eval_mode=False)[0]
        timer = StepTimer()
        global_step = int(state.step)
        profile_dir = os.path.join(cfg.save_path, "profile") if cfg.profile else None
        # Accumulation microbatches are buffered PER SHAPE BUCKET: the
        # collator pads to length buckets, so consecutive loader batches can
        # have different shapes and cannot be stacked together. Each bucket
        # accumulates independently and flushes when it holds `accum`
        # microbatches; at epoch end, partial buffers are padded with
        # weight-0 copies so the step always sees `accum` microbatches of
        # one shape.
        micro_buffers: Dict[Any, List[Dict[str, np.ndarray]]] = {}

        def shape_key(b: Dict[str, np.ndarray]):
            return tuple(sorted((k, v.shape) for k, v in b.items()))

        def stacked(buffer, n_real):
            buffer = buffer + [buffer[0]] * (accum - len(buffer))
            mbs = {k: np.stack([b[k] for b in buffer]) for k in buffer[0]}
            weights = np.asarray(
                [1.0] * n_real + [0.0] * (accum - n_real), np.float32)
            return mbs, weights

        with trace(profile_dir):
            for epoch in range(start_epoch, cfg.epochs):
                loader.set_epoch(epoch)
                t0, step0 = self._clock(), global_step
                batches = iter(loader)
                while True:
                    with span("train.loader_wait"):
                        batch = next(batches, None)
                    if batch is None:
                        break
                    if accum > 1:
                        # accumulate N loader batches per optimizer step
                        # (reference accumulate_grad_batches, main.py:381)
                        arrays = dict(batch.arrays)
                        buf = micro_buffers.setdefault(shape_key(arrays), [])
                        buf.append(arrays)
                        if len(buf) < accum:
                            continue
                        mbs, weights = stacked(buf, accum)
                        buf.clear()
                        state, metrics = train_step(state, mbs, weights, seed)
                    else:
                        state, metrics = train_step(state, batch, seed)
                    timer.tick()
                    global_step += 1
                    if global_step % cfg.log_every == 0:
                        host = {k: float(v) for k, v in metrics.items()}
                        host["steps_per_sec"] = timer.steps_per_sec
                        host["epoch"] = epoch
                        self.metrics.log(host, global_step)
                for buf in micro_buffers.values():
                    if not buf:
                        continue
                    # flush a trailing partial window, padded to the full
                    # accumulation extent with weight-0 microbatches
                    mbs, weights = stacked(buf, len(buf))
                    buf.clear()
                    state, metrics = train_step(state, mbs, weights, seed)
                    global_step += 1
                self._accum_group_count = len(micro_buffers)
                # the epoch's optimizer steps and their seconds, loader
                # waits included, read once the device has finished them
                timing = {"epoch": epoch, "epoch_steps": global_step - step0,
                          "epoch_seconds": self._clock() - t0}
                if (epoch + 1) % cfg.eval_per_epoch == 0 and self.val_dataset is not None:
                    t0 = self._clock()
                    scores = self._run_validation(eval_step)
                    timing.update(self._eval_record(eval_step),
                                  val_seconds=self._clock() - t0)
                    self.metrics.log(scores, global_step)
                    log.info("epoch %d: %s", epoch, scores)
                    t0 = time.perf_counter()
                    best_score = self.ckpt.save_eval(
                        state, scores[cfg.val_metric], best_score, epoch)
                else:
                    t0 = time.perf_counter()
                    self.ckpt.save("last", state, {"epoch": epoch})
                # how long the save calls held the loop (a second save waits
                # for the first one's write), and of that the last copy to
                # the host; the last write goes on in the background
                timing["save_blocking_seconds"] = time.perf_counter() - t0
                timing["save_copy_seconds"] = self.ckpt.last_blocking_seconds
                self.metrics.log(timing, global_step)
        self.ckpt.finalize()  # publish the overlapped final save
        self.metrics.log(
            {"save_write_seconds": self.ckpt.last_write_seconds}, global_step)
        self._state = state

    def _clock(self) -> float:
        """Host seconds, after the device has finished what was queued."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _eval_step(self, edit_topk: int = 500):
        """An eval step of this trainer's module, on its device."""
        return make_eval_step(self.module, self.cfg, self.dec_pad_id,
                              edit_topk=edit_topk, device=self.device)

    @staticmethod
    def _eval_record(eval_step) -> Dict[str, Any]:
        """The eval step's route, the shape keys it has captured and the
        replays of their graphs, for metrics.jsonl."""
        keys = [] if eval_step.graphs is None else list(
            eval_step.graphs.keys.values())
        return {"eval_route": eval_step.route, "eval_keys": len(keys),
                "eval_replays": sum(k.forward.replays for k in keys)}

    # ------------------------------------------------------------------
    # validation (reference main.py:177-196)
    # ------------------------------------------------------------------
    def _run_validation(self, eval_step) -> Dict[str, float]:
        cfg = self.cfg
        out: Dict[str, float] = {}
        for li, loader in enumerate(self._loaders(self.val_dataset, True)):
            per_example: Dict[int, float] = {}
            for batch in loader:
                res = eval_step(batch)
                key = "acc" if cfg.val_metric == "val_acc" and "acc" in res else "loss"
                if cfg.template_based and cfg.val_metric == "val_acc":
                    scores = self._template_top1(res, batch)
                else:
                    scores = res[key].float().cpu().numpy()
                mask = res["example_mask"].cpu().numpy().astype(bool)
                idxs = res["indices"].cpu().numpy()
                for i, s in zip(idxs[mask], scores[mask]):
                    per_example[int(i)] = float(s)
            # every rank's examples, id-keyed (padding repeats collapse)
            per_example = gather_score_dict(per_example)
            name = cfg.val_metric if li == 0 else f"{cfg.val_metric}/{li}"
            out[name] = float(np.mean(list(per_example.values())))
        return out

    def _topk_edits(self, res) -> tuple:
        """The eval step's top-k edit values and indices, on the host."""
        return tuple(res[k].cpu().numpy() for k in (
            "atom_topk_vals", "atom_topk_idx", "bond_topk_vals",
            "bond_topk_idx"))

    def _template_top1(self, res, batch: Batch) -> np.ndarray:
        """Greedy template accuracy (reference main.py:139-149): top-ranked
        edit in the gold raw label set, scaled by 1/len(labels). The edit
        ranking itself runs on the device (device_topk_edits in the eval
        step); only the two per-example top-1 candidates reach the host."""
        av, ai, bv, bi = self._topk_edits(res)
        n_a1 = self.module.num_atom_templates + 1
        n_b1 = self.module.num_bond_templates + 1
        out = np.zeros((av.shape[0],), dtype=np.float32)
        for b, (bonds, raw) in enumerate(zip(batch.host["bonds"],
                                             batch.host["raw_template_labels"])):
            edits, _ = edits_from_topk(av[b], ai[b], bv[b], bi[b],
                                       n_a1, n_b1, bonds, top_num=1)
            hit = bool(edits) and edits[0] in [tuple(r) for r in raw]
            out[b] = float(hit) / max(len(raw), 1)
        return out

    def validate(self) -> Dict[str, float]:
        state = self._load_for_eval()
        eval_step = self._eval_step()
        t0 = self._clock()
        scores = self._run_validation(eval_step)
        record = dict(self._eval_record(eval_step),
                      val_seconds=self._clock() - t0)
        self.metrics.log(record, int(state.step))
        log.info("validation: %s (%s)", scores, record)
        return scores

    # ------------------------------------------------------------------
    # test (reference main.py:198-257)
    # ------------------------------------------------------------------
    def test(self) -> List[Dict]:
        cfg = self.cfg
        self._load_for_eval()
        results = []   # rank 0's; the other ranks return []
        for li, loader in enumerate(self._loaders(self.test_dataset, True)):
            t0 = self._clock()
            # every rank's predictions, id-keyed (padding repeats collapse)
            predictions = gather_prediction_dict(self._predict(loader))
            self.metrics.log(dict(self.test_eval, test_loader=li,
                                  test_examples=len(predictions),
                                  test_seconds=self._clock() - t0),
                             int(self._state.step))
            if not is_primary():   # rank 0 writes and scores
                continue
            if cfg.test_each_neighbor:
                predictions = gather_prediction_each_neighbor(
                    predictions, cfg.test_num_neighbors)
            path = os.path.join(
                cfg.save_path, f"prediction_{self.test_dataset.name}_{li}.json")
            with open(path, "w") as f:
                json.dump(predictions, f)
            if cfg.task == "condition":
                accuracy = evaluate_reaction_condition(
                    predictions, self.test_dataset.data_df)
            else:
                accuracy = evaluate_retrosynthesis(
                    predictions, self.test_dataset.data_df, cfg.num_beams,
                    template_based=cfg.template_based,
                    template_path=cfg.template_path,
                    num_workers=min(16, os.cpu_count() or 1))
            log.info("test accuracy (%d): %s", li, accuracy)
            print(json.dumps({str(k): v for k, v in accuracy.items()}))
            results.append(accuracy)
        return results

    def _predict(self, loader) -> Dict[int, Dict[str, Any]]:
        cfg = self.cfg
        predictions: Dict[int, Dict[str, Any]] = {}
        if cfg.template_based:
            # top-500 edit ranking on the device (reference combined_edit
            # top 500, main.py:211-216): the host receives 2 x 500
            # candidates an example instead of the full probability grids
            eval_step = self._eval_step(edit_topk=500)
            n_a1 = self.module.num_atom_templates + 1
            n_b1 = self.module.num_bond_templates + 1
            for batch in loader:
                res = eval_step(batch)
                av, ai, bv, bi = self._topk_edits(res)
                mask = res["example_mask"].cpu().numpy().astype(bool)
                idxs = res["indices"].cpu().numpy()
                for b in np.nonzero(mask)[0]:
                    bonds = batch.host["bonds"][b]
                    raw = [tuple(r) for r in batch.host["raw_template_labels"][b]]
                    edits, probs = edits_from_topk(av[b], ai[b], bv[b], bi[b],
                                                   n_a1, n_b1, bonds,
                                                   top_num=500)
                    predictions[int(idxs[b])] = {
                        "prediction": edits,
                        "score": probs,
                        "raw_template_labels": raw,
                        "top1_template_match": bool(edits) and edits[0] in raw,
                    }
            self.test_eval = self._eval_record(eval_step)
            log.info("test pass eval step: %s", self.test_eval)
            return predictions
        generator = Generator(self.module, cfg.num_beams, cfg.max_dec_length)
        for batch in loader:
            seqs, scores = generator.generate(batch.arrays)
            predictions.update(predictions_from_beams(
                seqs, scores, batch.arrays["indices"],
                batch.arrays["example_mask"], self.dec_tokenizer))
        return predictions

    def _load_for_eval(self) -> TrainState:
        """The state to evaluate: the one fit() left, else the checkpoint
        `load_ckpt` (or 'best') loaded into this trainer's module, else the
        fresh initialisation."""
        cfg = self.cfg
        if self._state is not None:
            return self._state
        state = self._new_state(max(1, self._safe_num_steps()))
        name = cfg.load_ckpt if self.ckpt.exists(cfg.load_ckpt) else "best"
        if self.ckpt.exists(name):
            state, _ = self.ckpt.restore(name, state, device=self.device)
            log.info("loaded checkpoint: %s", name)
        else:
            log.warning("no checkpoint found in %s; evaluating random init",
                        cfg.save_path)
        self._state = state
        return state

    def _safe_num_steps(self) -> int:
        if self.train_dataset is not None:
            return self._num_training_steps()
        return 1000


def run(cfg: ExperimentConfig, device=None):
    """The whole experiment (reference main.py:349-412), on the CUDA card
    unless `device` names another. Returns the test accuracy dicts (one per
    eval corpus) when --do_test ran, else None."""
    trainer = Trainer(cfg, device=device)
    trainer.prepare_data()
    if cfg.do_train:
        trainer.fit()
    if cfg.do_valid:
        trainer.validate()
    if cfg.do_test:
        return trainer.test()
    return None
