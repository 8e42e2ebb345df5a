"""Experiment configuration (own copy of textreact_tpu/config.py).

One dataclass covering the reference's full CLI flag surface
(reference main.py:26-97) plus the framework's extras (dtypes, length
buckets, kernel switches). Every field of the JAX package's dataclass is
kept, with the same default, so one set of flags describes a run in either
package; fields that only the JAX runtime reads are marked. The port runs
one process on one device: `validate` raises for the mesh options
(`dp_size > 1`, `tp_size > 1`, `zero1`) until the multi-GPU slice
(ROADMAP.md Queue 1 item 8) ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class ExperimentConfig:
    # Task / run mode (reference main.py:28-36)
    task: str = "condition"            # 'condition' | 'retro'
    do_train: bool = False
    do_valid: bool = False
    do_test: bool = False
    seed: int = 42
    debug: bool = False

    # Model (reference main.py:38-45)
    template_based: bool = False
    unattend_nonbonds: bool = False
    encoder: Optional[str] = None       # encoder config name/path or HF ckpt dir
    decoder: Optional[str] = None       # decoder config json path
    encoder_pretrained: bool = False
    decoder_pretrained: bool = False
    share_embedding: bool = False
    encoder_tokenizer: str = "text"     # 'smiles' | 'text' | 'smiles_text'

    # Data (reference main.py:47-72)
    data_path: Optional[str] = None
    template_path: Optional[str] = None
    train_file: Optional[str] = None
    valid_file: Optional[str] = None
    test_file: Optional[str] = None
    vocab_file: Optional[str] = None
    text_vocab_file: Optional[str] = None   # NEW: WordPiece vocab for text tokenizer
    corpus_file: Optional[str] = None
    train_label_corpus: bool = False
    cache_path: Optional[str] = None
    nn_path: Optional[str] = None
    train_nn_file: Optional[str] = None
    valid_nn_file: Optional[str] = None
    test_nn_file: Optional[str] = None
    max_length: int = 128
    max_dec_length: int = 128
    num_workers: int = 8
    shuffle_smiles: bool = False
    no_smiles: bool = False
    num_neighbors: int = -1
    use_gold_neighbor: bool = False
    max_num_neighbors: int = 10
    random_neighbor_ratio: float = 0.8
    mlm: bool = False
    mlm_ratio: float = 0.15
    mlm_layer: str = "linear"           # 'linear' | 'mlp'
    mlm_lambda: float = 1.0
    mlm_impl: str = "fused"             # 'fused' (linear+CE fold) | 'xla'

    # Training (reference main.py:74-88)
    epochs: int = 8
    batch_size: int = 256               # GLOBAL batch size
    lr: float = 1e-4
    weight_decay: float = 0.01
    max_grad_norm: float = 5.0
    scheduler: str = "cosine"           # 'cosine' | 'constant'
    warmup_ratio: float = 0.0
    gradient_accumulation_steps: int = 1
    load_ckpt: str = "best"
    eval_per_epoch: int = 1
    val_metric: str = "val_acc"         # 'val_acc' | 'val_loss'
    save_path: str = "output/"
    overwrite: bool = False
    num_train_example: Optional[int] = None
    label_smoothing: float = 0.0

    # Inference (reference main.py:90-93)
    test_batch_size: int = 64
    num_beams: int = 1
    test_each_neighbor: bool = False
    test_num_neighbors: int = 1

    # --- framework extras (no reference equivalent) ---
    dp_size: int = -1                   # -1: every process not on the tp axis
    tp_size: int = 1                    # tensor-parallel ranks a row
    param_dtype: str = "float32"        # 'float32' (training) | 'compute':
    #                                     store weights pre-cast (serving)
    compute_dtype: str = "bfloat16"
    length_buckets: Tuple[int, ...] = (64, 128, 256, 384, 512)
    dec_length_buckets: Tuple[int, ...] = (16, 32, 64, 96, 128, 160)
    log_every: int = 10
    # 'flash' = the fused attention kernel where its shape rules allow,
    # 'xla' = the plain functions everywhere (the JAX package's flag names)
    attention_impl: str = "flash"
    # 'fused' = the residual + dropout + LayerNorm kernel; engages only when
    # hidden_size % 128 == 0, else the plain function
    layernorm_impl: str = "fused"
    # beam-decode QK score storage: model dtype (default) or 'float32'
    # for bit-strict score parity (see models/config.py)
    decode_scores_dtype: str = "bfloat16"
    dropout_rng_impl: str = "unsafe_rbg"   # JAX runtime only: the port's
    #                                     masks come from a torch.Generator
    zero1: bool = False                 # shard AdamW moments over dp
    profile: bool = False               # torch.profiler trace of fit()
    #                                     under save_path/profile
    remat: bool = False                 # recompute each encoder block in
    #                                     the backward (torch.utils.checkpoint)

    def validate(self) -> "ExperimentConfig":
        assert self.task in ("condition", "retro"), self.task
        assert self.scheduler in ("cosine", "constant"), self.scheduler
        assert self.val_metric in ("val_acc", "val_loss"), self.val_metric
        assert self.encoder_tokenizer in ("smiles", "text", "smiles_text")
        assert self.mlm_impl in ("fused", "xla"), self.mlm_impl
        if self.template_based:
            assert self.template_path is not None
        assert self.dp_size == -1 or self.dp_size >= 1, self.dp_size
        assert self.tp_size >= 1, self.tp_size
        return self


def bucket_length(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n (last bucket caps/truncates)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
