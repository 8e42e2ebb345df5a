#!/bin/bash
# RCR time split (train/val/test partitioned by patent year).
# bf16 compute replaces fp16-mixed, and --text_vocab_file points at a local
# SciBERT WordPiece vocab.
# PyTorch port: --encoder is the local SciBERT directory that
# textreact_tpu_torch/models/import_hf.py reads (nothing is downloaded),
# --decoder the port's bert_l6 preset; on the card unless --device cpu.
SAVE_PATH=output/RCR_TS_textreact
NN_PATH=data/Tevatron_output/RCR_TS/
mkdir -p ${SAVE_PATH}

python -m textreact_tpu_torch \
    --task condition \
    --encoder data/scibert_scivocab_uncased \
    --decoder bert_l6 \
    --encoder_pretrained \
    --data_path data/RCR_TS/ \
    --train_file train.csv \
    --valid_file val.csv \
    --test_file test.csv \
    --vocab_file textreact_tpu_torch/assets/condition_vocab.txt \
    --text_vocab_file data/scibert_scivocab_uncased/vocab.txt \
    --corpus_file data/USPTO_rxn_corpus.csv \
    --nn_path ${NN_PATH} \
    --train_nn_file train_rank.json \
    --valid_nn_file val_rank_full.json \
    --test_nn_file test_rank_full.json \
    --num_neighbors 3 \
    --use_gold_neighbor \
    --save_path ${SAVE_PATH} \
    --max_length 512 \
    --shuffle_smiles \
    --mlm --mlm_ratio 0.15 --mlm_layer mlp --mlm_lambda 0.1 \
    --lr 1e-4 \
    --batch_size 128 \
    --epochs 20 \
    --warmup 0.02 \
    --do_train --do_valid --do_test \
    --num_beams 15 \
    --compute_dtype bfloat16
# attention_impl defaults to 'flash' (the CUDA kernels of
# textreact_tpu_torch/csrc, attention-prob dropout inside)
