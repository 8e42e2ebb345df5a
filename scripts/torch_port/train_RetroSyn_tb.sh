#!/bin/bash
# Template-based retrosynthesis (USPTO-50K): encoder + atom/bond template
# classification heads; joint smiles_text encoder vocabulary.
# PyTorch port: --encoder is the local SciBERT directory that
# textreact_tpu_torch/models/import_hf.py reads (nothing is downloaded);
# on the card unless --device cpu.
SAVE_PATH=output/RetroSyn_tb_textreact
NN_PATH=data/Tevatron_output/RetroSyn/
mkdir -p ${SAVE_PATH}

python -m textreact_tpu_torch \
    --task retro \
    --template_based \
    --shuffle_smiles \
    --encoder data/scibert_scivocab_uncased \
    --encoder_pretrained \
    --encoder_tokenizer smiles_text \
    --vocab_file textreact_tpu_torch/assets/smiles_vocab.txt \
    --text_vocab_file data/scibert_scivocab_uncased/vocab.txt \
    --data_path data/RetroSyn/ \
    --template_path data/RetroSyn/template_based \
    --train_file train.csv \
    --valid_file valid.csv \
    --test_file test.csv \
    --corpus_file data/USPTO_rxn_corpus.csv \
    --nn_path ${NN_PATH} \
    --train_nn_file train_rank.json \
    --valid_nn_file valid_rank.json \
    --test_nn_file test_rank.json \
    --num_neighbors 3 \
    --use_gold_neighbor \
    --random_neighbor_ratio 0.2 \
    --save_path ${SAVE_PATH} \
    --load_ckpt best \
    --max_length 512 \
    --max_dec_length 160 \
    --mlm --mlm_ratio 0.15 --mlm_layer mlp --mlm_lambda 0.1 \
    --lr 1e-4 \
    --batch_size 128 \
    --test_batch_size 32 \
    --epochs 200 \
    --eval_per_epoch 10 \
    --warmup 0.02 \
    --do_train --do_valid --do_test \
    --num_beams 20 \
    --compute_dtype bfloat16
# attention_impl defaults to 'flash' (the CUDA kernels of
# textreact_tpu_torch/csrc, attention-prob dropout inside)
