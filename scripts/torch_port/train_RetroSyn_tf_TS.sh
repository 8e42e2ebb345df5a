#!/bin/bash
# Template-free retrosynthesis (USPTO-50K), random split — seq2seq decoder
# over the SMILES vocab, beam 20.
# PyTorch port: --encoder is the local SciBERT directory that
# textreact_tpu_torch/models/import_hf.py reads (nothing is downloaded),
# --decoder the port's bert_l6 preset; on the card unless --device cpu.
SAVE_PATH=output/RetroSyn_tf_TS_textreact
NN_PATH=data/Tevatron_output/RetroSyn_TS/
mkdir -p ${SAVE_PATH}

python -m textreact_tpu_torch \
    --task retro \
    --encoder data/scibert_scivocab_uncased \
    --decoder bert_l6 \
    --encoder_pretrained \
    --vocab_file textreact_tpu_torch/assets/smiles_vocab.txt \
    --text_vocab_file data/scibert_scivocab_uncased/vocab.txt \
    --data_path data/RetroSyn_TS/ \
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
    --eval_per_epoch 25 \
    --warmup 0.02 \
    --do_train --do_valid --do_test \
    --num_beams 20 \
    --compute_dtype bfloat16
# attention_impl defaults to 'flash' (the CUDA kernels of
# textreact_tpu_torch/csrc, attention-prob dropout inside)
