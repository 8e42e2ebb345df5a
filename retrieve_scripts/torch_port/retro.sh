#!/bin/bash
# Morgan-fingerprint retrieval for USPTO-50K retro (reference retrieve/retro.sh).
python -m textreact_tpu_torch.retrieval.cli \
    --data_path data/USPTO_50K/matched1 \
    --train_file train.csv \
    --valid_file valid.csv \
    --test_file test.csv \
    --field product_smiles \
    --output_path output/USPTO_50K
