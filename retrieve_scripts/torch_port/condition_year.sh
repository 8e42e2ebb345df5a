#!/bin/bash
# Fingerprint + exact top-20 (CUDA kernels) retrieval for the RCR time split
# (role of reference retrieve/condition_year.sh).
python -m textreact_tpu_torch.retrieval.cli \
    --data_path data/USPTO_condition_year \
    --train_file USPTO_condition_train.csv \
    --valid_file USPTO_condition_val.csv \
    --test_file USPTO_condition_test.csv \
    --field canonical_rxn \
    --output_path output/USPTO_condition_year
