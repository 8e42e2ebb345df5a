"""One-command real-data accuracy-parity run for the PyTorch port (twin of
scripts/parity_run.py).

Given the USPTO dataset artifacts (and, for RCR, a local SciBERT checkpoint
directory), this runs the reference training recipes end to end on the
PyTorch package: retrieval (when neighbor files are absent), train,
dual-corpus test. It writes the BASELINE.md accuracy rows to
<save_path>/parity_results.json, with the keys of scripts/parity_run.py's.

    python scripts/torch_port/parity_run.py --recipe RCR \
        --data_path data/RCR --corpus_file data/USPTO_rxn_corpus.csv \
        --nn_path data/Tevatron_output/RCR \
        --scibert data/scibert_scivocab_uncased --save_path output/parity_RCR

The recipes are scripts/parity_run.py's, with the port's assets and its bert_l6
preset in place of the JAX package's files. `--device` (default: the CUDA
card) goes to the retrieval command and to the training command; a CPU
rehearsal passes `--device cpu`. Every recipe default can be overridden
(--override "--epochs 1 --batch_size 8 ..."), which is how
tests/test_torch_parity_run.py smoke-tests this script on synthetic
fixtures.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

RECIPES = {
    # reference scripts/train_RCR.sh
    "RCR": {
        "task": "condition",
        "field": "canonical_rxn",
        "args": ["--vocab_file",
                 "textreact_tpu_torch/assets/condition_vocab.txt",
                 "--num_neighbors", "3", "--use_gold_neighbor",
                 "--max_length", "512", "--shuffle_smiles",
                 "--mlm", "--mlm_ratio", "0.15", "--mlm_layer", "mlp",
                 "--mlm_lambda", "0.1", "--lr", "1e-4",
                 "--batch_size", "128", "--epochs", "20",
                 "--warmup", "0.02", "--num_beams", "15",
                 "--compute_dtype", "bfloat16"],
    },
    # reference scripts/train_RetroSyn_tf.sh (template-free)
    "RetroSyn_tf": {
        "task": "retro",
        "field": "product_smiles",
        "args": ["--vocab_file",
                 "textreact_tpu_torch/assets/smiles_vocab.txt",
                 "--num_neighbors", "3", "--use_gold_neighbor",
                 "--max_length", "512", "--max_dec_length", "160",
                 "--shuffle_smiles", "--mlm", "--mlm_ratio", "0.15",
                 "--mlm_layer", "mlp", "--mlm_lambda", "0.1",
                 "--lr", "2e-4", "--batch_size", "128", "--epochs", "200",
                 "--warmup", "0.02", "--num_beams", "20",
                 "--compute_dtype", "bfloat16"],
    },
    # reference scripts/train_RetroSyn_tb.sh (template-based)
    "RetroSyn_tb": {
        "task": "retro",
        "field": "product_smiles",
        "args": ["--template_based", "--unattend_nonbonds",
                 "--num_neighbors", "3", "--use_gold_neighbor",
                 "--max_length", "512", "--lr", "2e-4",
                 "--batch_size", "128", "--epochs", "80",
                 "--warmup", "0.02", "--compute_dtype", "bfloat16"],
    },
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--recipe", required=True, choices=sorted(RECIPES))
    p.add_argument("--data_path", required=True)
    p.add_argument("--train_file", default="train.csv")
    p.add_argument("--valid_file", default="val.csv")
    p.add_argument("--test_file", default="test.csv")
    p.add_argument("--corpus_file", default=None)
    p.add_argument("--nn_path", default=None,
                   help="neighbor-file dir; built with the fingerprint "
                        "retriever when the {split}.json files are missing")
    p.add_argument("--nn_prefix", default="",
                   help="e.g. '' for retrieval-CLI output (train.json) or "
                        "tevatron-style names via --train_nn_file overrides")
    p.add_argument("--scibert", default=None,
                   help="local SciBERT dir (config.json + vocab.txt + "
                        "weights) for --encoder_pretrained; omit to train a "
                        "from-scratch encoder (config json path required "
                        "via --override)")
    p.add_argument("--template_path", default=None,
                   help="RetroSyn_tb: template CSVs; produced with "
                        "python -m textreact_tpu_torch.templates.processor "
                        "when absent")
    p.add_argument("--save_path", required=True)
    p.add_argument("--override", default="",
                   help="extra CLI args appended last (override recipe "
                        "defaults), e.g. '--epochs 1 --batch_size 8'")
    p.add_argument("--device", default=None,
                   help="torch device of the retrieval and training "
                        "commands (default: the CUDA card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from textreact_tpu_torch.cli.main import main as train_main
    from textreact_tpu_torch.retrieval.cli import main as retrieval_main

    recipe = RECIPES[args.recipe]
    device = ["--device", args.device] if args.device else []
    os.makedirs(args.save_path, exist_ok=True)

    # 1. neighbor files: reuse if present, else run the fingerprint retriever
    nn_path = args.nn_path or os.path.join(args.save_path, "nn")
    nn_files = {s: f"{args.nn_prefix}{n}.json"
                for s, n in (("train", "train"), ("valid", "val"),
                             ("test", "test"))}
    missing = [f for f in nn_files.values()
               if not os.path.exists(os.path.join(nn_path, f))]
    if missing:
        print(f"[parity_run] building neighbor files ({missing}) with the "
              f"fingerprint retriever (reference retrieve_faiss.py)")
        # the retriever writes unprefixed {train,val,test}.json: point the
        # run at those, not at absent tevatron-style prefixed names
        nn_files = {"train": "train.json", "valid": "val.json",
                    "test": "test.json"}
        retrieval_main([
            "--data_path", args.data_path,
            "--train_file", args.train_file,
            "--valid_file", args.valid_file,
            "--test_file", args.test_file,
            "--field", recipe["field"],
            "--output_path", nn_path, "--k", "20",
        ] + device)

    # 2. template preprocessing for the template-based recipe
    template_path = args.template_path
    if args.recipe == "RetroSyn_tb":
        template_path = template_path or os.path.join(args.save_path,
                                                      "templates")
        if not os.path.exists(os.path.join(template_path,
                                           "atom_templates.csv")):
            print("[parity_run] extracting templates "
                  "(reference get_templates.py)")
            from textreact_tpu_torch.templates.processor import \
                TemplateProcessor
            proc = TemplateProcessor(
                os.path.join(args.data_path, args.train_file),
                os.path.join(args.data_path, args.valid_file),
                os.path.join(args.data_path, args.test_file),
                template_path)
            proc.run()

    # 3. train + dual-corpus test
    cli = ["--task", recipe["task"], "--do_train", "--do_valid", "--do_test",
           "--data_path", args.data_path,
           "--train_file", args.train_file,
           "--valid_file", args.valid_file,
           "--test_file", args.test_file,
           "--nn_path", nn_path,
           "--train_nn_file", nn_files["train"],
           "--valid_nn_file", nn_files["valid"],
           "--test_nn_file", nn_files["test"],
           "--save_path", args.save_path]
    if args.corpus_file:
        cli += ["--corpus_file", args.corpus_file]
    if args.scibert:
        cli += ["--encoder", args.scibert, "--encoder_pretrained",
                "--text_vocab_file", os.path.join(args.scibert, "vocab.txt"),
                "--decoder", "bert_l6"]
    if template_path:
        cli += ["--template_path", template_path]
    cli += recipe["args"]
    cli += args.override.split()
    cli += device
    print(f"[parity_run] {' '.join(cli)}")
    accs = train_main(cli)

    # 4. record the BASELINE.md rows
    out = {"recipe": args.recipe, "argv": cli,
           "accuracy": accs if isinstance(accs, (list, dict)) else None}
    results = os.path.join(args.save_path, "parity_results.json")
    with open(results, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[parity_run] wrote {results}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
