"""`python -m textreact_tpu_torch` -> the training/eval CLI."""

from .cli.main import main

if __name__ == "__main__":
    main()
