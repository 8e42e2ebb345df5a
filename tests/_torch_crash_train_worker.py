"""Training worker for the port's crash-resume test (spawned by
test_torch_checkpoint.py): runs the port's train CLI on the CPU and, when
crash_at_step > 0, SIGKILLs its own process right before executing train
step crash_at_step + 1: a real kill -9 mid-epoch, after earlier epochs'
checkpoints have been published by the background writer.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    crash_at = int(sys.argv[1])  # 0 = run to completion
    argv = sys.argv[2:]
    if crash_at:
        import signal

        from textreact_tpu_torch.train import trainer as trainer_mod

        real = trainer_mod.make_train_step
        count = {"n": 0}

        def wrapped(*a, **kw):
            step = real(*a, **kw)

            def counting(state, batch, seed):
                count["n"] += 1
                if count["n"] > crash_at:
                    os.kill(os.getpid(), signal.SIGKILL)  # no cleanup, no atexit
                return step(state, batch, seed)

            return counting

        trainer_mod.make_train_step = wrapped

    from textreact_tpu_torch.cli.main import main as train_main

    train_main(argv + ["--device", "cpu"])


if __name__ == "__main__":
    main()
