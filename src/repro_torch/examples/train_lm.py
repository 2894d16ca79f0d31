"""End-to-end training example: train a small LM (any of the ten
architectures, reduced preset) for a few hundred steps with checkpointing
(the port's twin of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --arch qwen3-0.6b \
        --steps 200 [--device cuda]

Equivalent to:  python -m repro_torch.launch.train --preset small ...
"""

import sys


def main(argv=None):
    """``launch.train.main`` with 200 steps unless ``--steps`` is given;
    returns the losses."""
    from repro_torch.launch.train import main as train_main

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--steps" not in argv:
        argv += ["--steps", "200"]
    return train_main(argv)


if __name__ == "__main__":
    main()
