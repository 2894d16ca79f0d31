"""Runnable examples of the port (twins of the repo's ``examples/``):

    python -m repro_torch.examples.quickstart [--n 20000] [--device cuda]
    python -m repro_torch.examples.serve_knn [--n 50000] [--batches 5]
    python -m repro_torch.examples.train_lm [--arch qwen3-0.6b] [--steps 200]
    python -m repro_torch.examples.knnlm_serve [--device cuda]

Each has a ``main(argv)`` that prints as it goes and returns the values
its checks rest on.
"""
