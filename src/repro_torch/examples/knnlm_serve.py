"""kNN-LM: TrueKNN as the retrieval engine behind an LM (paper Sec 6.2's
PCA bridge, implemented end-to-end; the port's twin of
``examples/knnlm_serve.py``).

Trains a tiny LM briefly, builds a datastore of (hidden state -> next token)
pairs from training text, then serves next-token predictions interpolating
the LM softmax with TrueKNN retrieval.  Retrieval must (and does) improve
perplexity on repeats of *seen* data — the kNN-LM sanity check.

    PYTHONPATH=src python -m repro_torch.examples.knnlm_serve [--device cuda]
"""

import argparse

import numpy as np

LAMBDAS = (0.1, 0.25, 0.5)


def main(argv=None):
    """Returns ``{"loss": last training loss, "lm": LM-only perplexity,
    "knn": {lam: kNN-LM perplexity}}`` on the seen batch."""
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.knnlm import build_datastore, interpolate, knn_logprobs
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models import forward, init_params, loss_fn
    from repro_torch.models.model import _unembed_weight
    from repro_torch.optim import adamw_init, adamw_update

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config(get_config("smollm-135m"))
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt = adamw_init(model)
    stream = SyntheticLMStream(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8)
    )

    def on_device(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    # -- brief training ------------------------------------------------------
    for s in range(60):
        loss, _ = loss_fn(model, cfg, on_device(stream.batch_at(s)))
        loss.backward()
        adamw_update(model, {n: p.grad for n, p in model.named_parameters()},
                     opt, 3e-3)
        model.zero_grad(set_to_none=True)
    loss = float(loss.detach())
    print(f"trained 60 steps, loss {loss:.3f}")

    # -- datastore from training data ----------------------------------------
    def hidden(tokens):
        with torch.no_grad():
            x, _ = forward(model, cfg, torch.from_numpy(tokens).to(dev))
        return x.float().cpu().numpy()

    hid, tgt = [], []
    for s in range(20):
        b = stream.batch_at(s)
        hid.append(hidden(b["tokens"]).reshape(-1, cfg.d_model))
        tgt.append(b["labels"].reshape(-1))
    store = build_datastore(np.concatenate(hid), np.concatenate(tgt),
                            device=dev)
    print(f"datastore: {len(store.targets):,} entries, PCA->3D")

    # -- serve: LM vs LM+kNN perplexity on (seen) data -----------------------
    b = stream.batch_at(5)
    h = hidden(b["tokens"])
    w = _unembed_weight(model).detach().float().cpu().numpy()
    logits = h @ w
    p_lm = torch.softmax(torch.from_numpy(logits), -1).numpy()
    flat_h = h.reshape(-1, cfg.d_model)
    p_knn = knn_logprobs(store, flat_h, cfg.padded_vocab, k=8)
    labels = b["labels"].reshape(-1)

    def ppl(p):
        idx = np.arange(len(labels))
        return float(np.exp(-np.mean(np.log(np.clip(p[idx, labels], 1e-9, None)))))

    p_lm_flat = p_lm.reshape(-1, cfg.padded_vocab)
    out = {"loss": loss, "lm": ppl(p_lm_flat), "knn": {}}
    print(f"LM-only perplexity:  {out['lm']:8.2f}")
    for lam in LAMBDAS:
        out["knn"][lam] = ppl(interpolate(p_lm_flat, p_knn, lam))
        print(f"kNN-LM (lam={lam}):    {out['knn'][lam]:8.2f}")
    return out


if __name__ == "__main__":
    main()
