"""kNN-LM over TrueKNN (port of ``repro.core.knnlm``): the paper's
technique as the retrieval engine of an LM serving stack.

The paper's hardware reduction is 3D-only; its own prescription for higher-d
data (Sec. 6.2) is dimensionality reduction (PCA et al.).  We implement
exactly that bridge: LM hidden states are PCA-projected to 3 components, the
datastore holds a resident ``NeighborIndex`` over the projected keys, and at
decode time the next-token distribution interpolates between the LM softmax
and the kNN distribution over retrieved targets (Khandelwal et al., 2020):

    p(y) = (1-lam) * p_LM(y) + lam * sum_{(h_i,y_i) in kNN(h)} softmax(-d_i/T)

Because the datastore owns the index, decode steps are the build-once /
query-many hot path: the hash grids built for the first decode batch are
reused (and the start radius warm-started) for every subsequent one.

The PCA fit and projection are numpy, op for op the reference's (a torch
SVD would choose other signs), so the projected keys are the reference's
bit for bit.  The index lives on the datastore's device (the card by
default), and ``knn_logprobs`` forms the softmax weights and scatters
them into the (Q, vocab) distribution there; its only host traffic is
the retrieval's own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..api import HybridSpec, KnnSpec, NeighborIndex, build_index

__all__ = ["PCAProjector", "fit_pca", "Datastore", "build_datastore",
           "knn_logprobs", "interpolate"]


@dataclasses.dataclass
class PCAProjector:
    mean: np.ndarray  # (D,)
    components: np.ndarray  # (D, 3)

    def __call__(self, h: np.ndarray) -> np.ndarray:
        return ((h - self.mean) @ self.components).astype(np.float32)


def fit_pca(hiddens: np.ndarray, dim: int = 3) -> PCAProjector:
    mean = hiddens.mean(0)
    x = hiddens - mean
    # economy SVD on a sample for big stores
    if x.shape[0] > 20_000:
        idx = np.random.default_rng(0).choice(x.shape[0], 20_000, replace=False)
        x = x[idx]
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return PCAProjector(mean=mean.astype(np.float32),
                        components=vt[:dim].T.astype(np.float32))


@dataclasses.dataclass
class Datastore:
    keys3d: np.ndarray  # (N, 3) PCA-projected hidden states
    targets: np.ndarray  # (N,) next-token ids
    projector: PCAProjector
    index: NeighborIndex  # resident search structure over keys3d


def build_datastore(
    hiddens: np.ndarray,
    targets: np.ndarray,
    *,
    backend: str = "trueknn",
    device="cuda",
    **index_cfg,
) -> Datastore:
    """hiddens (N, D) f32 from a trained LM's final layer; targets (N,).

    The index is built once here, on ``device``; every ``knn_logprobs``
    call is a pure ``query`` against it.  ``backend``/``index_cfg`` select
    and configure the registry backend (default: warm-starting TrueKNN).
    """
    proj = fit_pca(hiddens)
    keys3d = proj(hiddens)
    return Datastore(
        keys3d=keys3d,
        targets=np.asarray(targets, np.int32),
        projector=proj,
        index=build_index(keys3d, backend=backend, device=device,
                          **index_cfg),
    )


def knn_logprobs(
    store: Datastore,
    query_hiddens: np.ndarray,
    vocab_size: int,
    *,
    k: int = 8,
    temperature: float = 1.0,
    max_dist: Optional[float] = None,
    metric: str = "l2",
):
    """(Q, vocab) kNN distribution from the datastore's resident index, a
    float32 array.

    Retrieval goes through the planned spec surface: plain ``KnnSpec(k)``
    by default, or — with ``max_dist`` — ``HybridSpec(k, max_dist)``, which
    drops far-away (garbage) matches instead of letting them dilute the
    distribution.  ``metric`` picks the retrieval distance.

    The weights are the reference's float32 forms, formed on the index's
    device; each row's weights are added into its targets with one
    ``scatter_add_`` (the reference: ``np.add.at`` row by row), so rows
    whose neighbors share a target may sum in another order: equal to the
    reference within 1e-6 absolute.
    """
    q3 = store.projector(query_hiddens)
    spec = KnnSpec(k) if max_dist is None else HybridSpec(k, float(max_dist))
    res = store.index.query(q3, spec, metric=metric)
    dev = store.index.device
    d = torch.from_numpy(res.dists).to(dev)  # (Q, k); inf where dropped
    w = torch.exp(-d / np.float32(max(temperature, 1e-6)))
    w = torch.where(torch.isfinite(d), w, torch.zeros_like(w))
    w = w / w.sum(1, keepdim=True).clamp_min(1e-12)
    n_tgt = len(store.targets)
    tgt = torch.from_numpy(
        store.targets[np.clip(res.idxs, 0, n_tgt - 1)].astype(np.int64)
    ).to(dev)
    out = torch.zeros((q3.shape[0], vocab_size), dtype=torch.float32,
                      device=dev)
    out.scatter_add_(1, tgt, w)
    return out.cpu().numpy()


def interpolate(p_lm: np.ndarray, p_knn: np.ndarray, lam: float = 0.25):
    return (1 - lam) * p_lm + lam * p_knn
