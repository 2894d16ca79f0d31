"""TrueKNN workload config — the paper's own technique as a launchable cell
(distributed unbounded kNN over sharded points)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrueKNNConfig:
    name: str = "trueknn"
    n_points: int = 1 << 20      # per-shard points in the distributed cell
    n_queries: int = 1 << 16
    dim: int = 3
    k: int = 8
    growth: float = 2.0
    max_rounds: int = 24


CONFIG = TrueKNNConfig()
