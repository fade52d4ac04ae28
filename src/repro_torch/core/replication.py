"""Hub replication — beyond-paper extension of the power-law insight.

The paper reduces hop counts by *placing* communicating shards adjacently.
Under the same power-law skew, an orthogonal lever (the paper's §7 notes its
approach composes with GraphP-style duplication) is to *replicate* the
properties of the few highest-degree vertices on every engine: traffic to a
hub's vprop/vtemp becomes engine-local, at the cost of a small broadcast of
the hub values once per iteration.

This module decides the hub set and predicts the traffic delta so the mapper
can take replication only when it wins:

  saved     = Σ_{e: dst is hub} 2 · packet_bytes · activity(e) · avg_hops
  broadcast = |hubs| · prop_bytes · (P − 1) · iterations  (tree-broadcast ≈ P)

Under power law, a hub set of <5 % of vertices covers >50 % of edges, so
`saved` dominates for any realistic activity.  The same math drives the
hot-row replicated embedding path in `repro.models.recsys`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.degree import hub_set, in_degrees
from repro_torch.core.partition import Partition

__all__ = ["ReplicationPlan", "plan_replication"]


@dataclasses.dataclass(frozen=True)
class ReplicationPlan:
    hub_ids: np.ndarray  # vertex ids replicated everywhere, degree-desc
    is_hub: np.ndarray  # bool mask over vertices
    covered_edge_frac: float  # fraction of edge traffic that becomes local
    saved_bytes: float
    broadcast_bytes: float

    @property
    def num_hubs(self) -> int:
        return int(self.hub_ids.size)

    @property
    def net_saved_bytes(self) -> float:
        return self.saved_bytes - self.broadcast_bytes

    @property
    def worthwhile(self) -> bool:
        return self.net_saved_bytes > 0 and self.num_hubs > 0


def plan_replication(
    partition: Partition,
    src: np.ndarray,
    dst: np.ndarray,
    *,
    edge_activity: np.ndarray | None = None,
    edge_coverage: float = 0.5,
    max_frac: float = 0.05,
    packet_bytes: int = 8,
    prop_bytes: int = 8,
    avg_hops: float = 1.0,
    num_iterations: int = 1,
) -> ReplicationPlan:
    """Choose hubs by *in*-degree (replication serves reads of dst props) and
    account the byte delta against the broadcast cost."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    n = partition.num_nodes
    indeg = in_degrees(dst, n)
    if edge_activity is None:
        edge_activity = np.ones(dst.size, dtype=np.float64)
    hubs = hub_set(indeg, edge_coverage=edge_coverage, max_frac=max_frac)
    is_hub = np.zeros(n, dtype=bool)
    is_hub[hubs] = True
    hub_edge = is_hub[dst]
    # Process (vprop read) + Reduce (vtemp update) both become engine-local
    # for edges whose dst is a replicated hub → 2 packets saved per activity.
    act = np.asarray(edge_activity, dtype=np.float64)
    saved = float(2.0 * packet_bytes * (act * hub_edge).sum() * avg_hops)
    covered = float((act * hub_edge).sum() / max(act.sum(), 1e-30))
    broadcast = float(hubs.size * prop_bytes * max(partition.num_parts - 1, 0) * num_iterations)
    return ReplicationPlan(
        hub_ids=hubs,
        is_hub=is_hub,
        covered_edge_frac=covered,
        saved_bytes=saved,
        broadcast_bytes=broadcast,
    )
