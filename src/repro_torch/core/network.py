"""Edge network topology: N APs, Z < N edge servers, multi-hop relays.

Faithful to the paper's §3 network model: APs connected by fiber backhaul;
only Z of N APs host an edge server (deployment-cost constraint); each AP
offloads to one server, reached over multi-hop AP relays; users attach to
their nearest AP.  Hop counts H_i come from BFS shortest paths (the paper
invokes Dijkstra on the unweighted AP graph — identical result).

Beyond the paper's one-server-per-AP assumption, each AP also exposes a
hop-ordered CANDIDATE SET of the K nearest servers (:meth:`Topology.
candidates`) and each server may carry a compute / bandwidth budget
(``r_capacity`` / ``B_capacity``).  The planner's admission control
(``repro_torch.core.admission``) spills users to their next candidate when a
server saturates; see docs/ARCHITECTURE.md ("Admission control") for the
full control-plane dataflow.

Pure numpy — topology is static control-plane state, not jitted compute.
Built directly by :func:`build_topology` or declaratively from a
``repro_torch.api.Scenario`` (geometry + budgets are scenario fields).

Under fault injection (``repro_torch.core.faults``) the topology additionally
carries live availability masks (``server_up`` / ``link_up``) and
:meth:`Topology.apply_faults` recomputes hops, nearest-server
associations, and effective capacities after every crash/cut/recovery —
down servers get ``inf`` hop columns so every hop-ordered choice
(``ap_server``, ``candidates``) automatically avoids them.  See
docs/ARCHITECTURE.md ("Failure handling").
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Sequence

import numpy as np

from .costs import EdgeParams


@dataclasses.dataclass
class Topology:
    ap_xy: np.ndarray            # (N, 2) AP positions (meters)
    adj: np.ndarray              # (N, N) bool adjacency (fiber links)
    server_aps: np.ndarray       # (Z,) AP index hosting each server
    ap_server: np.ndarray        # (N,) serving server id per AP
    hops: np.ndarray             # (N, Z) AP->server hop counts
    edges: List[EdgeParams]      # per-server parameters (heterogeneous!)
    ap_radius: float             # user association radius
    r_capacity: Optional[np.ndarray] = None   # (Z,) compute-unit budget per
                                 # server (None = uncapacitated)
    B_capacity: Optional[np.ndarray] = None   # (Z,) uplink-bandwidth budget
                                 # per server in Hz (None = uncapacitated)
    # --- availability (the fault-injection layer; see core/faults.py and
    # docs/ARCHITECTURE.md "Failure handling").  None until the first
    # apply_faults call: an unfaulted topology pays zero overhead and
    # behaves bit-for-bit as before.
    server_up: Optional[np.ndarray] = None    # (Z,) bool server liveness
    link_up: Optional[np.ndarray] = None      # (L,) bool over links()
    ap_reachable: Optional[np.ndarray] = None  # (N,) any up server in reach
    _base: Optional[dict] = dataclasses.field(default=None, repr=False)

    @property
    def num_aps(self) -> int:
        return len(self.ap_xy)

    @property
    def num_servers(self) -> int:
        return len(self.server_aps)

    @property
    def capacitated(self) -> bool:
        """True when any per-server budget is set (admission control on)."""
        return self.r_capacity is not None or self.B_capacity is not None

    @property
    def faulted(self) -> bool:
        """True once apply_faults has run — availability masks exist and
        planners must consult them.  All fault-aware planner branches
        key on this so unfaulted runs stay numerically identical."""
        return self.server_up is not None

    def server_available(self) -> np.ndarray:
        """(Z,) bool liveness mask (all-True when never faulted)."""
        if self.server_up is None:
            return np.ones(self.num_servers, bool)
        return self.server_up

    @property
    def availability(self) -> float:
        """Fraction of servers currently up (1.0 when never faulted)."""
        return float(self.server_available().mean())

    def links(self) -> np.ndarray:
        """(L, 2) undirected fiber links (i < j) of the UNFAULTED graph
        — the index space FaultBatch.link_down / link_up target."""
        adj = self._base["adj"] if self._base is not None else self.adj
        i, j = np.nonzero(np.triu(adj, 1))
        return np.stack([i, j], axis=1)

    # ------------------------------------------------------------------
    def apply_faults(self, batch) -> None:
        """Fold one :class:`repro_torch.core.faults.FaultBatch` into the live
        availability state and recompute every derived field (adjacency,
        hops, nearest-server map, effective capacities).

        The pre-fault state is snapshotted on the first call, so a fully
        recovered topology (all servers and links back up) reproduces
        the original ``hops`` / ``ap_server`` bit-for-bit.  Down or
        unreachable servers get ``inf`` hop columns — ``candidates``'
        stable argsort naturally sorts them last, and planners clamp the
        inf through ``repro_torch.core.faults.clamp_hops`` before any solver
        sees it.  APs with no reachable up server keep their pre-fault
        ``ap_server`` association (flagged False in ``ap_reachable``);
        users there degrade to device-only at the next evacuation."""
        if self._base is None:
            self._base = dict(
                adj=self.adj.copy(), hops=self.hops.copy(),
                ap_server=self.ap_server.copy(), links=self.links(),
                r_capacity=(None if self.r_capacity is None
                            else self.r_capacity.copy()),
                B_capacity=(None if self.B_capacity is None
                            else self.B_capacity.copy()))
            self.server_up = np.ones(self.num_servers, bool)
            self.link_up = np.ones(len(self._base["links"]), bool)

        self.server_up[np.asarray(batch.server_down, np.int64)] = False
        self.server_up[np.asarray(batch.server_up, np.int64)] = True
        self.link_up[np.asarray(batch.link_down, np.int64)] = False
        self.link_up[np.asarray(batch.link_up, np.int64)] = True

        adj = self._base["adj"].copy()
        cut = self._base["links"][~self.link_up]
        adj[cut[:, 0], cut[:, 1]] = False
        adj[cut[:, 1], cut[:, 0]] = False
        self.adj = adj

        hops = np.full_like(self._base["hops"], np.inf, dtype=np.float64)
        for z, ap in enumerate(self.server_aps):
            if self.server_up[z]:
                hops[:, z] = _bfs_hops(adj, int(ap))
        self.hops = hops

        best = np.argmin(hops, axis=1)
        reachable = np.isfinite(hops[np.arange(len(best)), best])
        self.ap_server = np.where(reachable, best,
                                  self._base["ap_server"])
        self.ap_reachable = reachable

        if batch.r_scale is not None \
                and self._base["r_capacity"] is not None:
            self.r_capacity = self._base["r_capacity"] * np.asarray(
                batch.r_scale, np.float64)
        if batch.B_scale is not None \
                and self._base["B_capacity"] is not None:
            self.B_capacity = self._base["B_capacity"] * np.asarray(
                batch.B_scale, np.float64)

    # ------------------------------------------------------------------
    def nearest_ap(self, xy: np.ndarray) -> np.ndarray:
        """xy: (..., 2) user positions -> AP index."""
        d = np.linalg.norm(xy[..., None, :] - self.ap_xy, axis=-1)
        return np.argmin(d, axis=-1)

    def candidates(self, k: int) -> np.ndarray:
        """(N, min(k, Z)) candidate servers per AP, nearest-first.

        Column 0 always equals ``ap_server`` (both take the FIRST
        hop-minimal server: ``candidates(1)`` reproduces the paper's
        one-server-per-AP model bit-for-bit).  Ties on hop count break
        deterministically toward the lower server id (stable sort)."""
        k = max(1, min(int(k), self.num_servers))
        return np.argsort(self.hops, axis=1, kind="stable")[:, :k]

    def serving_server(self, ap: np.ndarray) -> np.ndarray:
        return self.ap_server[ap]

    def hops_to(self, ap: np.ndarray, server: np.ndarray) -> np.ndarray:
        return self.hops[ap, server]

    def pathloss(self, xy: np.ndarray, ap: np.ndarray,
                 exponent: float = 3.5, ref: float = 1.0) -> np.ndarray:
        """Large-scale fading α_i^κ: distance-based path gain."""
        d = np.linalg.norm(xy - self.ap_xy[ap], axis=-1)
        return ref * np.power(np.maximum(d, 1.0), -exponent)


def _bfs_hops(adj: np.ndarray, src: int) -> np.ndarray:
    n = len(adj)
    dist = np.full(n, np.inf)
    dist[src] = 0
    q = deque([src])
    while q:
        u = q.popleft()
        for v in np.nonzero(adj[u])[0]:
            if dist[v] == np.inf:
                dist[v] = dist[u] + 1
                q.append(v)
    return dist


def build_topology(num_aps: int = 16, num_servers: int = 4, *,
                   area: float = 2000.0, link_radius: Optional[float] = None,
                   seed: int = 0,
                   edge_params: Optional[Sequence[EdgeParams]] = None,
                   heterogeneity: float = 0.5,
                   r_capacity=None, B_capacity=None) -> Topology:
    """Random-geometric AP graph + greedy server placement.

    Server placement greedily minimizes the max AP→server hop distance —
    a k-center heuristic standing in for the paper's [24] submodular
    placement.  Per-server compute heterogeneity (±``heterogeneity``)
    models the paper's "heterogeneity of edge servers".

    ``r_capacity`` / ``B_capacity``: optional per-server budgets (compute
    units / uplink Hz) enabling the planner's admission control; a scalar
    broadcasts to every server, a sequence gives per-server budgets.
    """
    rng = np.random.default_rng(seed)
    grid = int(np.ceil(np.sqrt(num_aps)))
    # jittered grid: connected, realistic AP deployment
    cells = [(i, j) for i in range(grid) for j in range(grid)][:num_aps]
    step = area / grid
    ap_xy = np.array([[ (i + 0.5) * step, (j + 0.5) * step] for i, j in cells])
    ap_xy += rng.uniform(-0.2 * step, 0.2 * step, ap_xy.shape)
    if link_radius is None:
        link_radius = 1.6 * step
    d = np.linalg.norm(ap_xy[:, None] - ap_xy[None, :], axis=-1)
    adj = (d < link_radius) & ~np.eye(num_aps, dtype=bool)
    # ensure connectivity: link each isolated component to nearest AP
    for _ in range(num_aps):
        dist0 = _bfs_hops(adj, 0)
        if np.all(np.isfinite(dist0)):
            break
        far = int(np.argmax(~np.isfinite(dist0)))
        reach = np.nonzero(np.isfinite(dist0))[0]
        nearest = reach[np.argmin(d[far, reach])]
        adj[far, nearest] = adj[nearest, far] = True

    # greedy k-center server placement on hop metric
    all_hops = np.stack([_bfs_hops(adj, i) for i in range(num_aps)])
    servers: List[int] = [int(np.argmin(all_hops.max(1)))]
    while len(servers) < num_servers:
        cover = np.min(all_hops[servers], axis=0)
        servers.append(int(np.argmax(cover)))
    server_aps = np.array(sorted(servers))

    hops = all_hops[server_aps].T                       # (N, Z)
    ap_server = np.argmin(hops, axis=1)                 # nearest server
    if edge_params is None:
        edge_params = []
        for z in range(num_servers):
            f = 1.0 + heterogeneity * (rng.uniform(-1, 1))
            edge_params.append(EdgeParams(
                c_min=50e9 * f,
                rho_min=2e-4 / max(f, 0.25),
                r_max=float(rng.choice([16, 32, 48])),
            ))
    def _cap(v):
        if v is None:
            return None
        return np.ascontiguousarray(np.broadcast_to(
            np.asarray(v, np.float64), (num_servers,)))

    return Topology(ap_xy=ap_xy, adj=adj, server_aps=server_aps,
                    ap_server=ap_server, hops=hops,
                    edges=list(edge_params), ap_radius=step,
                    r_capacity=_cap(r_capacity), B_capacity=_cap(B_capacity))
