"""MCSA cost models on tensors — the paper's Eqs. (1)–(17).

The port of the JAX package's ``repro/core/costs.py``: the same
parameter dataclasses, :class:`LayerProfile` (whose ``fingerprint`` is
byte-for-byte the reference's), the struct-of-arrays
:class:`DeviceFleet`, and the cost terms as plain functions on float32
tensors.  The discrete split ``s`` enters only through the per-layer
prefix tables; (B, r) are continuous tensors.

Host-side tables (:class:`DeviceFleet`, :func:`stack_edges_np`) stay
float64 numpy as in the reference; the solver math is float32 on the
requested device.  Moving host columns to the device goes through
:func:`rows_to_device`, which makes ONE host-to-device copy per batch
of columns (each blocking copy synchronises the stream, so a dozen
separate copies would cost a dozen round trips).

Units: FLOPs for compute, bits for data, Hz for bandwidth, Watts for
power, seconds / Joules / $ for the three objectives.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DeviceParams:
    """Per-mobile-user parameters (paper's user i)."""
    c_dev: float = 25e9          # device FLOP/s (c_i)
    xi: float = 3e-31            # effective switched capacitance (ξ_i)
    phi: float = 1.0             # cycles per FLOP (φ_i folded to FLOP basis)
    p_tx: float = 0.5            # transmit power, W (p_i)
    alpha: float = 1e-10         # large-scale fading power gain (α_i^κ)
    g_fade: float = 1.0          # small-scale fading (g_i^κ)
    w_T: float = 1 / 3           # ω_T
    w_E: float = 1 / 3           # ω_E
    w_C: float = 1 / 3           # ω_C
    k_rounds: float = 50.0       # k_i — task rounds at this server
    t_ag: float = 0.0            # T_Ag — strategy calculation time (s)
    hops: int = 1                # H_i — AP hops to the edge server


DEV_FIELDS = ("c_dev", "xi", "phi", "p_tx", "alpha", "g_fade",
              "w_T", "w_E", "w_C", "k_rounds", "t_ag", "hops")


@dataclasses.dataclass(frozen=True)
class EdgeParams:
    """Per-edge-server parameters (paper's server j)."""
    c_min: float = 50e9          # FLOP/s of one minimum compute unit
    rho_min: float = 2e-4        # $/s per rented unit (ρ_min^j)
    lam_a: float = 0.85          # λ(r) = r^lam_a  (multicore sub-linearity)
    rho_B: float = 1e-4          # bandwidth price scale
    gamma_B: float = 1.2         # bandwidth price convexity (g convex)
    B0: float = 1e6              # bandwidth price normalizer (Hz)
    B_backhaul: float = 1e9      # inter-AP backhaul bandwidth B (bit/s)
    N0: float = 4e-21            # noise PSD (W/Hz)
    B_min: float = 1e6
    B_max: float = 2e7
    r_min: float = 1.0
    r_max: float = 32.0


EDGE_FIELDS = ("c_min", "rho_min", "lam_a", "rho_B", "gamma_B", "B0",
               "B_backhaul", "N0", "B_min", "B_max", "r_min", "r_max")


@dataclasses.dataclass(frozen=True)
class LayerProfile:
    """Per-layer workload profile of one model (paper's f / w tables).

    flops[j]    — FLOPs of layer j (j = 0..M-1)
    out_bits[j] — activation bits emitted by layer j; split s ships
                  ``out_bits[s-1]``, s = 0 ships the raw input ``in_bits``
    in_bits     — raw input size (shipped for Edge-Only / s=0)
    result_bits — final inference result size (m_i)
    """
    name: str
    flops: np.ndarray
    out_bits: np.ndarray
    in_bits: float
    result_bits: float

    @property
    def num_layers(self) -> int:
        return len(self.flops)

    def prefix_tables(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(f_l[s], f_e[s], w[s]) for s = 0..M: device FLOPs, edge FLOPs,
        shipped bits at each split point."""
        cum = np.concatenate([[0.0], np.cumsum(self.flops)])
        f_l = cum                              # s = 0..M
        f_e = cum[-1] - cum
        w = np.concatenate([[self.in_bits], self.out_bits])
        return f_l, f_e, w

    @property
    def fingerprint(self) -> str:
        """Content hash, computed exactly as the reference computes it
        (so a profile carried across packages keeps its identity)."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.sha1()
            h.update(self.name.encode())
            for arr in (self.flops, self.out_bits,
                        (self.in_bits, self.result_bits)):
                a = np.ascontiguousarray(np.asarray(arr, np.float64))
                # length-prefix each field: without it, bytes sliding from
                # flops into out_bits would collide
                h.update(np.int64(a.size).tobytes())
                h.update(a.tobytes())
            fp = h.hexdigest()
            object.__setattr__(self, "_fingerprint", fp)
        return fp


# ---------------------------------------------------------------------------
# Cost terms.  dev/edge are dicts of float32 tensors (0-d or (X,)) keyed as
# DEV_FIELDS / EDGE_FIELDS; every formula is the reference's, op for op.
# ---------------------------------------------------------------------------
def lam(edge, r):
    """λ(r): sub-linear multicore speedup (Eq. 3 compensation function)."""
    return torch.pow(r, edge["lam_a"])


def shannon_rate(dev, edge, B):
    """τ_i = B log2(1 + p α g / (B N0))  (Eq. 11), bits/s."""
    snr = dev["p_tx"] * dev["alpha"] * dev["g_fade"] / (B * edge["N0"])
    return B * torch.log2(1.0 + snr)


def t_device(dev, f_l):
    """Eq. (1): on-device inference delay."""
    return f_l / dev["c_dev"]


def t_server(dev, edge, f_e, r):
    """Eq. (3): edge inference delay with λ(r) compensation."""
    return f_e / (lam(edge, r) * edge["c_min"])


def t_transmit(dev, edge, w_bits, m_bits, B, hops=None):
    """Eq. (5): device→AP (allocated B) + per-hop AP relay (backhaul)."""
    h = dev["hops"] if hops is None else hops
    t_up = (w_bits + m_bits) / B
    t_relay = h * (w_bits + m_bits) / edge["B_backhaul"]
    return t_up + t_relay


def relay_seconds(bits, hops, B_backhaul):
    """The backhaul relay term of Eq. (5) / Eq. (41)'s H₂ path on an
    arbitrary payload: ship ``bits`` over ``hops`` AP→server hops at
    ``B_backhaul`` bit/s each.  The serving layer prices mid-stream
    failover with it (:mod:`repro_torch.serving.failover`)."""
    return float(bits) * float(hops) / float(B_backhaul)


def cbr_calc(dev):
    """Eq. (7): strategy-calculation cost-benefit ratio T_Ag / k."""
    return dev["t_ag"] / dev["k_rounds"]


def energy_compute(dev, f_l):
    """Eq. (9): E^l = ξ c² φ f."""
    return dev["xi"] * dev["c_dev"] ** 2 * dev["phi"] * f_l


def energy_transmit(dev, edge, w_bits, m_bits, B):
    """Eq. (10): E^t = p · (w_s + m) / τ(B)."""
    return dev["p_tx"] * (w_bits + m_bits) / shannon_rate(dev, edge, B)


def rent_cost(edge, r, B):
    """Eq. (15): C = r ρ_min + g(B), convex increasing g."""
    g_B = edge["rho_B"] * torch.pow(B / edge["B0"], edge["gamma_B"])
    return r * edge["rho_min"] + g_B


def utility(dev, edge, f_l, f_e, w_bits, m_bits, B, r, *, offloaded=None):
    """Eq. (17)/(19): U = ω_T·T + ω_E·E + ω_C·CBR_C for one split point.

    ``offloaded``: 0/1 indicator that any work is offloaded; None derives
    it from f_e > 0 (s = M is device-only: no transmission, no rent)."""
    if offloaded is None:
        offloaded = (f_e > 0).to(torch.float32)
    T = (t_device(dev, f_l)
         + offloaded * (t_server(dev, edge, f_e, r)
                        + t_transmit(dev, edge, w_bits, m_bits, B))
         + cbr_calc(dev))
    E = (energy_compute(dev, f_l)
         + offloaded * energy_transmit(dev, edge, w_bits, m_bits, B))
    C = offloaded * rent_cost(edge, r, B) / dev["k_rounds"]
    U = dev["w_T"] * T + dev["w_E"] * E + dev["w_C"] * C
    return U, (T, E, C)


# ---------------------------------------------------------------------------
# Host tables and their move to the device
# ---------------------------------------------------------------------------
class DeviceFleet:
    """Struct-of-arrays :class:`DeviceParams` for a fleet of X users:
    every field of DEV_FIELDS is a (X,) float64 numpy array.  Missing
    fields broadcast from the ``DeviceParams`` defaults."""

    __slots__ = ("arrays",)

    def __init__(self, num_users: Optional[int] = None, **fields):
        unknown = set(fields) - set(DEV_FIELDS)
        if unknown:
            raise TypeError(f"unknown device fields: {sorted(unknown)}")
        if num_users is None:
            sizes = [np.ndim(v) and len(np.asarray(v)) for v in
                     fields.values()]
            sizes = [s for s in sizes if s]
            if not sizes:
                raise TypeError("DeviceFleet needs num_users or at least "
                                "one array-valued field")
            num_users = sizes[0]
        defaults = DeviceParams()
        self.arrays: Dict[str, np.ndarray] = {}
        for k in DEV_FIELDS:
            v = np.asarray(fields.get(k, getattr(defaults, k)), np.float64)
            self.arrays[k] = np.ascontiguousarray(
                np.broadcast_to(v, (num_users,)))

    @classmethod
    def from_params(cls, devs: Sequence[DeviceParams]) -> "DeviceFleet":
        return cls(num_users=len(devs),
                   **{k: np.asarray([getattr(d, k) for d in devs],
                                    np.float64) for k in DEV_FIELDS})

    def __len__(self) -> int:
        return len(self.arrays["c_dev"])

    def __getitem__(self, i: int) -> DeviceParams:
        kw = {k: float(v[i]) for k, v in self.arrays.items()}
        kw["hops"] = int(kw["hops"])
        return DeviceParams(**kw)

    def replace(self, **fields) -> "DeviceFleet":
        arrays = dict(self.arrays)
        for k, v in fields.items():
            if k not in DEV_FIELDS:
                raise TypeError(f"unknown device field: {k}")
            arrays[k] = np.ascontiguousarray(np.broadcast_to(
                np.asarray(v, np.float64), (len(self),)))
        out = DeviceFleet.__new__(DeviceFleet)
        out.arrays = arrays
        return out


Devices = Union[DeviceFleet, Sequence[DeviceParams]]


def rows_to_device(cols: Dict[str, np.ndarray], device,
                   n: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` for a dict of host columns, moved
    in ONE copy: the columns are rounded to float32 on the host (the
    same round-to-nearest the reference's ``jnp.asarray(v, f32)`` does),
    stacked into one (F, n) block, copied, and handed back as row views.
    Scalars broadcast to ``n`` (the longest column when omitted)."""
    if n is None:
        n = max((np.size(v) for v in cols.values()), default=0)
    block = np.empty((len(cols), n), np.float32)
    for i, v in enumerate(cols.values()):
        block[i] = np.asarray(v, np.float64)
    dev_block = torch.from_numpy(block).to(device)
    return {k: dev_block[i] for i, k in enumerate(cols)}


def dev_dict(d: DeviceParams, device) -> dict:
    """0-d float32 tensors of one user's parameters."""
    return {k: torch.tensor(float(getattr(d, k)), dtype=torch.float32,
                            device=device) for k in DEV_FIELDS}


def edge_dict(e: EdgeParams, device) -> dict:
    """0-d float32 tensors of one server's parameters."""
    return {k: torch.tensor(float(getattr(e, k)), dtype=torch.float32,
                            device=device) for k in EDGE_FIELDS}


def device_columns(devs: Devices, idx=None) -> Dict[str, np.ndarray]:
    """Host float64 columns of a DeviceFleet (or a sequence of
    DeviceParams), all rows or the ``idx`` rows only — O(len(idx)), never
    O(fleet): handoff steps must not pay for users who didn't move."""
    if not isinstance(devs, DeviceFleet):
        rows = devs if idx is None else [devs[int(i)] for i in idx]
        return dict(DeviceFleet.from_params(rows).arrays)
    if idx is None:
        return dict(devs.arrays)
    idx = np.asarray(idx)
    return {k: v[idx] for k, v in devs.arrays.items()}


def stack_devices(devs: Devices, device) -> dict:
    """(X,) float32 device dict of every user."""
    return rows_to_device(device_columns(devs), device, len(devs))


def gather_devices(devs: Devices, idx: np.ndarray, device) -> dict:
    """(len(idx),) float32 device dict of the ``idx`` rows only."""
    return rows_to_device(device_columns(devs, idx), device,
                          len(np.asarray(idx)))


def stack_edges_np(edges) -> Dict[str, np.ndarray]:
    """Host-resident (Z,) edge-parameter table — built once per topology,
    gathered per user with fancy indexing (no per-user Python)."""
    return {k: np.asarray([getattr(e, k) for e in edges], np.float64)
            for k in EDGE_FIELDS}


def apply_congestion(edge_table: Dict[str, np.ndarray],
                     compute_mult=None,
                     backhaul_mult=None) -> Dict[str, np.ndarray]:
    """Congestion-adjusted copy of a :func:`stack_edges_np` table:
    ``c_min`` divided by ``compute_mult`` and ``B_backhaul`` by
    ``backhaul_mult`` ((Z,) vectors, clipped up to 1).  Identity
    multipliers (or None) return ``edge_table`` itself, the same object,
    which keeps the feedback-off path pointer-equal to the static one."""
    cm = None if compute_mult is None else np.maximum(
        np.asarray(compute_mult, np.float64), 1.0)
    bm = None if backhaul_mult is None else np.maximum(
        np.asarray(backhaul_mult, np.float64), 1.0)
    if ((cm is None or np.all(cm == 1.0))
            and (bm is None or np.all(bm == 1.0))):
        return edge_table
    out = dict(edge_table)
    if cm is not None:
        out["c_min"] = np.asarray(out["c_min"], np.float64) / cm
    if bm is not None:
        out["B_backhaul"] = (np.asarray(out["B_backhaul"], np.float64)
                             / bm)
    return out
