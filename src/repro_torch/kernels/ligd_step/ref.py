"""The plain PyTorch version of the fused Li-GD / MLi-GD sweep.

A port of the whole-sweep reference in the JAX package's
``repro/kernels/ligd_step/ref.py`` (``ligd_sweep_ref`` /
``mligd_sweep_ref``): the warm-started M+1 split sweep, closed-form
gradients, per-lane stopping with a chunked early exit, and the running
first-min argmin over splits, on a dense ``(NF_SWEEP, X)`` feature
matrix with users on the trailing axis.

It serves two callers: the CPU path of :mod:`.ops` (a CPU tensor always
takes it) and the on-card comparison of the CUDA kernel in
``csrc/sweep.cu``, which runs the same arithmetic per lane.  Every
formula keeps the reference's own form — λ = exp2(a·log2 r), then
1/λ and a multiply; L = log2(1 + q/B); pow_B = exp2(γ·log2(B/B0)) —
because near-ties in U decide discrete splits and iteration counts sit
on the |ΔU| < ε threshold: forms that are equal in exact arithmetic
would flip some of them.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

LN2 = math.log(2.0)

# ---------------------------------------------------------------------------
# Feature layout: one ROW per feature, users on the trailing axis.  Rows
# 23..28 are only populated for the MLi-GD joint solve (frozen original
# strategy).  Row order is the kernel's ABI (csrc/sweep.cu, enum Row).
# ---------------------------------------------------------------------------
SWEEP_FIELDS = (
    "c_dev", "epf", "p_tx", "c1", "hops", "k", "t_ag", "wT", "wE", "wC",
    "c_min", "rho_min", "lam_a", "rho_B", "gamma_B", "B0", "B_bh", "N0",
    "B_min", "B_max", "r_min", "r_max", "m",
    "f_l_o", "f_e_o", "w_o", "r_o", "rent_o", "hops_bk",
)
NF_SWEEP = 32                     # rows, padded to a power of two
#: rows each variant reads: Li-GD stops at "m", the joint solve reads all
#: of SWEEP_FIELDS (csrc/sweep.cu, NROWS_LIGD / NROWS_JOINT)
NROWS_LIGD = SWEEP_FIELDS.index("m") + 1
NROWS_JOINT = len(SWEEP_FIELDS)


def sweep_tables(profile) -> tuple:
    """Per-split prefix tables, one (f_l, f_e, w, offloaded) row per
    split s = 0..M (hashable tuple of floats, as in the reference)."""
    f_l, f_e, w = profile.prefix_tables()
    return tuple(
        (float(f_l[s]), float(f_e[s]), float(w[s]),
         1.0 if float(f_e[s]) > 0 else 0.0)
        for s in range(len(f_l)))


def table_tensor(tables, device) -> torch.Tensor:
    """(M1, 4) float32 tensor of :func:`sweep_tables` on ``device``
    (tensors pass through)."""
    if torch.is_tensor(tables):
        return tables
    return torch.tensor(tables, dtype=torch.float32, device=device)


def pack_sweep_features(dev: dict, edge: dict, m_bits, num_users: int,
                        orig: dict = None, hops_back=None) -> torch.Tensor:
    """(NF_SWEEP, X) float32 feature matrix from batched device/edge
    dicts.  Leaves may be (X,) tensors or scalars (shared edge);
    ``orig``/``hops_back`` fill the MLi-GD rows (frozen original
    strategy of Eq. 41–43).  Rows are anonymous batch lanes, so the
    caller may tile (user, candidate) pairs into them."""
    X = num_users
    epf = dev["xi"] * dev["c_dev"] ** 2 * dev["phi"]     # ξc²φ J/FLOP
    c1 = dev["p_tx"] * dev["alpha"] * dev["g_fade"]      # pαg
    rows = [dev["c_dev"], epf, dev["p_tx"], c1, dev["hops"],
            dev["k_rounds"], dev["t_ag"], dev["w_T"], dev["w_E"], dev["w_C"],
            edge["c_min"], edge["rho_min"], edge["lam_a"], edge["rho_B"],
            edge["gamma_B"], edge["B0"], edge["B_backhaul"], edge["N0"],
            edge["B_min"], edge["B_max"], edge["r_min"], edge["r_max"],
            m_bits]
    if orig is not None:
        rows += [orig["f_l"], orig["f_e"], orig["w"], orig["r"],
                 orig["rent"], hops_back]
    feat = torch.zeros((NF_SWEEP, X), dtype=torch.float32,
                       device=dev["c_dev"].device)
    for i, v in enumerate(rows):
        feat[i] = v
    return feat


def _frows(feat):
    """Name -> (X,) row view of the feature matrix."""
    return {name: feat[i] for i, name in enumerate(SWEEP_FIELDS)}


# ---------------------------------------------------------------------------
# Closed-form utility + gradients in normalized coordinates (Eqs. 21–22
# generalized to λ(r)=r^a, g(B)=ρ_B(B/B0)^γ), per-user edge parameters.
# ---------------------------------------------------------------------------
def _u1_ug(fr, f_l, f_e, w, offl):
    """(U, grad) closure over x = (xB, xr) for one split point.  Every
    x-independent group is evaluated here, once per layer; the GD step
    carries 3 log2 + 2 exp2."""
    B_span = fr["B_max"] - fr["B_min"]
    r_span = fr["r_max"] - fr["r_min"]
    q = fr["c1"] / fr["N0"]                        # pαg/N0
    wm = w + fr["m"]
    inv_k = 1.0 / fr["k"]
    u_const = (fr["wT"] * (f_l / fr["c_dev"] + fr["t_ag"] * inv_k)
               + fr["wE"] * fr["epf"] * f_l)      # x-independent utility
    tT = fr["wT"] * offl                           # coefficient groups
    cT_relay = tT * fr["hops"] * wm / fr["B_bh"]
    cT_srv = tT * f_e / fr["c_min"]
    cT_up = tT * wm
    cE = fr["wE"] * offl * fr["p_tx"] * wm
    cC_r = fr["wC"] * offl * fr["rho_min"] * inv_k
    cC_B = fr["wC"] * offl * fr["rho_B"] * inv_k
    inv_B0 = 1.0 / fr["B0"]

    def ug(x):
        xB, xr = x
        B = fr["B_min"] + xB * B_span
        r = fr["r_min"] + xr * r_span
        lam = torch.exp2(fr["lam_a"] * torch.log2(r))   # λ(r) = r^a
        L = torch.log2(1.0 + q / B)                     # log2(1 + q/B)
        tau = B * L
        pow_B = torch.exp2(fr["gamma_B"] * torch.log2(B * inv_B0))
        inv_lam = 1.0 / lam

        U = (u_const + cT_srv * inv_lam + cT_up / B + cT_relay
             + cE / tau + cC_r * r + cC_B * pow_B)

        # dτ/dB = L - q / (ln2 · (B + q))
        dtau = L - q / (LN2 * (B + q))
        dU_dB = (cT_up * (-1.0 / (B * B))
                 + cE * (-dtau / (tau * tau))
                 + cC_B * fr["gamma_B"] * pow_B / B)
        # d(r^-a)/dr = -a·r^(-a-1) = -a / (λ(r)·r)
        dU_dr = cT_srv * (-fr["lam_a"]) * inv_lam / r + cC_r
        return U, (dU_dB * B_span, dU_dr * r_span)
    return ug


def _u2_ug(fr):
    """(U₂, dU₂/dxB_back) closure (Eq. 41–43 relay-back vertex): the
    frozen original split/server terms collapse into one constant."""
    B_span = fr["B_max"] - fr["B_min"]
    q = fr["c1"] / fr["N0"]
    wm = fr["w_o"] + fr["m"]
    inv_k = 1.0 / fr["k"]
    lam_o = torch.exp2(fr["lam_a"] * torch.log2(fr["r_o"]))
    u_const = (fr["wT"] * (fr["f_l_o"] / fr["c_dev"]
                           + fr["f_e_o"] / (lam_o * fr["c_min"])
                           + fr["hops_bk"] * wm / fr["B_bh"])
               + fr["wE"] * fr["epf"] * fr["f_l_o"]
               + fr["wC"] * fr["rent_o"] * inv_k)
    cT = fr["wT"] * wm
    cE = fr["wE"] * fr["p_tx"] * wm
    cC_B = fr["wC"] * fr["rho_B"] * inv_k
    inv_B0 = 1.0 / fr["B0"]

    def ug(xBb):
        Bb = fr["B_min"] + xBb * B_span
        L = torch.log2(1.0 + q / Bb)
        tau = Bb * L
        pow_B = torch.exp2(fr["gamma_B"] * torch.log2(Bb * inv_B0))
        U = u_const + cT / Bb + cE / tau + cC_B * pow_B
        dtau = L - q / (LN2 * (Bb + q))
        dU_dBb = (cT * (-1.0 / (Bb * Bb))
                  + cE * (-dtau / (tau * tau))
                  + cC_B * fr["gamma_B"] * pow_B / Bb)
        return U, dU_dBb * B_span
    return ug


def _joint_ug(fr, f_l, f_e, w, offl):
    """(U, grad) closure over x = (xB, xr, R, xB_back): the MLi-GD joint
    objective U = (1-R)·U₁ + R·U₂, affine in R (Corollary 7)."""
    u1 = _u1_ug(fr, f_l, f_e, w, offl)
    u2 = _u2_ug(fr)

    def ug(x):
        xB, xr, R, xBb = x
        U1, (g1B, g1r) = u1((xB, xr))
        U2, g2Bb = u2(xBb)
        U = (1.0 - R) * U1 + R * U2
        return U, ((1.0 - R) * g1B, (1.0 - R) * g1r, U2 - U1, R * g2Bb)
    return ug


# ---------------------------------------------------------------------------
# Masked chunked projected GD
# ---------------------------------------------------------------------------
def _masked_chunked_gd(ug_fn, x, *, lr, eps, max_iters, chunk):
    """Projected GD with the paper's stopping rules, one lane per user.

    The rule tests the CARRIED (old) gradient for ‖g‖ < ε and the new
    point for |ΔU| < ε and ‖Δx‖∞ < ε.  Frozen lanes keep x, u and g; the
    float32 iteration count grows only on active lanes.  The loop checks
    for any live lane every ``chunk`` steps; the masked step is
    idempotent on frozen lanes, so results do not depend on ``chunk``.
    Returns (x, U(x), iters)."""
    u, g = ug_fn(x)
    it = torch.zeros_like(u)
    done = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    mi = float(max_iters)

    def step(x, u, g, it, done):
        active = torch.logical_and(torch.logical_not(done), it < mi)
        x_new = tuple(torch.clamp(xi - lr * gi, 0.0, 1.0)
                      for xi, gi in zip(x, g))
        u_new, g_new = ug_fn(x_new)
        gnorm = torch.sqrt(sum(gi * gi for gi in g))
        dx = functools.reduce(
            torch.maximum, [torch.abs(a - b) for a, b in zip(x_new, x)])
        stop = ((gnorm < eps) | (torch.abs(u_new - u) < eps) | (dx < eps))
        x = tuple(torch.where(active, a, b) for a, b in zip(x_new, x))
        u = torch.where(active, u_new, u)
        g = tuple(torch.where(active, a, b) for a, b in zip(g_new, g))
        done = torch.where(active, stop, done)
        it = it + active.to(it.dtype)
        return x, u, g, it, done

    while torch.any(torch.logical_and(torch.logical_not(done), it < mi)):
        for _ in range(chunk):
            x, u, g, it, done = step(x, u, g, it, done)
    return x, u, it


def _sweep_ref(feat, x0, tables, *, lr, eps, max_iters, chunk, warm_start,
               init, joint):
    """Warm-started M+1 split sweep with a running (first-min) argmin.

    Returns (u_layers, x_layers tuple, it_layers, best_s, best_x, best_u);
    per-layer tensors are (M1, X), best_* are (X,)."""
    fr = _frows(feat)
    tab = table_tensor(tables, feat.device)               # (M1, 4)
    closure = _joint_ug if joint else _u1_ug
    x0 = tuple(x0[i] for i in range(x0.shape[0]))
    x = x0
    u_b = torch.full_like(x0[0], math.inf)
    s_b = torch.zeros_like(x0[0])
    x_b = x0
    us, xs, its = [], [], []
    for s in range(tab.shape[0]):
        if not warm_start:
            x = tuple(torch.full_like(fr["c_dev"], v) for v in init)
        ug = closure(fr, tab[s, 0], tab[s, 1], tab[s, 2], tab[s, 3])
        x, u, it = _masked_chunked_gd(ug, x, lr=lr, eps=eps,
                                      max_iters=max_iters, chunk=chunk)
        better = u < u_b                                   # strict: first min
        u_b = torch.where(better, u, u_b)
        s_b = torch.where(better, float(s), s_b)
        x_b = tuple(torch.where(better, a, b) for a, b in zip(x, x_b))
        us.append(u)
        xs.append(torch.stack(x, 0))
        its.append(it)
    x_l = torch.stack(xs, 0)                               # (M1, K, X)
    return (torch.stack(us, 0), tuple(x_l[:, i] for i in range(len(x0))),
            torch.stack(its, 0), s_b, x_b, u_b)


def ligd_sweep_ref(feat, x0, tables, *, lr=0.15, eps=1e-5, max_iters=400,
                   chunk=16, warm_start=True, init=(0.5, 0.5)):
    """Fused Li-GD sweep, plain PyTorch.  feat: (NF_SWEEP, X); x0: (2, X)."""
    return _sweep_ref(feat, x0, tables, lr=lr, eps=eps, max_iters=max_iters,
                      chunk=chunk, warm_start=warm_start, init=init,
                      joint=False)


def mligd_sweep_ref(feat, x0, tables, *, lr=0.15, eps=1e-5, max_iters=400,
                    chunk=16, warm_start=True, init=(0.5, 0.5, 0.5, 0.5)):
    """Fused MLi-GD joint sweep over x = (B, r, R, B_back); x0: (4, X)."""
    return _sweep_ref(feat, x0, tables, lr=lr, eps=eps, max_iters=max_iters,
                      chunk=chunk, warm_start=warm_start, init=init,
                      joint=True)


# ---------------------------------------------------------------------------
# Single-split Li-GD steps (the TPU kernel ligd_steps_tpu's contract) and
# its autodiff oracle.  Feature layout (X, NF), one row per user: the
# kernel's ABI (csrc/steps.cu).
# ---------------------------------------------------------------------------
NF = 16
STEP_FIELDS = ("f_l", "f_e", "w", "m", "offl", "c_dev", "epf", "p_tx", "c1",
               "hops", "k", "t_ag", "wT", "wE", "wC", "x0_B")
#: the edge constants a launch takes, in the kernel's argument order
EDGE_KEYS = ("B_min", "B_max", "r_min", "r_max", "lam_a", "c_min",
             "rho_min", "rho_B", "gamma_B", "B0", "B_backhaul", "N0")
#: the most groups one grouped call takes: the CUDA launch carries the
#: offsets and the groups' constants in its parameters (steps.py builds
#: csrc/steps.cu with this figure as MCSA_STEPS_MAX_GROUPS)
MAX_GROUPS = 64


def pack_features(f_l, f_e, w, m, offl, dev: dict) -> torch.Tensor:
    """(X, NF) float32 feature matrix from batched device dicts (leaves
    (X,) tensors or scalars); column 15 is zero (the TPU layout's unused
    warm-start slot)."""
    epf = dev["xi"] * dev["c_dev"] ** 2 * dev["phi"]
    c1 = dev["p_tx"] * dev["alpha"] * dev["g_fade"]
    cols = [f_l, f_e, w, m, offl, dev["c_dev"], epf, dev["p_tx"], c1,
            dev["hops"], dev["k_rounds"], dev["t_ag"], dev["w_T"],
            dev["w_E"], dev["w_C"]]
    X = torch.as_tensor(f_l).shape[0]
    device = torch.as_tensor(f_l).device
    feat = torch.zeros((X, NF), dtype=torch.float32, device=device)
    for i, v in enumerate(cols):
        feat[:, i] = torch.as_tensor(v, dtype=torch.float32, device=device)
    return feat


def edge_tuple_of(edge: dict) -> tuple:
    """The edge constants as ``(name, float)`` pairs in EDGE_KEYS order
    (the TPU kernel's hashable statics; the CUDA kernel's arguments)."""
    missing = [k for k in EDGE_KEYS if k not in edge]
    if missing:
        raise ValueError(f"edge constants missing {missing}; expected "
                         f"{EDGE_KEYS}")
    return tuple((k, float(edge[k])) for k in EDGE_KEYS)


def check_groups(offsets, edge_tuples, X: int) -> list:
    """The offsets as a list of ints, after checking them against X rows
    and the edge records (from :func:`edge_tuple_of`): both devices hold
    a grouped call to this."""
    if torch.is_tensor(offsets):
        if offsets.device.type != "cpu":
            raise ValueError(f"offsets: on {offsets.device}; the launch "
                             "carries them, so they must be host values")
        offsets = offsets.tolist()
    start = [int(v) for v in offsets]
    G = len(start) - 1
    if not 1 <= G <= MAX_GROUPS:
        raise ValueError(f"offsets: {G} groups, expected 1..{MAX_GROUPS}")
    if start[0] != 0 or start[-1] != X:
        raise ValueError(f"offsets: run {start[0]}..{start[-1]}, expected "
                         f"0..{X}")
    if any(b < a for a, b in zip(start, start[1:])):
        raise ValueError("offsets: not monotone (non-decreasing)")
    if len(edge_tuples) != G:
        raise ValueError(f"edge records: {len(edge_tuples)}, expected one "
                         f"a group ({G})")
    for et in edge_tuples:
        names = tuple(k for k, _ in et)
        if names != EDGE_KEYS:
            raise ValueError(f"edge_tuple keys {names}, expected "
                             f"{EDGE_KEYS}")
    return start


def _steps_utility(feat: torch.Tensor, x: torch.Tensor, edge: dict):
    """U (X,) of every row at normalized x (X, 2), through
    ``core/costs.utility`` with the device dict rebuilt from the
    features, as the reference's oracle rebuilds it."""
    # imported here: repro_torch.core imports this package (core.ligd)
    from repro_torch.core.costs import utility
    f = feat.T
    one = torch.ones((), dtype=torch.float32, device=feat.device)
    dev = {"c_dev": f[5], "xi": f[6] / torch.clamp_min(f[5] ** 2, 1e-30),
           "phi": one, "p_tx": f[7],
           "alpha": f[8] / torch.clamp_min(f[7], 1e-30), "g_fade": one,
           "w_T": f[12], "w_E": f[13], "w_C": f[14], "k_rounds": f[10],
           "t_ag": f[11], "hops": f[9]}
    ep = {k: torch.as_tensor(v, dtype=torch.float32, device=feat.device)
          for k, v in edge.items()}
    B = ep["B_min"] + x[:, 0] * (ep["B_max"] - ep["B_min"])
    r = ep["r_min"] + x[:, 1] * (ep["r_max"] - ep["r_min"])
    U, _ = utility(dev, ep, f[0], f[1], f[2], f[3], B, r, offloaded=f[4])
    return U


def ligd_steps_ref(feat: torch.Tensor, x0: torch.Tensor, edge: dict, *,
                   iters: int = 64, lr: float = 0.15):
    """The autodiff oracle of the single-split steps, as the JAX
    package's ``ligd_steps_ref``: ``iters`` steps of x <- clip(x - lr ·
    dU/dx, 0, 1) with the gradient from autograd.  feat (X, NF), x0
    (X, 2) -> (x (X, 2), U (X,))."""
    feat = feat.float()
    x = x0.float().clone()
    for _ in range(iters):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            g, = torch.autograd.grad(_steps_utility(feat, xg, edge).sum(),
                                     xg)
        x = torch.clamp(x - lr * g, 0.0, 1.0)
    return x, _steps_utility(feat, x, edge).detach()


def ligd_steps_grouped_ref(feats, x0s, offsets, edges, *, iters: int = 64,
                           lr: float = 0.15):
    """The plain version of the grouped steps: :func:`ligd_steps_ref` on
    each group's rows ``offsets[j]:offsets[j + 1]`` against ``edges[j]``,
    concatenated -> (x (X, 2), U (X,))."""
    outs = [ligd_steps_ref(feats[a:b], x0s[a:b], e, iters=iters, lr=lr)
            for a, b, e in zip(offsets, offsets[1:], edges)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


# ---------------------------------------------------------------------------
# Inputs whose optima are interior (tests and chip_smoke.py): on such lanes
# no clamp decides x, so a check of x and U there checks the gradient.
# ---------------------------------------------------------------------------
def steps_interior_case(X: int, n_groups: int, seed: int, device,
                        lr: float = 0.15) -> tuple:
    """Kernel row 2's inputs built so that the optima are interior, from
    a numpy seed: ``n_groups`` edge servers with constants drawn around
    ``EdgeParams``' defaults, each user a target (xB*, xr*) in
    [0.15, 0.85]^2 at which dU/dxr = 0 (through f_e and the weights'
    scale, given lr·d²U/dxr² in [0.1, 1]) and dU/dxB = 0 (through w + m);
    the weights shrink where lr·d²U/dxB² would pass 1, so every lane's GD
    converges without bouncing off a clamp.  Returns (feat (X, NF), x0
    (X, 2) in [0.3, 0.7]^2, offsets, edges (dicts of floats)), all rows
    offloaded."""
    rng = np.random.default_rng(seed)
    edges = [dict(c_min=rng.uniform(30e9, 60e9),
                  rho_min=rng.uniform(1e-4, 4e-4),
                  lam_a=rng.uniform(0.7, 0.95),
                  rho_B=rng.uniform(5e-5, 2e-4),
                  gamma_B=rng.uniform(1.1, 1.6),
                  B0=float(rng.choice([1e6, 2e6])),
                  B_backhaul=rng.uniform(5e8, 2e9), N0=4e-21, B_min=1e6,
                  B_max=2e7, r_min=1.0, r_max=32.0)
             for _ in range(n_groups)]
    grp = np.sort(rng.integers(0, n_groups, X))
    e = {k: np.array([g[k] for g in edges])[grp] for k in edges[0]}
    B_span, r_span = e["B_max"] - e["B_min"], e["r_max"] - e["r_min"]
    B = e["B_min"] + rng.uniform(0.15, 0.85, X) * B_span
    r = e["r_min"] + rng.uniform(0.15, 0.85, X) * r_span
    a, gam = e["lam_a"], e["gamma_B"]
    c_dev = rng.uniform(3e9, 60e9, X)
    p_tx = rng.uniform(0.2, 1.0, X)
    c1 = p_tx * 1e-10 * rng.uniform(0.3, 3.0, X)          # pαg
    k = rng.uniform(1.0, 10.0, X)
    # dU/dr = 0 at r: wT·f_e·a·r^(-a-1)/c_min = wC·ρ_min/k =: g0, and
    # lr·d²U/dxr² = lr·r_span²·g0·(a + 1)/r
    g0 = rng.uniform(0.1, 1.0, X) * r / (lr * r_span ** 2 * (a + 1))
    d = rng.dirichlet(np.full(3, 4.0), X)
    wts = d * (g0 * k / (d[:, 2] * e["rho_min"]))[:, None]
    f_e = g0 * e["c_min"] * r ** (a + 1) / (a * wts[:, 0])
    q = c1 / e["N0"]

    def dU_dB(Bv, wm, wts):
        L = np.log2(1.0 + q / Bv)
        dtau = L - q / (np.log(2.0) * (Bv + q))
        return (-wts[:, 0] * wm / Bv ** 2
                - wts[:, 1] * p_tx * wm * dtau / (Bv * L) ** 2
                + wts[:, 2] * e["rho_B"] * gam * (Bv / e["B0"]) ** gam
                / (Bv * k))

    # dU/dB = 0 at B through w + m: its terms are linear in w + m
    wm = (wts[:, 2] * e["rho_B"] * gam * (B / e["B0"]) ** gam / (B * k)
          / -(dU_dB(B, 1.0, wts * [1.0, 1.0, 0.0])))
    h = 1e-4 * B
    hB = lr * B_span ** 2 * (dU_dB(B + h, wm, wts)
                             - dU_dB(B - h, wm, wts)) / (2 * h)
    wts = wts / np.maximum(hB, 1.0)[:, None]
    cols = [rng.uniform(0.0, 5e9, X), f_e, 0.9 * wm, 0.1 * wm, np.ones(X),
            c_dev, 3e-31 * c_dev ** 2, p_tx, c1,
            rng.integers(1, 6, X).astype(np.float64), k,
            rng.uniform(0.0, 5e-3, X), wts[:, 0], wts[:, 1], wts[:, 2]]
    feat = np.zeros((X, 16), np.float32)
    for i, v in enumerate(cols):
        feat[:, i] = v
    x0 = rng.uniform(0.3, 0.7, (X, 2)).astype(np.float32)
    offsets = np.searchsorted(grp, np.arange(n_groups + 1)).tolist()
    return (torch.from_numpy(feat).to(device), torch.from_numpy(x0).to(
        device), offsets, edges)


def interior_lanes(x, feat):
    """Rows that offload and end with both coordinates strictly inside
    (0, 1): where no clamp decides x."""
    return ((x > 0) & (x < 1)).all(1) & (feat[:, 4] > 0)


# ---------------------------------------------------------------------------
# A rehearsal of a sweep body on the card's approximate instructions (only
# tests use it): the algebra such a body would run — shared reciprocals of
# B, r and 1 + q/B, r^-a and r^(-a-1) from one log2, multiply-adds fused,
# ||g|| < eps tested as gsq < eps² — in float32 on whole tensors, with every
# reciprocal, exp2 and log2 perturbed by a seeded error up to the PTX ISA's
# stated maximum of the instruction that would compute it: rcp.approx.ftz
# 1 ulp (2^-23 relative), ex2.approx.ftz 2 ulp (2^-22 relative),
# lg2.approx.ftz 2^-22 absolute (2 ulp where |log2 x| > 1).  A fused
# multiply-add is the float64 sum rounded once to float32.
# tests/test_torch_ligd_sweep.py holds it against the JAX reference at the
# card's tolerances, which is how it shows where csrc/sweep.cu must stay
# exact.
# ---------------------------------------------------------------------------
class _Approx:
    """The perturbed instructions, drawing from one seeded generator
    (``seed=None``: unperturbed)."""

    def __init__(self, seed):
        self.gen = None if seed is None else torch.Generator().manual_seed(
            seed)

    def _unit(self, y):
        if self.gen is None:
            return torch.zeros_like(y)
        return torch.rand(y.shape, generator=self.gen) * 2.0 - 1.0

    def lg2(self, a):
        y = torch.log2(a)
        return y + self._unit(y) * torch.clamp_min(y.abs(), 1.0) * 2.0 ** -22

    def ex2(self, a):
        y = torch.exp2(a)
        return y * (1.0 + self._unit(y) * 2.0 ** -22)

    def rcp(self, a):
        y = 1.0 / a
        return y * (1.0 + self._unit(y) * 2.0 ** -23)


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _fast_u1(fr, f_l, f_e, w, offl, ap):
    """(U, grad) closure of U1 in the fast body's algebra."""
    B_min, Bs = fr["B_min"], fr["B_max"] - fr["B_min"]
    r_min, rs = fr["r_min"], fr["r_max"] - fr["r_min"]
    q, inv_B0 = fr["c1"] / fr["N0"], 1.0 / fr["B0"]
    nla, gam = -fr["lam_a"], fr["gamma_B"]
    inv_k = 1.0 / fr["k"]
    ow = offl * (w + fr["m"])
    uc = _fma(f_l, fr["wT"] / fr["c_dev"] + fr["wE"] * fr["epf"],
              fr["wT"] * (fr["t_ag"] * inv_k))
    uc = _fma(ow, fr["wT"] * fr["hops"] / fr["B_bh"], uc)
    cTs = offl * f_e * (fr["wT"] / fr["c_min"])
    cTu, cE = fr["wT"] * ow, fr["wE"] * fr["p_tx"] * ow
    cCr = fr["wC"] * fr["rho_min"] * inv_k * offl
    cCB = fr["wC"] * fr["rho_B"] * inv_k * offl
    minus_inv_ln2 = torch.full_like(q, -1.0 / LN2)

    def ug(x):
        xB, xr = x
        B, r = _fma(xB, Bs, B_min), _fma(xr, rs, r_min)
        inv_lam = ap.ex2(nla * ap.lg2(r))
        inv_r, inv_B = ap.rcp(r), ap.rcp(B)
        qB = q * inv_B
        L = ap.lg2(1.0 + qB)
        inv_tau = inv_B * ap.rcp(L)
        pw = ap.ex2(gam * ap.lg2(B * inv_B0))
        U = _fma(cTs, inv_lam, uc)
        for c, v in ((cTu, inv_B), (cE, inv_tau), (cCr, r), (cCB, pw)):
            U = _fma(c, v, U)
        dtau = _fma(minus_inv_ln2, qB * ap.rcp(1.0 + qB), L)
        dB = _fma(-(cE * dtau) * inv_tau, inv_tau, -(cTu * inv_B) * inv_B)
        dB = _fma(cCB * gam * pw, inv_B, dB)
        dr = _fma(nla * cTs * inv_lam, inv_r, cCr)
        return U, (dB * Bs, dr * rs)
    return ug


def _fast_u2(fr, ap):
    """(U₂, dU₂/dxB_back) closure in the fast body's algebra."""
    B_min, Bs = fr["B_min"], fr["B_max"] - fr["B_min"]
    q, inv_B0, gam = fr["c1"] / fr["N0"], 1.0 / fr["B0"], fr["gamma_B"]
    wm, inv_k = fr["w_o"] + fr["m"], 1.0 / fr["k"]
    lam_o = torch.exp2(fr["lam_a"] * torch.log2(fr["r_o"]))
    u2c = (fr["wT"] * (fr["f_l_o"] / fr["c_dev"]
                       + fr["f_e_o"] / (lam_o * fr["c_min"])
                       + fr["hops_bk"] * wm / fr["B_bh"])
           + fr["wE"] * fr["epf"] * fr["f_l_o"]
           + fr["wC"] * fr["rent_o"] * inv_k)
    cT, cE = fr["wT"] * wm, fr["wE"] * fr["p_tx"] * wm
    cCB = fr["wC"] * fr["rho_B"] * inv_k
    minus_inv_ln2 = torch.full_like(q, -1.0 / LN2)

    def ug(xBb):
        B = _fma(xBb, Bs, B_min)
        inv_B = ap.rcp(B)
        qB = q * inv_B
        L = ap.lg2(1.0 + qB)
        inv_tau = inv_B * ap.rcp(L)
        pw = ap.ex2(gam * ap.lg2(B * inv_B0))
        U = _fma(cT, inv_B, u2c)
        U = _fma(cCB, pw, _fma(cE, inv_tau, U))
        dtau = _fma(minus_inv_ln2, qB * ap.rcp(1.0 + qB), L)
        dB = _fma(-(cE * dtau) * inv_tau, inv_tau, -(cT * inv_B) * inv_B)
        dB = _fma(cCB * gam * pw, inv_B, dB)
        return U, dB * Bs
    return ug


def _fast_gd(ug_fn, x, *, lr, eps, max_iters):
    """Projected GD with the paper's rule, in the fast body's algebra:
    x - lr·g fused, gsq < eps² for ||g|| < eps."""
    u, g = ug_fn(x)
    it = torch.zeros_like(u)
    done = torch.zeros(u.shape, dtype=torch.bool)
    eps2 = torch.tensor(eps, dtype=torch.float32) ** 2
    while True:
        active = torch.logical_not(done) & (it < float(max_iters))
        if not bool(active.any()):
            return x, u, it
        x_new = tuple(torch.clamp(_fma(torch.full_like(gi, -lr), gi, xi),
                                  0.0, 1.0) for xi, gi in zip(x, g))
        u_new, g_new = ug_fn(x_new)
        gsq = g[0] * g[0]
        for gi in g[1:]:
            gsq = _fma(gi, gi, gsq)
        small_dx = functools.reduce(torch.logical_and, [
            torch.abs(a - b) < eps for a, b in zip(x_new, x)])
        stop = (gsq < eps2) | (torch.abs(u_new - u) < eps) | small_dx
        x = tuple(torch.where(active, a, b) for a, b in zip(x_new, x))
        u = torch.where(active, u_new, u)
        g = tuple(torch.where(active, a, b) for a, b in zip(g_new, g))
        done = torch.where(active, stop, done)
        it = it + active.to(it.dtype)


def fast_math_sweep_twin(feat, x0, tables, *, joint, lr=0.15, eps=1e-5,
                         max_iters=400, warm_start=True, init=None,
                         seed=None):
    """The sweep in a fast-math body's algebra (CPU tensors), perturbed
    from ``seed`` (None: unperturbed).  Returns what :func:`_sweep_ref`
    returns."""
    ap = _Approx(seed)
    fr = _frows(feat)
    tab = table_tensor(tables, feat.device)
    x = tuple(x0[i] for i in range(x0.shape[0]))
    u_b = torch.full_like(x[0], math.inf)
    s_b = torch.zeros_like(x[0])
    x_b = x
    us, xs, its = [], [], []
    u2 = _fast_u2(fr, ap) if joint else None
    for s in range(tab.shape[0]):
        if not warm_start:
            x = tuple(torch.full_like(x[0], v) for v in init)
        u1 = _fast_u1(fr, tab[s, 0], tab[s, 1], tab[s, 2], tab[s, 3], ap)
        if joint:
            def ug(x, u1=u1):
                U1, (g1B, g1r) = u1(x[:2])
                U2, g2 = u2(x[3])
                R = x[2]
                omR = 1.0 - R
                return (_fma(R, U2 - U1, U1),
                        (omR * g1B, omR * g1r, U2 - U1, R * g2))
        else:
            ug = u1
        x, u, it = _fast_gd(ug, x, lr=lr, eps=eps, max_iters=max_iters)
        better = u < u_b
        u_b = torch.where(better, u, u_b)
        s_b = torch.where(better, float(s), s_b)
        x_b = tuple(torch.where(better, a, b) for a, b in zip(x, x_b))
        us.append(u)
        xs.append(torch.stack(x, 0))
        its.append(it)
    x_l = torch.stack(xs, 0)
    return (torch.stack(us, 0), tuple(x_l[:, i] for i in range(len(x))),
            torch.stack(its, 0), s_b, x_b, u_b)


# ---------------------------------------------------------------------------
# The same rehearsal for the single-split steps (csrc/steps.cu): one
# reciprocal of B a step gives q/B, 1/B² and the rent term's quotient;
# 1/τ = (1/B)·(1/L); q/(ln2·(B + q)) = (q/B)·(1/ln2)·(1/(1 + q/B)); r^(-a-1)
# and, for the final utility, r^-a from one log2(r); 1/k, 1/c_min, 1/c_dev,
# 1/B_backhaul and 1/N0 hoisted out of the loop (computed once a row, or
# once a group, by division).  Every reciprocal, exp2 and log2 of the
# loop and of the final utility is perturbed as above; multiply-adds are
# fused.  tests/test_torch_ligd_steps.py holds it against the JAX
# package's autodiff oracle at the reference test's tolerances, which is
# how it decides the instructions of csrc/steps.cu's body.
# ---------------------------------------------------------------------------
def _steps_consts(feat, edge):
    """The x-independent terms of a steps body, as csrc/steps.cu computes
    them once a row (edge constants may be floats or (X,) tensors: one
    group's, or gathered per row)."""
    f = feat.float().T
    e = {k: torch.as_tensor(edge[k], dtype=torch.float32) for k in EDGE_KEYS}
    f_l, f_e, wm, offl = f[0], f[1], f[2] + f[3], f[4]
    wT, wE, wC = f[12], f[13], f[14]
    inv_k = 1.0 / f[10]
    ow = offl * wm
    wCo_k = wC * offl * inv_k
    cTs = wT * offl * f_e * (1.0 / e["c_min"])
    cCB = wCo_k * e["rho_B"]
    u_const = _fma(wE * f[6], f_l, wT * (
        f_l * (1.0 / f[5]) + ow * f[9] * (1.0 / e["B_backhaul"])
        + f[11] * inv_k))
    B_span = e["B_max"] - e["B_min"]
    r_span = e["r_max"] - e["r_min"]
    return dict(
        B_min=e["B_min"], B_span=B_span, r_min=e["r_min"], r_span=r_span,
        q=f[8] * (1.0 / e["N0"]), inv_B0=1.0 / e["B0"], gam=e["gamma_B"],
        nla=-e["lam_a"], a1=-e["lam_a"] - 1.0, u_const=u_const, cTs=cTs,
        cT=wT * ow, cE=wE * f[7] * ow, cCr=wCo_k * e["rho_min"], cCB=cCB,
        cCg=cCB * e["gamma_B"], cR=cTs * -e["lam_a"],
        inv_ln2=torch.tensor(1.0 / LN2, dtype=torch.float32))


def _steps_B_terms(c, xB, ap):
    """B, 1/B, q/B, L = log2(1 + q/B), 1/τ and g(B)/ρ_B = (B/B0)^γ."""
    B = _fma(xB, c["B_span"], c["B_min"])
    inv_B = ap.rcp(B)
    qB = c["q"] * inv_B
    one_qB = 1.0 + qB
    L = ap.lg2(one_qB)
    inv_tau = inv_B * ap.rcp(L)
    pw = ap.ex2(c["gam"] * ap.lg2(B * c["inv_B0"]))
    return inv_B, qB, one_qB, L, inv_tau, pw


def fast_math_steps_twin(feat, x0, edge, *, iters=64, lr=0.15, seed=None):
    """The single-split steps in csrc/steps.cu's fast-math algebra (CPU
    tensors), perturbed from ``seed`` (None: unperturbed).  feat (X, NF),
    x0 (X, 2), ``edge`` one group's constants -> (x (X, 2), U (X,))."""
    ap = _Approx(seed)
    c = _steps_consts(feat, edge)
    lrBs = -lr * c["B_span"]
    lrrs = -lr * c["r_span"]
    xB, xr = x0[:, 0].float(), x0[:, 1].float()
    for _ in range(iters):
        inv_B, qB, one_qB, L, inv_tau, pw = _steps_B_terms(c, xB, ap)
        r = _fma(xr, c["r_span"], c["r_min"])
        dtau = _fma(-(qB * ap.rcp(one_qB)), c["inv_ln2"], L)
        dB = _fma(-(c["cE"] * dtau) * inv_tau, inv_tau,
                  -(c["cT"] * inv_B) * inv_B)
        dB = _fma(c["cCg"] * pw, inv_B, dB)
        dr = _fma(c["cR"], ap.ex2(c["a1"] * ap.lg2(r)), c["cCr"])
        xB = torch.clamp(_fma(lrBs, dB, xB), 0.0, 1.0)
        xr = torch.clamp(_fma(lrrs, dr, xr), 0.0, 1.0)
    inv_B, _, _, _, inv_tau, pw = _steps_B_terms(c, xB, ap)
    r = _fma(xr, c["r_span"], c["r_min"])
    U = _fma(c["cTs"], ap.ex2(c["nla"] * ap.lg2(r)), c["u_const"])
    for k, v in (("cT", inv_B), ("cE", inv_tau), ("cCr", r), ("cCB", pw)):
        U = _fma(c[k], v, U)
    return torch.stack([xB, xr], 1), U
