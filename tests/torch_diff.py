"""Differential-test helpers shared by the ``test_torch_*`` files: the
same numpy inputs go through the JAX package and the PyTorch port, and
these compare what comes out to the tolerances the port is held to.

Tolerances, with their reasons:

* ``RTOL = 1e-4`` on continuous outputs (U, B, r, T, E, C): XLA's and
  ATen's exp2/log2/pow differ by a few ulps, and those ulps travel
  through up to a few hundred GD steps.
* Discrete outputs (split, R, server) must be equal, except for users
  whose two best per-layer utilities in the reference are within
  ``RTOL`` of each other (near-ties, where an ulp may pick the other
  split).  Such users are named in the failure message and may be at
  most ``NEAR_TIE_SHARE`` of the batch.
* Iteration counts equal on at least ``ITERS_EQUAL_SHARE`` of lanes and
  within ±1 on the rest: a lane whose |ΔU| sits on the ε threshold can
  stop one step apart.
* Admission choices (server, spills, rejections) must be equal, except
  for users the reference's own waterfill names as near-ties: two
  candidate utilities within ``ADMISSION_RTOL``, or a proposal at a
  server's water level whose U ties its neighbour's or whose running r /
  B sum is within ``ADMISSION_RTOL`` of the remaining budget
  (:class:`ReferenceTap`).  ``ADMISSION_RTOL = 2e-6`` is tighter than
  ``RTOL``: what the waterfill ranks and sums is the solves' U, r and B,
  which agree with the reference to at most 2.3e-7 relative over every
  admission of the ``capacitated_k3``, ``chaos_singlefail_k3`` and
  ``chaos_churn`` sessions, so two proposals can swap only when they are
  closer than 4.6e-7; 2e-6 names every pair within four times that.
  ``RTOL`` would also name users of one AP whose edge-only candidates
  differ by 2e-5 (2.6 % of ``capacitated_k3``'s fleet).
"""
from __future__ import annotations

import numpy as np

RTOL = 1e-4
ADMISSION_RTOL = 2e-6
NEAR_TIE_SHARE = 0.01
ITERS_EQUAL_SHARE = 0.99


def sweep_columns(joint: bool, X: int, seed: int = 2):
    """Host inputs of a sweep test, drawn as tests/test_kernels.py's
    ``_sweep_inputs`` draws them: (device columns, original-strategy
    columns or None).  Shared edge = ``EdgeParams()`` defaults."""
    from repro_torch.core.costs import DeviceFleet
    rng = np.random.default_rng(seed)
    dev = dict(DeviceFleet(c_dev=rng.uniform(3e9, 60e9, X),
                           w_T=rng.uniform(0.2, 0.5, X)).arrays)
    orig = None
    if joint:
        orig = {"f_l": rng.uniform(5e8, 2e9, X),
                "f_e": rng.uniform(1e9, 4e9, X),
                "w": rng.uniform(1e5, 4e6, X),
                "r": rng.uniform(1.0, 16.0, X),
                "rent": rng.uniform(1e-4, 5e-3, X),
                "hops_back": rng.integers(1, 8, X).astype(np.float64)}
    return dev, orig


def np_of(a) -> np.ndarray:
    """numpy view of a jax array, torch tensor or array-like."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def near_ties(u_layers, rtol: float = RTOL) -> np.ndarray:
    """(X,) bool: users whose two smallest per-layer U (``u_layers`` is
    (X, M1)) are within ``rtol`` relative of each other."""
    u = np.sort(np.asarray(np_of(u_layers), np.float64), axis=1)
    return (u[:, 1] - u[:, 0]) <= rtol * np.abs(u[:, 0])


def assert_discrete(port, ref, ties: np.ndarray, name: str) -> None:
    """Exact, except on near-tie users (named; at most 1%)."""
    port, ref = np_of(port), np_of(ref)
    differ = port != ref
    bad = np.nonzero(differ & ~ties)[0]
    assert len(bad) == 0, (f"{name} differs outside near-ties at users "
                           f"{bad.tolist()}: port {port[bad].tolist()} vs "
                           f"ref {ref[bad].tolist()}")
    tied = np.nonzero(differ)[0]
    assert len(tied) <= NEAR_TIE_SHARE * len(ref), (
        f"{name}: {len(tied)} near-tie users differ (> {NEAR_TIE_SHARE:.0%}"
        f"): {tied.tolist()}")


def assert_rel(port, ref, name: str, rtol: float = RTOL,
               rows=None) -> None:
    """Relative closeness (absolute floor 1e-30), optionally on rows."""
    port = np.asarray(np_of(port), np.float64)
    ref = np.asarray(np_of(ref), np.float64)
    if rows is not None:
        port, ref = port[rows], ref[rows]
    rel = np.abs(port - ref) / np.maximum(np.abs(ref), 1e-30)
    assert rel.size == 0 or rel.max() <= rtol, (
        f"{name}: max rel err {rel.max():.3g} > {rtol} at "
        f"{np.unravel_index(np.argmax(rel), rel.shape)}")


def assert_iters(port, ref, name: str = "iters") -> None:
    port = np.asarray(np_of(port), np.int64)
    ref = np.asarray(np_of(ref), np.int64)
    d = np.abs(port - ref)
    assert d.max(initial=0) <= 1, f"{name}: max |diff| {d.max()} > 1"
    lanes = d.reshape(d.shape[0], -1).max(axis=1) if d.ndim > 1 else d
    assert np.mean(lanes == 0) >= ITERS_EQUAL_SHARE, (
        f"{name}: only {np.mean(lanes == 0):.2%} lanes agree")


def jax_joint_ties(profile, devs, edge_new, origs, hops_back, cfg,
                   res) -> np.ndarray:
    """(X,) bool near-ties of one reference MLi-GD batch: the two best
    per-layer joint U within ``RTOL`` (recomputed through the reference's
    own masked sweep on the same packed features), or the two R vertices
    within ``RTOL`` of each other."""
    import jax.numpy as jnp
    from repro.kernels.ligd_step import (mligd_sweep_ref,
                                         pack_sweep_features, sweep_tables)
    X = devs["c_dev"].shape[0]
    feat = pack_sweep_features(
        devs, edge_new, jnp.asarray(profile.result_bits, jnp.float32), X,
        orig=origs, hops_back=jnp.asarray(hops_back, jnp.float32))
    init4 = (*cfg.init, 0.5, 0.5)
    x0 = jnp.broadcast_to(jnp.asarray(init4, jnp.float32)[:, None], (4, X))
    u = mligd_sweep_ref(feat, x0, sweep_tables(profile), lr=cfg.lr,
                        eps=cfg.eps, max_iters=cfg.max_iters,
                        chunk=cfg.chunk, warm_start=cfg.warm_start,
                        init=init4)[0]
    u1 = np.asarray(res.U_recalc, np.float64)
    u2 = np.asarray(res.U_back, np.float64)
    return near_ties(np.asarray(u).T) | (np.abs(u1 - u2)
                                         <= RTOL * np.abs(u1))


def candidate_ties(cand, U, rtol: float = ADMISSION_RTOL) -> np.ndarray:
    """(X,) bool: rows whose preference order over their candidate
    columns may flip — two columns on different servers (or the same
    server with different U) whose utilities are within ``rtol`` of each
    other.  Exact duplicates (the same server, the same U: the fault
    path's masked columns) pick the same plan either way."""
    cand = np.asarray(cand)
    U = np.asarray(U, np.float64)
    X, K = U.shape
    named = np.zeros(X, bool)
    for i in range(K):
        for j in range(i + 1, K):
            dup = (cand[:, i] == cand[:, j]) & (U[:, i] == U[:, j])
            finite = np.isfinite(U[:, i]) & np.isfinite(U[:, j])
            with np.errstate(invalid="ignore"):
                close = np.abs(U[:, i] - U[:, j]) <= rtol * np.abs(U[:, i])
            named |= close & finite & ~dup
    return named


def waterfill_straddles(cand, U, r_dem, B_dem, num_servers, r_cap=None,
                        B_cap=None, rtol: float = ADMISSION_RTOL
                        ) -> np.ndarray:
    """(X,) bool: rows whose admission may flip under ``rtol``
    perturbations of U or of the demands — a replay of the reference's
    ``admit_waterfill`` rounds that names, per server and round, every
    proposal whose running r or B sum is within ``rtol`` of the
    server's remaining budget, and both proposals on either side of the
    water level when their U are within ``rtol``."""
    from repro.core.admission import _segmented_running_sum
    cand = np.asarray(cand, np.int64)
    U = np.asarray(U, np.float64)
    r_dem = np.asarray(r_dem, np.float64)
    B_dem = np.asarray(B_dem, np.float64)
    X, K = cand.shape
    rem_r = (np.full(num_servers, np.inf) if r_cap is None
             else np.asarray(r_cap, np.float64).copy())
    rem_B = (np.full(num_servers, np.inf) if B_cap is None
             else np.asarray(B_cap, np.float64).copy())
    pref = np.argsort(U, axis=1, kind="stable")
    choice = np.full(X, -1, np.int64)
    rank = np.zeros(X, np.int64)
    named = np.zeros(X, bool)
    for _ in range(K):
        active = np.nonzero((choice < 0) & (rank < K))[0]
        if active.size == 0:
            break
        k_sel = pref[active, rank[active]]
        srv = cand[active, k_sel]
        cost = U[active, k_sel]
        rd = r_dem[active, k_sel]
        Bd = B_dem[active, k_sel]
        order = np.lexsort((active, cost, srv))
        srv_o = srv[order]
        seg = np.empty(len(order), bool)
        seg[0] = True
        seg[1:] = srv_o[1:] != srv_o[:-1]
        run_r = _segmented_running_sum(seg, rd[order])
        run_B = _segmented_running_sum(seg, Bd[order])
        cap_r, cap_B = rem_r[srv_o], rem_B[srv_o]
        with np.errstate(invalid="ignore"):
            near = ((np.isfinite(cap_r)
                     & (np.abs(run_r - cap_r) <= rtol * np.abs(cap_r)))
                    | (np.isfinite(cap_B)
                       & (np.abs(run_B - cap_B) <= rtol * np.abs(cap_B))))
        fits = (run_r <= cap_r) & (run_B <= cap_B)
        c_o = cost[order]
        edge = ~seg[1:] & (fits[:-1] != fits[1:])
        with np.errstate(invalid="ignore"):
            gap = np.abs(c_o[1:] - c_o[:-1])
            # equal U are identical inputs (an edge-only optimum does not
            # depend on the device): the port ties them too, and both
            # sides then order by user id
            edge &= (gap > 0) & (gap <= rtol * np.abs(c_o[:-1]))
        flip = near.copy()
        flip[:-1] |= edge
        flip[1:] |= edge
        named[active[order[flip]]] = True
        acc = order[fits]
        choice[active[acc]] = k_sel[acc]
        np.subtract.at(rem_r, srv[acc], rd[acc])
        np.subtract.at(rem_B, srv[acc], Bd[acc])
        rank[active[order[~fits]]] += 1
    return named


class ReferenceTap:
    """Wraps the reference planner's batched solves and its admission
    (through pytest's ``monkeypatch``, so the JAX package itself is
    untouched) and records, per user, whether any of them so far saw the
    user as a near-tie — the users whose discrete decisions the port
    may legitimately flip:

    * solve near-ties (:func:`near_ties`, :func:`jax_joint_ties`) of any
      of the user's rows; a K-tiled solve (user-major rows, row x·K+k is
      the user's k-th candidate) is reshaped to (n, K) first;
    * admission near-ties: candidate utilities within ``ADMISSION_RTOL``
      (:func:`candidate_ties`) and water-level straddles
      (:func:`waterfill_straddles`).

    ``solves`` counts the solves, ``admissions`` the waterfills, and
    ``admission_named`` the users the admission checks named."""

    def __init__(self, monkeypatch, num_users: int):
        import repro.core.planner as jplanner
        self.ties = np.zeros(num_users, bool)
        self.solves = 0
        self.admissions = 0
        self.admission_named = 0
        orig_static = jplanner.solve_ligd_batch_jit
        orig_dirty = jplanner.solve_mligd_batch_jit
        orig_admit = jplanner.admit_waterfill
        self._dirty_users = None
        self._dirty_K = 1
        self._admit_users = None

        def static(profile, devs, edge, cfg):
            res = orig_static(profile, devs, edge, cfg)
            rows = res.U_per_layer.shape[0]
            assert rows % num_users == 0, (rows, num_users)
            self._mark(np.arange(num_users), near_ties(res.U_per_layer),
                       rows // num_users)
            self.solves += 1
            return res

        def dirty(profile, devs, edge_new, origs, hops_back, cfg):
            res = orig_dirty(profile, devs, edge_new, origs, hops_back, cfg)
            ties = jax_joint_ties(profile, devs, edge_new, origs,
                                  hops_back, cfg, res)
            self._mark(self._dirty_users, ties, self._dirty_K)
            self.solves += 1
            return res

        def admit(cand, U, r_dem, B_dem, num_servers, r_cap=None,
                  B_cap=None):
            rep = orig_admit(cand, U, r_dem, B_dem, num_servers, r_cap,
                             B_cap)
            users = self._admit_users
            assert users is not None and len(users) == len(cand), (
                "the tap maps admission rows to users only when every "
                "dirty row is admitted (no hysteresis stays)")
            named = candidate_ties(cand, U) | waterfill_straddles(
                cand, U, r_dem, B_dem, num_servers, r_cap, B_cap)
            self.ties[users[named]] = True
            self.admissions += 1
            self.admission_named += int(named.sum())
            return rep

        orig_solve_dirty = jplanner.MCSAPlanner._solve_dirty
        orig_plan_admission = jplanner.MCSAPlanner._plan_admission

        def solve_dirty(planner, dirty_batch, *a, **kw):
            self._dirty_users = np.asarray(dirty_batch.user)
            self._dirty_K = min(planner.candidates_k,
                                planner.topo.num_servers)
            self._admit_users = self._dirty_users
            return orig_solve_dirty(planner, dirty_batch, *a, **kw)

        def plan_admission(planner, devices, user_aps, *a, **kw):
            self._admit_users = np.arange(len(user_aps))
            return orig_plan_admission(planner, devices, user_aps, *a, **kw)

        monkeypatch.setattr(jplanner, "solve_ligd_batch_jit", static)
        monkeypatch.setattr(jplanner, "solve_mligd_batch_jit", dirty)
        monkeypatch.setattr(jplanner, "admit_waterfill", admit)
        monkeypatch.setattr(jplanner.MCSAPlanner, "_solve_dirty",
                            solve_dirty)
        monkeypatch.setattr(jplanner.MCSAPlanner, "_plan_admission",
                            plan_admission)

    def _mark(self, users, row_ties, K: int) -> None:
        """OR (n·K,) row near-ties, user-major, into the users' marks
        (rows past n·K are the reference's padding)."""
        n = len(users)
        t = np.asarray(row_ties, bool)[:n * K].reshape(n, K).any(axis=1)
        self.ties[users] |= t


def assert_fleets_agree(port, ref, ties: np.ndarray, where: str) -> None:
    """Every FleetState column: discrete ones exact outside the named
    near-tie users, continuous ones within ``RTOL`` on the other users."""
    for f in ("server", "split", "R"):
        assert_discrete(getattr(port, f), getattr(ref, f), ties,
                        f"{where} {f}")
    rows = ~ties
    for f in ("B", "r", "U", "T", "E", "C"):
        assert_rel(getattr(port, f), getattr(ref, f), f"{where} {f}",
                   rows=rows)


def assert_admission_agree(port: dict, ref: dict, where: str) -> None:
    """Session admission summaries: counts exact, loads within RTOL."""
    assert (port is None) == (ref is None), where
    if ref is None:
        return
    assert set(port) == set(ref), (where, sorted(port), sorted(ref))
    for k in ("users_per_server", "spilled", "rejected", "degraded"):
        if k in ref:
            assert port[k] == ref[k], (where, k, port[k], ref[k])
    for k in ("r_load", "B_load"):
        assert_rel(port[k], ref[k], f"{where} {k}")


NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "ln_cross",
         "enc_norm")


def _randomise_norms(tree, rng):
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(np.shape(v)).astype(np.asarray(v).dtype)
                    * 0.5 if k in NORMS else _randomise_norms(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_randomise_norms(v, rng) for v in tree)
    return tree


def model_pair(arch: str, *, layers: int, dtype: str = "float32",
               seed: int = 0):
    """(reference cfg, reference params, port cfg, port params): the same
    weights in both packages, from the reference's ``init_lm`` with the
    norm weights randomised (they start at zero, which would hide a
    wrong ``(1 + w)`` convention)."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models import transformer as jtfm
    from repro.runtime.meshenv import CPU_ENV
    from repro_torch import interop
    from repro_torch.configs import get_config, reduced
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch), layers=layers),
                               dtype=dtype)
    tcfg = dataclasses.replace(reduced(get_config(arch), layers=layers),
                               dtype=dtype)
    jp, _ = jtfm.init_lm(jcfg, jax.random.PRNGKey(seed), CPU_ENV)
    tree = jax.tree.map(lambda a: np.asarray(a), jp)
    tree = _randomise_norms(tree, np.random.default_rng(seed + 100))
    jp = jax.tree.map(jnp.asarray, tree)
    return jcfg, jp, tcfg, interop.lm_params_from_numpy(tcfg, tree)


def j_greedy(cfg, params, tokens: np.ndarray, max_new: int):
    """Reference greedy tokens (B, max_new) through prefill + decode_step,
    and the prefill logits."""
    import jax.numpy as jnp
    from repro.models import transformer as jtfm
    from repro.runtime.meshenv import CPU_ENV
    B, S = tokens.shape
    logits, caches = jtfm.prefill(cfg, params, CPU_ENV,
                                  {"tokens": jnp.asarray(tokens)},
                                  cache_len=S + max_new)
    cur = jnp.argmax(logits[:, :cfg.vocab_size], -1).astype(jnp.int32)
    out = [np.asarray(cur)]
    for i in range(max_new - 1):
        _, cur, caches = jtfm.decode_step(cfg, params, CPU_ENV, cur[:, None],
                                          jnp.asarray(S + i, jnp.int32),
                                          caches)
        out.append(np.asarray(cur))
    return np.stack(out, axis=1), np.asarray(logits, np.float32)


def t_greedy(cfg, params, tokens: np.ndarray, max_new: int):
    """The port's counterpart of :func:`j_greedy` (CPU tensors)."""
    import torch
    from repro_torch.models import transformer as ttfm
    B, S = tokens.shape
    tok = torch.from_numpy(tokens.astype(np.int64))
    logits, caches = ttfm.prefill(cfg, params, {"tokens": tok},
                                  cache_len=S + max_new)
    cur = torch.argmax(logits[:, :cfg.vocab_size], -1)
    out = [np_of(cur)]
    for i in range(max_new - 1):
        _, cur, caches = ttfm.decode_step(cfg, params, cur[:, None], S + i,
                                          caches)
        out.append(np_of(cur))
    return np.stack(out, axis=1), np_of(logits.float())


def script_stdout(path, argv) -> str:
    """``chip_smoke.run_script``: what ``main()`` of the script at
    ``path`` prints when run in this process with the command line
    ``argv``, with PyTorch on one CPU thread meanwhile: the twins' ops
    are small, and on a test worker beside others more threads made the
    serve smoke 3-4x slower, not faster."""
    import chip_smoke
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return chip_smoke.run_script(path, argv)
    finally:
        torch.set_num_threads(threads)
