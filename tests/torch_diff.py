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
"""
from __future__ import annotations

import numpy as np

RTOL = 1e-4
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


class ReferenceTap:
    """Wraps the reference planner's batched solves (through pytest's
    ``monkeypatch``, so the JAX package itself is untouched) and records,
    per user, whether any solve so far saw it as a near-tie — the users
    whose discrete decisions the port may legitimately flip."""

    def __init__(self, monkeypatch, num_users: int):
        import repro.core.planner as jplanner
        self.ties = np.zeros(num_users, bool)
        self.solves = 0
        orig_static = jplanner.solve_ligd_batch_jit
        orig_dirty = jplanner.solve_mligd_batch_jit
        self._dirty_users = None

        def static(profile, devs, edge, cfg):
            res = orig_static(profile, devs, edge, cfg)
            self.ties |= near_ties(res.U_per_layer)
            self.solves += 1
            return res

        def dirty(profile, devs, edge_new, origs, hops_back, cfg):
            res = orig_dirty(profile, devs, edge_new, origs, hops_back, cfg)
            ties = jax_joint_ties(profile, devs, edge_new, origs,
                                  hops_back, cfg, res)
            users = self._dirty_users
            self.ties[users] |= ties[:len(users)]
            self.solves += 1
            return res

        orig_solve_dirty = jplanner.MCSAPlanner._solve_dirty

        def solve_dirty(planner, dirty_batch, *a, **kw):
            self._dirty_users = np.asarray(dirty_batch.user)
            return orig_solve_dirty(planner, dirty_batch, *a, **kw)

        monkeypatch.setattr(jplanner, "solve_ligd_batch_jit", static)
        monkeypatch.setattr(jplanner, "solve_mligd_batch_jit", dirty)
        monkeypatch.setattr(jplanner.MCSAPlanner, "_solve_dirty",
                            solve_dirty)


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


NORMS = ("ln1", "ln2", "final_norm", "q_norm", "k_norm")


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
