"""The §6 baseline policies of the port against the JAX package's, and the
policy-matrix invariants on the port.

* Every baseline policy (``device_only``, ``edge_only``,
  ``greedy_nearest``, ``dnn_surgery``, ``cloud``) through ``Session`` on
  ``paper_fig1`` and ``chaos_singlefail_k3`` (the presets' own sizes):
  every FleetState column after the plan and after each step, and the
  step accounting.  On the chaos preset the baselines without a fault
  hook get the session's synthesized evacuation handoffs, ``cloud`` its
  own ``on_faults``.
* ``MCSAPlanner.run_baseline`` for each evaluator.
* ``tools/policy_matrix.py``'s invariants, on the port alone, on
  ``capacitated_k3`` and ``chaos_singlefail_k3``: finite, positive mean
  delay for every policy, no user offloading to a down server, and MCSA
  never worse than the worst baseline.

Tolerances are ``torch_diff``'s.  The latency-greedy baselines take the
first split of least T; users whose two smallest per-split T in the
reference are within 1e-4 of each other are named near-ties (at most 1 %)
and may differ in their discrete columns."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                       # noqa: E402
import jax.numpy as jnp                                          # noqa: E402

import repro.api.policies as jpolicies                           # noqa: E402
from repro.api import Session as JSession                        # noqa: E402
from repro.api import get_scenario as j_get_scenario             # noqa: E402
from repro.core import baselines as jbase                        # noqa: E402
from repro.core.costs import utility as j_utility                # noqa: E402
from repro.core.planner import MCSAPlanner as JPlanner           # noqa: E402
from repro_torch.api import POLICIES, Session as TSession        # noqa: E402
from repro_torch.api import get_scenario as t_get_scenario       # noqa: E402
from repro_torch.api import make_policy                          # noqa: E402
from repro_torch.core import planner as tplanner                 # noqa: E402
from repro_torch.core.baselines import BASELINES                 # noqa: E402

from torch_diff import (assert_discrete, assert_fleets_agree,    # noqa: E402
                        assert_rel, near_ties)

BASELINE_POLICIES = ("device_only", "edge_only", "greedy_nearest",
                     "dnn_surgery", "cloud")


def _t_all(name: str, profile, devs, edge) -> np.ndarray:
    """(X, M+1) per-split T of a latency-greedy baseline, through the
    reference's own tables, allocation rule and utility."""
    f_l, f_e, w, m = jbase._tables(profile)

    def per_user(d, e):
        cap = None
        if name == "dnn_surgery":
            cap = e["r_min"] + 0.5 * (e["r_max"] - e["r_min"])

        def per_split(s):
            r = jbase._r_base(e, f_e[s], f_l[-1], cap)
            return j_utility(d, e, f_l[s], f_e[s], w[s], m, e["B_max"],
                             r)[1][0]
        return jax.vmap(per_split)(jnp.arange(profile.num_layers + 1))

    in_e = 0 if jnp.ndim(next(iter(edge.values()))) > 0 else None
    return np.asarray(jax.vmap(per_user, in_axes=(0, in_e))(devs, edge))


class BaselineTap:
    """Wraps the reference policies' batched evaluation (``monkeypatch``;
    the JAX package is untouched) and marks the users whose two best
    per-split T are within ``RTOL`` (latency-greedy baselines only)."""

    def __init__(self, monkeypatch, num_users: int):
        self.ties = np.zeros(num_users, bool)
        self._users = None
        real_eval = jpolicies.run_baseline_batch
        real_hand = jpolicies.BaselinePolicy.on_handoffs
        real_plan = jpolicies.BaselinePolicy.plan

        def run(name, profile, devs, edge):
            if name in ("neurosurgeon", "dnn_surgery"):
                ties = near_ties(_t_all(name, profile, devs, edge))
                self.ties[self._users] |= ties
            return real_eval(name, profile, devs, edge)

        def plan(policy, devices, user_aps):
            self._users = np.arange(len(user_aps))
            return real_plan(policy, devices, user_aps)

        def on_handoffs(policy, events, devices, fleet):
            self._users = np.asarray(events.user)
            return real_hand(policy, events, devices, fleet)

        monkeypatch.setattr(jpolicies, "run_baseline_batch", run)
        monkeypatch.setattr(jpolicies.BaselinePolicy, "plan", plan)
        monkeypatch.setattr(jpolicies.BaselinePolicy, "on_handoffs",
                            on_handoffs)


@pytest.mark.parametrize("scenario", ["paper_fig1", "chaos_singlefail_k3"])
@pytest.mark.parametrize("policy", BASELINE_POLICIES)
def test_baseline_policy_matches_reference(policy, scenario, monkeypatch):
    js_sc, ts_sc = j_get_scenario(scenario), t_get_scenario(scenario)
    tap = BaselineTap(monkeypatch, js_sc.num_users)
    js = JSession(js_sc, policy=policy)
    ts = TSession(ts_sc, policy=policy, device="cpu")
    assert type(ts.policy).__name__ == type(js.policy).__name__
    assert ts.policy.device.type == "cpu"
    assert ts.admission is None and js.admission is None
    assert_fleets_agree(ts.fleet, js.fleet, tap.ties, f"{policy} plan")
    for k in range(ts_sc.steps):
        jr, tr = js.step(), ts.step()
        assert len(tr.events) == len(jr.events)
        assert (tr.faults is None) == (jr.faults is None)
        assert_fleets_agree(ts.fleet, js.fleet, tap.ties,
                            f"{policy} {scenario} step {k}")
    mj, mt = js.run(), ts.run()
    for f in ("t", "handoffs", "relays", "resplits"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f), f)
    for f in ("mean_T", "mean_E", "mean_C"):
        assert_rel(getattr(mt, f), getattr(mj, f), f)
    assert mt.faults == mj.faults
    assert tap.ties.mean() <= 0.01, np.nonzero(tap.ties)[0].tolist()
    if scenario == "chaos_singlefail_k3":
        assert mt.faults["recovery_times_s"] == [120.0]


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_run_baseline_matches_reference(name, monkeypatch):
    sc_j, sc_t = j_get_scenario("paper_fig1"), t_get_scenario("paper_fig1")
    jt, tt = sc_j.build_topology(), sc_t.build_topology()
    aps = jt.nearest_ap(sc_j.build_mobility(jt).positions())
    jp = JPlanner(sc_j.build_profile(), jt, sc_j.ligd)
    tp = tplanner.MCSAPlanner(sc_t.build_profile(), tt, sc_t.ligd,
                              device="cpu")
    jdev, tdev = sc_j.build_devices(), sc_t.build_devices()
    jr = jp.run_baseline(name, jdev, aps)
    tr = tp.run_baseline(name, tdev, aps)
    ties = np.zeros(len(aps), bool)
    if name in ("neurosurgeon", "dnn_surgery"):
        from repro.core.costs import stack_devices
        devs = dict(stack_devices(jdev))
        srv = jt.ap_server[aps]
        devs["hops"] = jnp.asarray(jt.hops[aps, srv], jnp.float32)
        ties = near_ties(_t_all(name, jp.profile, devs, jp._edges_for(srv)))
    assert_discrete(tr.split.long(), np.asarray(jr.split, np.int64), ties,
                    f"{name} split")
    for f in ("B", "r", "U", "T", "E", "C"):
        assert_rel(getattr(tr, f), getattr(jr, f), f"{name} {f}",
                   rows=~ties)


def _matrix_cell(scenario, policy: str) -> dict:
    s = TSession(scenario, policy=policy, device="cpu")
    m = s.run()
    offl = s.fleet.split < s.profile.num_layers
    up = s.topo.server_available()
    return {"mean_T": float(m.mean_T.mean()),
            "stranded": int(((~up[s.fleet.server]) & offl).sum())}


@pytest.mark.parametrize("scenario", ["capacitated_k3",
                                      "chaos_singlefail_k3"])
def test_policy_matrix_invariants_on_the_port(scenario):
    sc = t_get_scenario(scenario)
    cells = {p: _matrix_cell(sc, p) for p in sorted(POLICIES)}
    for p, c in cells.items():
        assert np.isfinite(c["mean_T"]) and c["mean_T"] > 0, (p, c)
        assert c["stranded"] == 0, (p, c)
    worst = max(c["mean_T"] for p, c in cells.items() if p != "mcsa")
    assert cells["mcsa"]["mean_T"] <= worst * (1 + 1e-6), cells


def test_make_policy_passes_the_device_to_every_solving_policy():
    sc = t_get_scenario("paper_fig1")
    topo, prof = sc.build_topology(), sc.build_profile()
    for name in POLICIES:
        pol = make_policy(name, sc, prof, topo, device="cpu")
        assert pol.device.type == "cpu", name
    with pytest.raises(KeyError, match="unknown policy"):
        make_policy("nope", sc, prof, topo, device="cpu")
