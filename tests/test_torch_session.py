"""The port's front door (``repro_torch.api``) against the JAX package's:
``Session`` on ``paper_fig1`` (first 6 steps, sync), on a 512-user
``megafleet_100k`` (3 steps, async), on ``dense_urban`` at 400 users (5
steps), ``highway`` (10 steps) and ``static_no_mobility`` (whole), every
FleetState column per step and the handoff/relay/resplit accounting;
``Scenario.to_dict`` across the two
packages for every preset the port registers; the worlds it refused
before admission, faults and serving were ported; and, in a fresh
interpreter, that the port loads neither JAX nor ``repro``.

Tolerances are ``torch_diff``'s: discrete columns exact outside the
users the reference's own solves name as near-ties, continuous columns
within 1e-4 relative on the other users."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import Scenario as JScenario                      # noqa: E402
from repro.api import Session as JSession                        # noqa: E402
from repro.api import get_scenario as j_get_scenario             # noqa: E402
from repro_torch import interop                                  # noqa: E402
from repro_torch.api import Scenario as TScenario                # noqa: E402
from repro_torch.api import Session as TSession                  # noqa: E402
from repro_torch.api import get_scenario as t_get_scenario       # noqa: E402
from repro_torch.api import list_scenarios                       # noqa: E402

from torch_diff import ReferenceTap, assert_fleets_agree         # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name, changes, steps", [
    ("paper_fig1", {}, 6),
    ("megafleet_100k", {"num_users": 512, "steps": 3}, 3),
    ("dense_urban", {"num_users": 400, "steps": 5}, 5),
    ("highway", {"steps": 10}, 10),
    ("static_no_mobility", {}, 5),
])
def test_session_matches_reference(name, changes, steps, monkeypatch):
    js_sc = j_get_scenario(name).replace(**changes)
    ts_sc = t_get_scenario(name).replace(**changes)
    assert ts_sc.to_dict() == js_sc.to_dict()
    tap = ReferenceTap(monkeypatch, js_sc.num_users)
    js, ts = JSession(js_sc), TSession(ts_sc, device="cpu")
    assert ts.device.type == "cpu"
    assert_fleets_agree(ts.fleet, js.fleet, tap.ties, f"{name} plan")
    for k in range(steps):
        jr, tr = js.step(), ts.step()
        assert len(tr.events) == len(jr.events)
        assert tr.in_flight == jr.in_flight
        # under async both tables are one step stale, the same way
        assert_fleets_agree(ts.fleet, js.fleet, tap.ties, f"{name} step {k}")
    js.drain()
    ts.drain()
    assert not ts.policy.pending
    assert_fleets_agree(ts.fleet, js.fleet, tap.ties, f"{name} drained")
    mj, mt = js.metrics(), ts.metrics()
    for f in ("t", "handoffs", "relays", "resplits"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f), f)
    assert tap.ties.mean() <= 0.01, np.nonzero(tap.ties)[0].tolist()
    assert set(ts.timings) == set(js.timings) == {
        "plan_s", "steps_s", "drain_s", "faults_s", "serve_s", "telemetry_s"}
    assert ts.timings["serve_s"] == ts.timings["telemetry_s"] == 0.0


@pytest.mark.parametrize("name", list_scenarios())
def test_scenario_dict_round_trips_across_packages(name):
    t_sc, j_sc = t_get_scenario(name), j_get_scenario(name)
    assert t_sc.to_dict() == j_sc.to_dict()
    assert interop.scenario_from_dict(j_sc.to_dict()) == t_sc
    assert JScenario.from_dict(t_sc.to_dict()) == j_sc
    assert TScenario.from_dict(t_sc.to_dict()) == t_sc


def test_port_registers_every_preset_without_serving():
    """Every reference preset, the serving ones included since the data
    plane was ported."""
    from repro.api import list_scenarios as j_list
    assert set(list_scenarios()) == set(j_list())
    assert {n for n in list_scenarios()
            if t_get_scenario(n).serving is not None} == {
        "serve_chaos_k3", "serve_hotspot_k3"}


@pytest.mark.parametrize("case", ["faults", "candidates_k", "budget",
                                  "serving", "transformer"])
def test_refused_worlds_raise(case):
    """The worlds the port refused until admission, the fault path and
    the serving data plane were ported (faults, K > 1, a budget, a
    ServeConfig, a transformer's fleet) now build and run on the CPU."""
    base = t_get_scenario("paper_fig1")
    if case in ("faults", "candidates_k", "budget"):
        sc = {"faults": t_get_scenario("chaos_churn").replace(num_users=40),
              "candidates_k": base.replace(candidates_k=3),
              "budget": base.replace(r_capacity=100.0)}[case]
        s = TSession(sc, device="cpu")
        assert s.admission is not None and s._admission_aware
        assert s.policy.last_admission is not None
        assert (s.fault_model is not None) == (case == "faults")
        m = s.run(2)
        assert np.all(np.isfinite(s.fleet.U))
        assert (m.faults is not None) == (case == "faults")
        return
    if case == "serving":
        sc = t_get_scenario("serve_chaos_k3").replace(num_users=40,
                                                      steps=2)
        s = TSession(sc, device="cpu")
        assert s.dataplane is not None
        m = s.run()
        assert m.serving["lost"] == 0 and m.serving["submitted"] > 0
        return
    s = TSession(base.replace(model="starcoder2-3b", num_users=8),
                 device="cpu")
    assert s.profile.num_layers == 30
    s.run(1)
    assert np.all(np.isfinite(s.fleet.U))


def test_async_step_leaves_the_solve_in_flight():
    sc = t_get_scenario("megafleet_100k").replace(num_users=256, steps=2)
    s = TSession(sc, device="cpu")
    rep = s.step()
    assert len(rep.events) > 0
    assert rep.in_flight and rep.result is None and s.policy.pending
    m = s.run()
    assert not s.policy.pending
    assert list(m.relays) == [-1, -1]
    assert np.all(np.isfinite(s.fleet.U))


def test_session_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TSession(t_get_scenario("paper_fig1"))


def test_port_imports_neither_jax_nor_reference():
    """A fresh interpreter: import the port, run CPU sessions (the
    planner with and without faults, a baseline policy, both serving
    presets with their real engines and telemetry), a reduced CPU
    split generation, a chain-CNN split, a frontend stub's draw and a
    reduced CPU train step, and list every loaded module named
    jax/jax.* or repro/repro.*."""
    code = (
        "import sys\n"
        "import torch\n"
        "import repro_torch\n"
        "from repro_torch.api import Session, get_scenario\n"
        "import repro_torch.serving, repro_torch.launch.serve_split\n"
        "import repro_torch.launch.serve, repro_torch.telemetry\n"
        "import repro_torch.serving.dataplane\n"
        "import repro_torch.testing.fake_engine\n"
        "import repro_torch.models.moe, repro_torch.models.rwkv\n"
        "import repro_torch.models.rglru, repro_torch.kernels.rglru\n"
        "import repro_torch.kernels.moe_gemm, repro_torch.kernels.wkv6\n"
        "import repro_torch.kernels.ligd_step.steps, repro_torch.interop\n"
        "import repro_torch.models.chain_cnn, repro_torch.models.frontend\n"
        "from repro_torch.configs import get_config, reduced\n"
        "from repro_torch.models.transformer import init_lm\n"
        "Session(get_scenario('paper_fig1').replace(steps=2),"
        " device='cpu').run()\n"
        "Session(get_scenario('chaos_singlefail_k3').replace("
        "num_users=40, steps=2), device='cpu').run()\n"
        "Session(get_scenario('paper_fig1').replace(steps=1),"
        " policy='dnn_surgery', device='cpu').run()\n"
        "for name in ('serve_chaos_k3', 'serve_hotspot_k3'):\n"
        "    Session(get_scenario(name).replace(num_users=40, steps=2),"
        " device='cpu').run()\n"
        "cfg = reduced(get_config('starcoder2-3b'), layers=2)\n"
        "params = init_lm(cfg, torch.Generator().manual_seed(0))\n"
        "repro_torch.serving.SplitServer(cfg, params, device='cpu')"
        ".generate(torch.zeros((1, 5), dtype=torch.long), 1, 3)\n"
        "for arch in ('granite-moe-1b-a400m', 'rwkv6-3b',"
        " 'recurrentgemma-9b'):\n"
        "    cfg = reduced(get_config(arch), layers=2)\n"
        "    params = init_lm(cfg, torch.Generator().manual_seed(0))\n"
        "    repro_torch.serving.SplitServer(cfg, params, device='cpu')"
        ".generate(torch.zeros((1, 5), dtype=torch.long), 1, 3)\n"
        "from repro_torch.models import chain_cnn, frontend\n"
        "ccfg = get_config('nin')\n"
        "chain_cnn.split_inference(ccfg, chain_cnn.init_cnn(ccfg,"
        " torch.Generator().manual_seed(0), 'cpu'),"
        " torch.zeros((1, 32, 32, 3)), 4)\n"
        "frontend.audio_frame_embeds(get_config('seamless-m4t-large-v2'),"
        " torch.Generator().manual_seed(0), 1, 3, 'cpu')\n"
        "import repro_torch.optim, repro_torch.launch.train\n"
        "import repro_torch.runtime.checkpoint, repro_torch.runtime.data\n"
        "import repro_torch.runtime.compression\n"
        "import repro_torch.runtime.meshenv, repro_torch.runtime.elastic\n"
        "import repro_torch.launch.mesh\n"
        "from repro_torch.runtime import train as rt\n"
        "cfg = reduced(get_config('starcoder2-3b'), layers=2)\n"
        "params = init_lm(cfg, torch.Generator().manual_seed(0))\n"
        "batch = repro_torch.runtime.data.batch_at(cfg,"
        " repro_torch.runtime.data.DataConfig(seq_len=16, global_batch=2),"
        " 0, 'cpu')\n"
        "rt.make_train_step(cfg)(params, repro_torch.optim.init(params),"
        " batch)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro')"
        " or m.startswith(('jax.', 'repro.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
