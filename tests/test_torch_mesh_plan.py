"""The sharded static plan (``MCSAPlanner.plan_static(env=...)``) on a
data-2 mesh against the JAX package's ``shard_map`` plan.

The reference runs in a subprocess with two forced host devices (the
suite itself keeps seeing one, as ``tests/test_fleet_planner.py`` does);
the port runs in a spawned two-rank gloo world (``torch_mesh_ranks``).
Both plan 64 NiN users on ``build_topology(16, 4, seed=0)``, once with
K = 1 (64 rows, 32 a rank) and once with K = 3 (192 rows, 96 a rank).
Discrete columns must be equal outside named near-ties and continuous
ones within ``torch_diff.RTOL`` (the solver tolerances of every planner
test); each rank ends with the whole result, and the sharded plan equals
the port's unsharded one bit for bit (the sweep has no cross-user
reduction)."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_diff import (assert_discrete, assert_fleets_agree,    # noqa: E402
                        assert_rel, near_ties)
from torch_mesh_ranks import run_world                            # noqa: E402

from repro_torch import interop                                  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
X = 64
CASES = (1, 3)

_REFERENCE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
from repro.configs.chain_cnns import nin
from repro.core.costs import DeviceFleet
from repro.core.network import build_topology
from repro.core.planner import PLAN_FIELDS, MCSAPlanner
from repro.core.profile import profile_of
from repro.runtime.meshenv import make_env

assert jax.device_count() == 2
env = make_env(jax.make_mesh((2,), ("data",)))
out = {}
for K in (1, 3):
    topo = build_topology(16, 4, seed=0)
    rng = np.random.default_rng(7)
    devices = DeviceFleet(c_dev=rng.uniform(3e9, 8e9, %(X)d))
    aps = np.arange(%(X)d) %% topo.num_aps
    res, servers, fleet = MCSAPlanner(profile_of(nin()), topo,
                                      candidates_k=K).plan_static(
        devices, aps, env=env)
    out[K] = {"res": {f: np.asarray(getattr(res, f)) for f in res._fields},
              "fleet": {f: np.asarray(getattr(fleet, f))
                        for f in PLAN_FIELDS}}
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
""" % {"X": X}


def _port_plans(rank: int, env_kind: str) -> dict:
    """Both plans on this rank: with the data-2 env, or unsharded."""
    from repro_torch.configs.chain_cnns import nin
    from repro_torch.core.costs import DeviceFleet
    from repro_torch.core.network import build_topology
    from repro_torch.core.planner import MCSAPlanner
    from repro_torch.core.profile import profile_of
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.meshenv import make_env
    env = make_env(make_mesh((2,), ("data",))) if env_kind == "mesh" else None
    out = {}
    for K in CASES:
        topo = build_topology(16, 4, seed=0)
        rng = np.random.default_rng(7)
        devices = DeviceFleet(c_dev=rng.uniform(3e9, 8e9, X))
        aps = np.arange(X) % topo.num_aps
        planner = MCSAPlanner(profile_of(nin()), topo, candidates_k=K,
                              device="cpu")
        res, servers, fleet = planner.plan_static(devices, aps, env=env)
        out[K] = {"res": {f: np.array(torch.as_tensor(getattr(res, f)))
                          for f in res._fields},
                  "fleet": fleet}
    return out


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_plan")
    path = tmp / "reference.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(path, "rb") as f:
        ref = pickle.load(f)
    ranks = run_world(_port_plans, 2, tmp / "world", "mesh")
    return ref, ranks, _port_plans(0, "none")


@pytest.mark.parametrize("K", CASES)
def test_sharded_plan_matches_the_reference_shard_map_plan(plans, K):
    ref, ranks, _ = plans
    want = ref[K]
    ties = near_ties(want["res"]["U_per_layer"])
    for rank, out in enumerate(ranks):
        got = out[K]
        for f in ("split", "iters_per_layer"):
            assert got["res"][f].shape == want["res"][f].shape, (rank, f)
        assert_discrete(got["res"]["split"], want["res"]["split"], ties,
                        f"rank {rank} K {K} split")
        for f in ("B", "r", "U", "T", "E", "C"):
            assert_rel(got["res"][f], want["res"][f],
                       f"rank {rank} K {K} {f}", rows=~ties)
        fleet_ref = interop.fleet_from_columns(want["fleet"])
        assert_fleets_agree(got["fleet"], fleet_ref, ties,
                            f"rank {rank} K {K}")


@pytest.mark.parametrize("K", CASES)
def test_sharded_plan_equals_the_unsharded_plan_bit_for_bit(plans, K):
    _, ranks, unsharded = plans
    for out in ranks:
        for f, a in unsharded[K]["res"].items():
            np.testing.assert_array_equal(out[K]["res"][f], a, err_msg=f)
