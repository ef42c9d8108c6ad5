"""The MoE family on a mesh against the JAX package's own mesh path, and
``launch.train --mesh host`` training it.

Reduced granite-moe-1b-a400m (4 experts, top 2), float32, one train
step (``torch_mesh_family_cases``):

* data 2 x model 1: the reference routes the global batch under GSPMD,
  so capacity comes from the global token count, an assignment's rank
  within its expert counts the earlier data rank's assignments, and the
  aux loss's means are global; each rank gathers the per-expert counts
  and sums the gate columns (no tokens gathered);
* data 2 x model 2: expert parallelism (2 experts a rank), capacity and
  aux per data shard, the partial outputs summed over the model axis.

The router is scaled so that the reference drops assignments under
both rules (asserted).  Beside the loss, aux, grad_norm and updated
parameters, every gradient leaf is held against the reference's
``jax.grad`` of its mesh loss: the router's catches an aux gradient
summed over the model axis (it must be taken once) or left at 1/dp of
the reference's on the data mesh.

The launcher: ``--mesh host --arch granite-moe-1b-a400m`` under
``torch.distributed.run`` (2 CPU ranks, a data mesh), preempted after 2
of 4 steps and resumed on one process, against an unbroken run.
"""
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_mesh_family_cases import (ROOT, assert_grads,        # noqa: E402
                                     assert_metrics, assert_updates,
                                     run_cases)

MOE = dict(layers=2, d_model=32, heads=2, kv_heads=2, d_ff=32, vocab=300)
CASES = (("moe_data2", "granite-moe-1b-a400m", MOE, (2, 1),
          ("grads", "drops")),
         ("moe_data2_model2", "granite-moe-1b-a400m", MOE, (2, 2),
          ("grads", "drops")))
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("mesh_moe"))


@pytest.mark.parametrize("case", CASES, ids=IDS)
@pytest.mark.parametrize("metric", ["loss", "aux", "total", "grad_norm"])
def test_moe_mesh_step_metrics_match_the_reference(worlds, case, metric):
    assert_metrics(*worlds, case, metric)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_moe_mesh_step_updates_match_the_reference(worlds, case):
    assert_updates(*worlds, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_moe_mesh_gradients_match_the_reference(worlds, case):
    assert_grads(*worlds, case)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_reference_drops_assignments_under_both_rules(worlds, case):
    ref, _ = worlds
    assert ref[case[0]]["drops"] > 0


def test_the_two_capacity_rules_differ(worlds):
    """The same weights and batch give another aux on a data mesh (one
    global value) than with tp > 1 (the mean of the shards')."""
    ref, ranks = worlds
    assert ref["moe_data2"]["aux"] != ref["moe_data2_model2"]["aux"]
    assert ranks[0]["moe_data2"]["aux"] != ranks[0]["moe_data2_model2"]["aux"]


def _run(args, cwd) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    return proc.stdout


def _losses(out: str) -> dict:
    return {int(s): float(v) for s, v in
            re.findall(r"step\s+(\d+) loss ([0-9.]+)", out)}


def test_launcher_trains_moe_on_a_host_mesh_and_resumes_on_one_process(
        tmp_path):
    """``--mesh host --arch granite-moe-1b-a400m`` under
    ``torch.distributed.run`` (2 CPU ranks) trains 2 of 4 steps and
    checkpoints logical tensors; one process resumes at step 2.  The
    losses of both runs agree with an unbroken one-process run within
    1e-3 (the bf16 smoke config: each rank's half of the batch is
    rounded apart from the whole batch's)."""
    from repro_torch.launch import train as t_launch
    args = ["--device", "cpu", "--arch", "granite-moe-1b-a400m", "--size",
            "smoke", "--steps", "4", "--seq", "16", "--batch", "2"]
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2",
          "--resume"]
    first = _run(["-m", "torch.distributed.run", "--standalone",
                  "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
                  "--mesh", "host", *args, *ck, "--stop-after", "2"],
                 tmp_path)
    assert first.count("[preempt] stopping after 2 steps") == 1, first
    assert sorted(_losses(first)) == [0, 1]
    second = _run(["-m", "repro_torch.launch.train", *args, *ck], tmp_path)
    assert "[resume] restored step 2, data cursor 2" in second
    straight = t_launch.run(t_launch.parse_args(args))["losses"]
    resumed = {**_losses(first), **_losses(second)}
    assert sorted(resumed) == [0, 1, 2, 3]
    for s, v in straight.items():
        assert resumed[s] == pytest.approx(v, rel=1e-3), s
