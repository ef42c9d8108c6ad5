"""What a run loads: ``run.py``'s import graph and a small CPU rehearsal
of every cell's traffic, in a fresh interpreter, load neither JAX nor
the JAX package ``repro`` (top-level module names compared whole: the
program's ``repro_torch`` is not ``repro``); the reference alone loads
nothing of the program either."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
PATHS = [str(BENCH.parent / "src"), str(BENCH), str(BENCH / "tests")]

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

REHEARSAL = """
import json, sys, time
sys.path[:0] = {paths!r}
import torch
import run, tiny
from harness import manifest
for wl in [w["name"] for w in manifest.manifest()["workloads"]]:
    cfg, mix = tiny.cell_parts(wl)
    for tr in (False, True):
        r = run.execute(wl, 2**31 + 11, 1.0, tr, torch.device("cpu"),
                        time.perf_counter(), cfg=cfg, mix=mix)
        assert r["correct"], (wl, r)
        assert r["metrics"], (wl, r)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

REFERENCE_ONLY = """
import json, sys
sys.path[:0] = {paths!r}[1:]
import torch
from reference.model import Ref, strict_fp32
from reference.adamw import AdamW
import tiny
ref = Ref(tiny.DENSE)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""


def _tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(paths=PATHS)],
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_not_the_jax_package():
    tops = _tops(REHEARSAL)
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops(REFERENCE_ONLY)
    assert not tops & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "repro",
                                  "repro.models"])
def test_forbidden_names_are_found(name, monkeypatch):
    from harness import common
    monkeypatch.setitem(sys.modules, name, object())
    assert name.split(".")[0] in common.forbidden_modules()


def test_repro_torch_is_not_repro(monkeypatch):
    from harness import common
    for name in [n for n in sys.modules if n.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch.x", object())
    assert common.forbidden_modules() == []
