"""``examples/torch_quickstart.py``, the port's twin of
``examples/quickstart.py``, prints on the CPU byte for byte what the
reference prints: the Li-GD plan of each user, the five baselines and
MCSA on the identical world, and the first MLi-GD handoff decisions.
And, in a fresh interpreter, importing the five twins of the tools and
examples loads neither JAX nor ``repro``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_diff import script_stdout                             # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("tools/torch_chaos_smoke.py", "tools/torch_serve_smoke.py",
         "tools/torch_policy_matrix.py", "examples/torch_quickstart.py",
         "examples/torch_mobility_sim.py")


def test_quickstart_twin_prints_what_the_reference_prints():
    ref = script_stdout(ROOT / "examples" / "quickstart.py", [])
    port = script_stdout(ROOT / "examples" / "torch_quickstart.py",
                         ["--device", "cpu"])
    assert ref.splitlines()[-1] == "done."
    assert port == ref


def test_twins_import_neither_jax_nor_reference():
    """Each twin imported as a module (its ``main`` not run), then every
    loaded module named jax/jax.* or repro/repro.* listed."""
    code = (
        "import importlib.util, sys\n"
        f"for rel in {TWINS!r}:\n"
        "    spec = importlib.util.spec_from_file_location("
        "'twin_' + rel.split('/')[-1][:-3], rel)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro')"
        " or m.startswith(('jax.', 'repro.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
