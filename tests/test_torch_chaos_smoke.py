"""``tools/torch_chaos_smoke.py``, the port's twin of
``tools/chaos_smoke.py``, prints on the CPU byte for byte what the
reference prints, on both of its chaos presets: every step's
availability, handoff, evacuation and degrade counts, and the
``CHAOS_SMOKE_OK`` summary of the fault metrics."""
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_diff import script_stdout                             # noqa: E402

TOOLS = Path(__file__).resolve().parents[1] / "tools"


@pytest.mark.parametrize("scenario", ["chaos_singlefail_k3", "chaos_churn"])
def test_chaos_smoke_twin_prints_what_the_reference_prints(scenario):
    argv = ["--scenario", scenario]
    ref = script_stdout(TOOLS / "chaos_smoke.py", argv)
    port = script_stdout(TOOLS / "torch_chaos_smoke.py",
                         argv + ["--device", "cpu"])
    assert ref.splitlines()[-1].startswith("CHAOS_SMOKE_OK")
    assert port == ref
