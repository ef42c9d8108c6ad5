"""``examples/torch_mobility_sim.py``, the port's twin of
``examples/mobility_sim.py``, prints on the CPU byte for byte what the
reference prints at 50 users over 8 minutes: the fleet, every minute's
handoffs with their re-split or relay-back decisions, and the fleet's
mean latency."""
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_diff import script_stdout                             # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def test_mobility_sim_twin_prints_what_the_reference_prints():
    argv = ["--minutes", "8", "--users", "50"]
    ref = script_stdout(EXAMPLES / "mobility_sim.py", argv)
    port = script_stdout(EXAMPLES / "torch_mobility_sim.py",
                         argv + ["--device", "cpu"])
    assert ref.splitlines()[-1].startswith("fleet mean latency:")
    assert port == ref
