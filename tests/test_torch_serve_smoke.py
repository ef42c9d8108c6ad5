"""``tools/torch_serve_smoke.py``, the port's twin of
``tools/serve_smoke.py``, prints on the CPU byte for byte what the
reference prints: the failover smoke on ``serve_chaos_k3`` (every step's
stream counts and the ``SERVE_SMOKE_OK`` summary: zero lost, the
failovers by mode, the relay time) and the feedback smoke on
``serve_hotspot_k3`` (``--adaptive``: open against closed loop)."""
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_diff import script_stdout                             # noqa: E402

TOOLS = Path(__file__).resolve().parents[1] / "tools"


@pytest.mark.parametrize("argv, last", [
    ([], "SERVE_SMOKE_OK"),
    (["--adaptive"], "ADAPTIVE_SMOKE_OK"),
])
def test_serve_smoke_twin_prints_what_the_reference_prints(argv, last):
    ref = script_stdout(TOOLS / "serve_smoke.py", argv)
    port = script_stdout(TOOLS / "torch_serve_smoke.py",
                         argv + ["--device", "cpu"])
    assert ref.splitlines()[-1].startswith(last)
    assert port == ref
