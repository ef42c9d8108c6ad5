"""``tools/torch_policy_matrix.py``, the port's twin of
``tools/policy_matrix.py``, prints on the CPU byte for byte what the
reference prints at its CI smoke scale (64 users, 4 steps): every policy
on every preset, the mean-delay table and ``POLICY_MATRIX_OK``, with the
matrix's invariants asserted by both (finite delays, nobody stranded
under chaos, MCSA never worse than the whole baseline field)."""
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_diff import script_stdout                             # noqa: E402

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def test_policy_matrix_twin_prints_what_the_reference_prints():
    argv = ["--max-users", "64", "--steps", "4"]
    ref = script_stdout(TOOLS / "policy_matrix.py", argv)
    port = script_stdout(TOOLS / "torch_policy_matrix.py",
                         argv + ["--device", "cpu"])
    assert ref.splitlines()[-1] == "POLICY_MATRIX_OK (10 scenarios x 6 " \
        "policies)"
    assert port == ref
