"""Find a cell's parts by name: the manifest ``BENCHMARK.json`` at the
root of the checkout, a configuration's file, a traffic mix
(``traffic/<name>.json``), a cell's correctness limits
(``limits/<workload>.json``), a traffic kind's driver
(``drivers/<kind>.py``) and a per-layer metric's reader
(``metrics/<name>.py``).  Adding a cell, a configuration, a mix or a
metric adds files and entries; nothing here names one."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(name: str) -> dict:
    return _named(manifest()["workloads"], name, "workload")


def config(name: str) -> dict:
    """The configuration's file, as it is run (``program`` holds the
    program's model fields)."""
    entry = _named(manifest()["configs"], name, "configuration")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(workload_name: str) -> dict:
    return json.loads((BENCH / "limits" / f"{workload_name}.json")
                      .read_text())


def driver(kind: str):
    """The driver module of a traffic kind: ``harness/drivers/<kind>.py``
    (``run(...)`` and ``readings(...)``)."""
    return importlib.import_module(f"harness.drivers.{kind}")


def _applies(entry: dict, workload_name: str) -> bool:
    return "workloads" not in entry or workload_name in entry["workloads"]


def cell_metrics(workload_name: str) -> tuple:
    """(end-to-end entries, per-layer entries) that this cell reports."""
    m = manifest()
    return ([e for e in m["end_to_end"] if _applies(e, workload_name)],
            [e for e in m["per_layer"] if _applies(e, workload_name)])


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``metrics/<metric_name>.py``."""
    path = BENCH / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
