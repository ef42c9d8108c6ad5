"""Plain float32 PyTorch reference of the benchmark's configurations.

It imports nothing of the program under test: each cell's output is
judged against it (``harness.check``)."""


def family(m: dict):
    """The module that holds a configuration's family: ``model`` for the
    decoder families it states (``dense``, ``moe``), else
    ``reference/<family>.py``; each gives ``Ref`` and the program's
    weight ``layout``."""
    import importlib
    name = m.get("family", "dense")
    return importlib.import_module(
        "reference.model" if name in ("dense", "moe") else f"reference.{name}")
