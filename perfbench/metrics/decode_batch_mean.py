"""Serving engine: mean number of slots running a request in a decode
step of the window (``InferenceEngine.step``), before a traced run's
traced part."""


def read(ctx):
    steps = ctx.get("decode") or []
    if ctx.get("kind") != "serve" or not steps:
        return None
    return sum(n for _, n, _ in steps) / len(steps)
