"""Optimizer: median wall milliseconds of one ``optim.adamw.update``
call (clip, moments and the in-place update of every leaf), from a host
span that ends in a synchronise, in the steps before a traced run's
traced part."""
import statistics


def read(ctx):
    spans = (ctx.get("spans") or {}).get("adamw") or []
    if ctx.get("kind") != "train" or not spans:
        return None
    return statistics.median(spans) * 1e3
