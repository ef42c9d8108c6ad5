"""Model step, training: median wall milliseconds of one
``runtime.train.loss_and_grads`` call (forward, loss and backward, each
block recomputed under remat), from a host span that ends in a
synchronise, in the steps before a traced run's traced part."""
import statistics


def read(ctx):
    spans = (ctx.get("spans") or {}).get("fwd_bwd") or []
    if ctx.get("kind") != "train" or not spans:
        return None
    return statistics.median(spans) * 1e3
