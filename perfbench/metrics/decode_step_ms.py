"""Model step, decode: median wall milliseconds of
``InferenceEngine.step`` after admission (one ``transformer.decode_step``
for every slot, its tokens read back) in the window, before a traced
run's traced part."""
import statistics


def read(ctx):
    steps = ctx.get("decode") or []
    if ctx.get("kind") != "serve" or not steps:
        return None
    return statistics.median(w for w, _, _ in steps) * 1e3
