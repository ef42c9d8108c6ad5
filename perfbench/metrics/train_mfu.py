"""The whole training step, before a traced run's traced part: model
flops of the steps there over its seconds at the bf16 peak, in percent.
A step counts 6·(body + head) a token, the routed experts only (8 of 32
in an MoE), and attention's forward and backward, 3 · 4·Hq·hd a (query,
key) pair under each layer's causal mask and window; remat's recompute
is not counted."""
from harness import frozen


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    m, B, S = ctx["model"], ctx["batch"], ctx["seq"]
    step = (frozen.model_flops(m, "train", B, S)
            + 3.0 * frozen.attention_flops(
                m, lambda W: B * frozen.attention_pairs(S, S, True, W)))
    return 100.0 * ctx["steps"] * step / (ctx["window_s"]
                                          * frozen.PEAK_FLOPS)
