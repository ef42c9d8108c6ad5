"""The whole serving window, before a traced run's traced part: model
flops of the tokens served there over its seconds at the bf16 peak, in
percent. A prefill counts 2·body a prompt token, the head at its last
position and attention's 4·Hq·hd a (query, key) pair under each layer's
causal mask and window; a decode step counts, for each slot running a
request, 2·(body + head) and attention over the keys it sees in each
layer (its pos + 1, at most the layer's window). Slots that run no
request count nothing."""
import numpy as np

from harness import frozen


def read(ctx):
    if ctx.get("kind") != "serve" or not ctx.get("decode"):
        return None
    m = ctx["model"]
    flops = 0.0
    for _, lens in ctx["admit"]:
        for S in lens:
            flops += frozen.model_flops(m, "prefill", 1, S)
            flops += frozen.attention_flops(
                m, lambda W: frozen.attention_pairs(S, S, True, W))
    for _, n, pos in ctx["decode"]:
        keys = np.asarray(pos, dtype=np.int64) + 1
        flops += n * frozen.model_flops(m, "decode", 1, 1)
        flops += frozen.attention_flops(
            m, lambda W: int(np.minimum(keys, W).sum() if W else keys.sum()))
    return 100.0 * flops / (ctx["window_s"] * frozen.PEAK_FLOPS)
