"""Kernels, row 3 backward (``kernels.flash_attention``) in the traced
part of the training window: the sum over its calls of each call's least time (the larger of
its operations at the peak rate and its bytes at the HBM rate, by the
frozen arithmetic) over the device time of its kernels, in percent.
Every step calls it once a layer at (B, S, Hq, hd), under the layer's
window; the call count is checked against the program's counter."""
import sys

from harness import frozen
from reference.model import layer_windows

KERNELS = ("attn_bwd_delta", "attn_bwd_dkdv_tc_kernel",
           "attn_bwd_sum_kernel", "attn_bwd_dq_tc_kernel", "attn_bwd_prep",
           "attn_bwd_dkdv", "attn_bwd_dq")
COUNTER = "flash_attention_bwd"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "train" or not t or not ctx["traced_steps"]:
        return None
    m = ctx["model"]
    L = m["num_layers"]
    calls = L * ctx["traced_steps"]
    if ctx["launches"].get(COUNTER, 0) != calls:
        print(f"attn_bwd_roofline.train: {ctx['launches'].get(COUNTER)} "
              f"calls, {calls} counted; not reported", file=sys.stderr)
        return None
    es = 2 if m.get("dtype", "bfloat16") in ("bfloat16", "float16") else 4
    num = ctx["traced_steps"] * sum(
        frozen.bound_s(*frozen.attention_bwd_cost(
            ctx["batch"], ctx["seq"], ctx["seq"], m["num_heads"],
            m["num_kv_heads"], m["head_dim"], es, window=W, bf16=es == 2))
        for W in layer_windows(m))
    den = sum(s for n, s in t["device_s"].items()
              if any(k in n for k in KERNELS))
    return 100.0 * num / den if den > 0 else None
