"""Kernels, row 3 forward (``kernels.flash_attention``) in the traced
part of the serving window: the sum over its launches of each launch's least time (the
larger of its operations at the peak rate and its bytes at the HBM
rate, by the frozen arithmetic) over the device time of its kernels, in
percent.  Every prefill launches it once a layer at (1, S, Hq, hd),
under the layer's window; the launch count is checked against the
program's counter."""
import sys

from harness import frozen
from reference.model import layer_windows

KERNELS = ("flash_attention_kernel", "flash_attention_tc_kernel")
COUNTER = "flash_attention"


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("kind") != "serve" or not t:
        return None
    m = ctx["model"]
    L, Hq, Hkv, hd = (m["num_layers"], m["num_heads"], m["num_kv_heads"],
                      m["head_dim"])
    es = 2 if m.get("dtype", "bfloat16") in ("bfloat16", "float16") else 4
    lens = [S for ls in ctx["traced_admit"] for S in ls]
    if not lens:
        return None
    if ctx["launches"].get(COUNTER, 0) != L * len(lens):
        print(f"attn_fwd_roofline.serve: {ctx['launches'].get(COUNTER)} "
              f"launches, {L * len(lens)} counted; not reported",
              file=sys.stderr)
        return None
    num = sum(frozen.bound_s(*frozen.attention_fwd_cost(
        1, S, S, Hq, Hkv, hd, es, window=W, bf16=es == 2))
        for S in lens for W in layer_windows(m))
    den = sum(s for n, s in t["device_s"].items()
              if any(k in n for k in KERNELS))
    return 100.0 * num / den if den > 0 else None
