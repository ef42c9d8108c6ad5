"""Kernels, row 5 (``kernels.moe_gemm``, the experts' fused SwiGLU, forward
and backward) in the traced part of the training window: the sum over
its calls of each call's least time (by the frozen arithmetic, over the
(E, C, d) buffer of capacity C) over the device time of its kernels, in
percent. A step calls the forward twice a layer under remat (the block
and its recompute) and the backward once; the counts are checked against
the program's counters."""
import sys

from harness import frozen

KERNELS = ("moe_swiglu", "sum_slices_kernel", "hopper_tc::gate_up_kernel",
           "hopper_tc::down_kernel", "hopper_tc::hidden_kernel",
           "hopper_tc::dx_kernel", "hopper_tc::dw_kernel", "bwd_hidden",
           "bwd_dx", "bwd_dw")


def read(ctx):
    t = ctx.get("trace")
    m = ctx["model"]
    E = m.get("num_experts", 0)
    if (ctx.get("kind") != "train" or not t or not E
            or not ctx["traced_steps"]):
        return None
    L, steps = m["num_layers"], ctx["traced_steps"]
    fwd = (2 if ctx["remat"] else 1) * L * steps
    bwd = L * steps
    got = (ctx["launches"].get("moe_swiglu", 0),
           ctx["launches"].get("moe_swiglu_bwd", 0))
    if got != (fwd, bwd):
        print(f"moe_roofline.train: {got} calls, {(fwd, bwd)} counted; "
              "not reported", file=sys.stderr)
        return None
    es = 2 if m.get("dtype", "bfloat16") in ("bfloat16", "float16") else 4
    C = frozen.moe_capacity(ctx["batch"] * ctx["seq"], E,
                            m["experts_per_token"], ctx["capacity_factor"])
    d, ff = m["d_model"], m["d_ff"]
    num = (fwd * frozen.bound_s(*frozen.moe_fwd_cost(E, C, d, ff, es))
           + bwd * frozen.bound_s(*frozen.moe_bwd_cost(E, C, d, ff, es)))
    den = sum(s for n, s in t["device_s"].items()
              if any(k in n for k in KERNELS))
    return 100.0 * num / den if den > 0 else None
