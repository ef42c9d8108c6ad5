"""A frozen copy of the profiler grouping of
``tools/torch_session_profile.py`` (``_groups``): device time of the
hand-written kernels by op, the matrix products (cuBLAS / CUTLASS) and
everything else, matched on the CUDA kernel names the profiler shows."""
from __future__ import annotations

#: op -> substrings of its CUDA kernels' names
KERNELS = {
    "flash_attention": ("flash_attention_kernel",
                        "flash_attention_tc_kernel"),
    # the bf16 body's four kernels, then the f32 body's three
    "flash_attention_bwd": ("attn_bwd_delta", "attn_bwd_dkdv_tc_kernel",
                            "attn_bwd_sum_kernel", "attn_bwd_dq_tc_kernel",
                            "attn_bwd_prep", "attn_bwd_dkdv", "attn_bwd_dq"),
    "rmsnorm": ("rmsnorm_kernel",),
    "rmsnorm_bwd": ("rmsnorm_bwd_rows_kernel", "rmsnorm_bwd_dw_kernel"),
    # the wgmma body's three kernels, then the mma.sync and CUDA-core
    # bodies' three
    "moe_swiglu_bwd": ("hopper_tc::hidden_kernel", "hopper_tc::dx_kernel",
                       "hopper_tc::dw_kernel", "bwd_hidden", "bwd_dx",
                       "bwd_dw"),
    "moe_swiglu": ("moe_swiglu", "sum_slices_kernel",
                   "hopper_tc::gate_up_kernel", "hopper_tc::down_kernel"),
    # the serial body's kernel, then the chunked body's five
    "wkv6_bwd": ("wkv6_bwd_kernel", "bwd_chunked::"),
    "wkv6": ("wkv6_kernel", "chunked::chunk_", "wkv6_chunk::chunk_"),
    "rglru_scan_bwd": ("rglru_bwd_",),
    "rglru_scan": ("rglru_scan_kernel",),
    "sweep": ("sweep_kernel",),
}

MATMUL_MARKS = ("gemm", "xmma", "cutlass", "cublas", "gemv", "nvjet")


def group_of(name: str) -> str:
    """The group of one CUDA kernel name: the first op whose substrings
    it contains, else ``matmul`` for a library product, else
    ``other``."""
    for op, subs in KERNELS.items():
        if any(t in name for t in subs):
            return op
    if any(t in name.lower() for t in MATMUL_MARKS):
        return "matmul"
    return "other"


def groups(device_s: dict) -> dict:
    """Device time by group from device time by kernel name."""
    out = dict.fromkeys(tuple(KERNELS) + ("matmul", "other"), 0.0)
    for name, t in device_s.items():
        out[group_of(name)] += t
    return out
