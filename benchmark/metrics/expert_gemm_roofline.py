"""The grouped expert kernel's share of its roofline, in %: its least time
over the traced window (each MoE layer's operations over the bf16 peak
against its bytes over the memory rate, from the routed slots and batches
the program's `moe_table` counted while the profiler recorded and the
configuration's encoder module's counts, ``encoders/deepseek_v2.py``) over the
device time of the ops launched inside the ``model/moe/experts`` ranges
(the kernel's tile table and two launches, and the combine). None where
the program has no such table or range."""
from harness import spec
from harness.roofline import PEAK_BF16_FLOPS, PEAK_BYTES


def read(run):
    t = run.trace
    if not t:
        return None
    work_ms = t["range_ms"].get("model/moe/experts", 0.0)
    if work_ms <= 0:
        return None
    try:
        from a_modular_rag_framework_torch.telemetry.stages import moe_table
    except ImportError:  # a program without the counter table
        return None
    counts = spec.load_module("encoders", "deepseek_v2")
    bound_s = 0.0
    for layer in moe_table().values():
        H, F = layer["hidden"], layer["expert_width"]
        ops = counts.expert_gemm_ops(layer["slots"], H, F)
        nbytes = counts.expert_gemm_bytes(layer["slots"], layer["batches"],
                                          layer["experts_held"], H, F)
        bound_s += max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)
    if bound_s <= 0:
        return None
    return 100.0 * 1e3 * bound_s / work_ms
