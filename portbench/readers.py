"""What the per-layer metrics' readers (``metrics/<name>.py``) share: the
program's kernels by name, rooflines and model utilisation from
``counts``, and device time by ``record_function`` range.

A reader returns None where it finds nothing to read: no kernel of its
name in the trace, a device whose peaks ``peaks.json`` does not hold,
or ranges that do not pair up with the steps.
"""
from __future__ import annotations

import bisect
import re

from portbench import counts

#: Kernel B4 (``kernels/flash_attention``): its forward forms and its
#: backward forms, by the namespaces of their CUDA sources.
B4_FWD = re.compile(r"\bflash_(?:tc|tc_f32|simt|split)::")
B4_BWD = re.compile(r"\bflash_bwd_(?:simt|tc|tf32)::")
#: Kernel B5 (``kernels/ssd_scan``): the forward's two passes, and the
#: backward's kernels.
B5_FWD = re.compile(r"\b(?:cb_kernel|ssd_scan_kernel)\b")
B5_BWD = re.compile(r"\bssd_bwd::")
#: The MoE layer's grouped expert GEMMs (``kernels/moe``): gate/up with
#: the SwiGLU epilogue (``<0>``) and down (``<1>``).
MOE_GEMM = re.compile(r"\bgrouped_gemm_kernel\b")

#: Each kernel's calls (``counts/<family>.py``), operations and bytes.
KERNELS = {
    "attention": ("attention_calls", counts.attention_flops,
                  counts.attention_bytes),
    "scan": ("scan_calls", counts.scan_flops, counts.scan_bytes),
    "expert": ("expert_calls", counts.expert_flops, counts.expert_bytes),
}


def roofline(ctx, pattern, kernel: str, backward: bool):
    """Percent of the least time of every call of ``kernel`` (a key of
    :data:`KERNELS`) in the window, forward or backward, over the device
    time of the kernels ``pattern`` names."""
    calls_of, fl, by = KERNELS[kernel]
    get = getattr(counts.family(ctx.cell.config), calls_of)
    calls = [c for rows, seq in ctx.work
             for c in get(ctx.cell.config["sizes"], rows, seq)]
    dev = ctx.trace.device_s(lambda n: bool(pattern.search(n)))
    if not dev or not calls or ctx.peak is None:
        return None
    elem = counts.ELEMENT_BYTES[ctx.cell.config["sizes"]["dtype"]]
    least = max(sum(fl(c, backward) for c in calls)
                / ctx.peak["bfloat16_flops"],
                sum(by(c, elem, backward) for c in calls)
                / ctx.peak["bytes_per_s"])
    return 100.0 * least / dev


def mfu(ctx, train: bool):
    """Percent of the device's bf16 peak that the window's model
    operations (``counts.step_flops``) are of the traced window."""
    if ctx.peak is None or not ctx.work:
        return None
    ops = sum(counts.step_flops(ctx.cell.config, rows, seq, train)
              for rows, seq in ctx.work)
    return 100.0 * ops / (ctx.peak["bfloat16_flops"] * ctx.trace.window_s)


def range_ms(ctx, part: str):
    """Device milliseconds a training step spends in ``part``:
    ``"optimizer"``, the kernels inside the device-side span of the
    step's ``train_step.optimizer`` range; ``"backward"``, those that
    start after its forward range's span ends and before its optimizer
    range's span starts (the autograd engine launches them from its own
    thread, outside any range).  The mean over the window's steps."""
    fwd = ctx.trace.spans.get("train_step.forward", [])
    opt = ctx.trace.spans.get("train_step.optimizer", [])
    steps = len(ctx.work)
    if not steps or len(fwd) != steps or len(opt) != steps:
        return None
    kern = sorted((s, e) for _, s, e in ctx.trace.kernels)
    starts = [s for s, _ in kern]
    total = 0
    for (_, f1), (o0, o1) in zip(fwd, opt):
        lo, hi = (f1, o0) if part == "backward" else (o0, o1)
        i, j = bisect.bisect_left(starts, lo), bisect.bisect_left(starts, hi)
        total += sum(e - s for s, e in kern[i:j])
    return total / steps / 1e6


def idle_share(ctx):
    """Percent of the traced window in which no device operation ran."""
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def peak_gib(ctx):
    """The window's peak of allocated device memory, GiB."""
    return ctx.window_peak_bytes / 2 ** 30 if ctx.window_peak_bytes else None
