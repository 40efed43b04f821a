"""Time one checkout's B4 and B5 kernels at zamba2-1.2b's train shape on
the card, for comparing two checkouts in one call (parent, change,
change, parent: each in a process of its own, since both name their
package ``repro_torch``).

    python3 tools/bwd_timing.py CHECKOUT [--label NAME] [--f32]

Prints one ``[bwd_timing]`` JSON line: the backward kernels' ``ms`` (20
calls one by one), ``graph_ms`` (replayed from a CUDA graph) and
``split_ms`` (device ms a call by kernel), and the serving forwards'
``ms`` / ``graph_ms`` (B4's tensor-core form, B5 with bf16 b and c),
with the card's name and power limit.  The timing helpers are this
repository's ``chip_smoke.py``; the kernels are CHECKOUT's.  A backward
that reads the forward's log-sum-exp gets it from CHECKOUT's forward,
outside the timed calls.

With ``--f32`` it also prints one ``[f32_timing]`` line: B4 in f32, on
whichever form CHECKOUT's wrapper picks (``form``), at the ``[flash]``
phase's three f32 forward shapes and at the train shape's backward, each
beside its plain version, the same function by SDPA in f32, and both
bounds: f32 on the CUDA cores (``bound_ms``) and as 3xTF32 on the
tensor cores (``bound_tc_ms``).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkout", type=Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--f32", action="store_true",
                    help="also time B4's f32 forms")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_timing: no CUDA device available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke_timing",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(args.checkout.resolve() / "src"))
    importlib.import_module("repro_torch.kernels.build").build_all()
    fam = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    scm = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    rec = {"checkout": args.label or str(args.checkout),
           "card": cs.nvidia_smi()}

    rand = cs.cuda_rand(60)
    q, k, v = (rand(b, s, 32, 64, dtype=torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    go = rand(b, 32, s, 64, dtype=torch.bfloat16)
    full = dict(causal=True, scale=None, q_offset=0, kv_len=None,
                window=None)
    kept = {}
    if hasattr(fam, "keeps_lse") and fam.keeps_lse(q, k, v):
        out, lse, out_lo = fam._forward(q, k, v, *full.values(),
                                        for_grad=True)
        kept = dict(out=out, lse=lse, out_lo=out_lo)

    def b4_bwd():
        return fam._backward(q, k, v, go, **full, **kept)

    def b4_fwd():
        return fam._forward(q, k, v, *full.values())

    rec["b4_bwd"] = dict(ms=cs.cuda_ms(b4_bwd), graph_ms=cs.graph_ms(b4_bwd),
                         split_ms=cs.launch_split(b4_bwd))
    rec["b4_fwd"] = dict(ms=cs.cuda_ms(b4_fwd), graph_ms=cs.graph_ms(b4_fwd))
    lib_ms, lib_graph_ms = cs.sdpa_backward_ms(q, k, v, go)
    rec["sdpa_bwd"] = dict(ms=lib_ms, graph_ms=lib_graph_ms)
    del q, k, v, go, kept

    rand = cs.cuda_rand(80)
    x = rand(b, s, 64, 64)
    la = -torch.nn.functional.softplus(rand(b, s, 64))
    bb = (rand(b, s, 64) * 0.3).to(torch.bfloat16)
    cc = (rand(b, s, 64) * 0.3).to(torch.bfloat16)
    gy = rand(b, s, 64, 64)

    def b5_bwd():
        return scm._backward(x, la, bb, cc, None, gy, None)

    def b5_fwd():
        return scm._forward(x, la, bb, cc, None)

    rec["b5_bwd"] = dict(ms=cs.cuda_ms(b5_bwd), graph_ms=cs.graph_ms(b5_bwd),
                         split_ms=cs.launch_split(b5_bwd))
    rec["b5_fwd"] = dict(ms=cs.cuda_ms(b5_fwd), graph_ms=cs.graph_ms(b5_fwd))
    cs.line("bwd_timing", **rec)
    if args.f32:
        cs.line("f32_timing", checkout=rec["checkout"], card=rec["card"],
                **f32_timing(cs, fam))
    return 0


def backward_form(fam, q, k, v, go) -> str:
    """CHECKOUT's backward form: its ``backward_form`` also took the
    output's gradient until the tensor-core f32 form."""
    takes_grad = len(inspect.signature(fam.backward_form).parameters) > 3
    return fam.backward_form(q, k, v, *([go] if takes_grad else []))


def f32_timing(cs, fam) -> dict:
    """B4's f32 forms at the ``[flash]`` f32 shapes (forward) and the
    train shape (backward); see the module docstring."""
    f32 = torch.float32
    b, s = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    out = {}
    for tag, bb, h, hkv, sq, d, win in (
            ("zamba2_prefill_f32", b, 32, 32, s, 64, None),
            ("simt_f32_d96", 2, 32, 32, 1024, 96, None),
            ("window_f32_mid_tile", 2, 32, 8, s, 128, 1000)):
        rand = cs.cuda_rand(10)
        q = rand(bb, sq, h, d, dtype=f32).transpose(1, 2)
        k = rand(bb, sq, hkv, d, dtype=f32).transpose(1, 2)
        v = rand(bb, sq, hkv, d, dtype=f32).transpose(1, 2)
        kw = dict(causal=True, q_offset=0, kv_len=sq, window=win)
        nbytes, ops = cs.flash_work(q, k, True, 0, sq, win)

        def kernel():
            return fam.flash_attention(q, k, v, **kw)

        out[tag] = dict(
            form=fam.kernel_form(q, k, v), shape=[bb, h, hkv, sq, sq, d],
            window=win, ms=cs.cuda_ms(kernel), graph_ms=cs.graph_ms(kernel),
            plain_ms=cs.cuda_ms(lambda: fam.flash_attention_plain(q, k, v,
                                                                  **kw),
                                reps=3, warmup=1),
            library_ms=cs.cuda_ms(lambda: cs.sdpa_library(q, k, v, True, 0,
                                                          sq, win)),
            library_graph_ms=cs.graph_ms(lambda: cs.sdpa_library(
                q, k, v, True, 0, sq, win)),
            bound_ms=cs.bound_ms(nbytes, ops, cs.PEAK_FP32_S)[0],
            bound_tc_ms=3 * ops / cs.PEAK_TF32_S * 1e3)
        del q, k, v
        torch.cuda.empty_cache()

    rand = cs.cuda_rand(61)
    q, k, v = (rand(b, s, 32, 64, dtype=f32).transpose(1, 2)
               for _ in range(3))
    go = rand(b, 32, s, 64, dtype=f32)
    full = dict(causal=True, scale=None, q_offset=0, kv_len=None,
                window=None)
    kept = {}
    if hasattr(fam, "keeps_lse") and fam.keeps_lse(q, k, v):
        fwd = fam._forward(q, k, v, *full.values(), for_grad=True)
        kept = dict(zip(("out", "lse", "out_lo"), fwd))

    def bwd():
        return fam._backward(q, k, v, go, **full, **kept)

    ops = fam.attention_bwd_ops(b, 32, s, 64, causal=True, q_offset=0,
                                kv_len=s)
    lib_ms, lib_graph_ms = cs.sdpa_backward_ms(q, k, v, go)
    out["train_f32_bwd"] = dict(
        form=backward_form(fam, q, k, v, go), shape=[b, 32, 32, s, s, 64],
        ms=cs.cuda_ms(bwd), graph_ms=cs.graph_ms(bwd),
        split_ms=cs.launch_split(bwd),
        plain_ms=cs.cuda_ms(lambda: fam.flash_attention_bwd(
            q, k, v, go, causal=True), reps=3, warmup=1),
        library_ms=lib_ms, library_graph_ms=lib_graph_ms,
        bound_ms=cs.bound_ms(cs.flash_bwd_bytes(q, k), ops,
                             cs.PEAK_FP32_S)[0],
        bound_tc_ms=3 * ops / cs.PEAK_TF32_S * 1e3)
    return out


if __name__ == "__main__":
    sys.exit(main())
