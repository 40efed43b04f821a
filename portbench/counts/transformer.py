"""The transformer family's matrix parameters and kernel calls (GQA with
an optional window; a dense MLP and/or top-k experts)."""
from __future__ import annotations


def matrix_params(s: dict) -> tuple[int, int]:
    """(matrix parameters a token goes through in the body: its top-k
    experts and the router, those of the logits head over the real
    vocabulary)."""
    d, hd, f = s["d_model"], s["head_dim"], s["d_ff"]
    layer = d * (s["heads"] + 2 * s["kv_heads"]) * hd + s["heads"] * hd * d
    if s.get("dense_ff", True):
        layer += 3 * d * f
    if s.get("moe"):
        layer += d * s["moe"]["num_experts"] + s["moe"]["top_k"] * 3 * d * f
    return s["layers"] * layer, d * s["vocab"]


def attention_calls(s: dict, batch: int, seq: int) -> list[dict]:
    call = dict(b=batch, h=s["heads"], hkv=s["kv_heads"], s=seq,
                d=s["head_dim"], window=s.get("window"))
    return [call] * s["layers"]


def scan_calls(s: dict, batch: int, seq: int) -> list[dict]:
    return []


def expert_calls(s: dict, batch: int, seq: int) -> list[dict]:
    """Each MoE layer's grouped expert GEMMs: every token to its top-k."""
    if not s.get("moe"):
        return []
    tokens = batch * seq
    call = dict(tokens=tokens, pairs=tokens * s["moe"]["top_k"],
                d=s["d_model"], f=s["d_ff"], experts=s["moe"]["num_experts"])
    return [call] * s["layers"]
