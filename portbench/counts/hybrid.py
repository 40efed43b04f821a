"""The hybrid family's matrix parameters and kernel calls (Zamba2: Mamba2
layers, one shared attention block applied before every group)."""
from __future__ import annotations


def matrix_params(s: dict) -> tuple[int, int]:
    """(matrix parameters a token goes through in the body, those of the
    tied logits head over the real vocabulary)."""
    d = s["d_model"]
    di = s["expand"] * d
    h = di // s["head_dim"]
    mamba = d * (2 * di + 2 * s["ssm_state"] + h) + di * d
    hd = s["head_dim"]
    shared = (2 * d * d + d * (s["heads"] + 2 * s["kv_heads"]) * hd
              + s["heads"] * hd * d + 3 * d * s["d_ff"])
    sites = s["layers"] // s["attn_every"]
    return s["layers"] * mamba + sites * shared, d * s["vocab"]


def attention_calls(s: dict, batch: int, seq: int) -> list[dict]:
    call = dict(b=batch, h=s["heads"], hkv=s["kv_heads"], s=seq,
                d=s["head_dim"], window=None)
    return [call] * (s["layers"] // s["attn_every"])


def scan_calls(s: dict, batch: int, seq: int) -> list[dict]:
    di = s["expand"] * s["d_model"]
    call = dict(b=batch, s=seq, h=di // s["head_dim"], n=s["ssm_state"],
                p=s["head_dim"])
    return [call] * s["layers"]


def expert_calls(s: dict, batch: int, seq: int) -> list[dict]:
    return []
