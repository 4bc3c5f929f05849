"""Plain float32 reference of the served dense zoo: the port's dense block
equations (RMSNorm, q/k/v projections with RoPE over split halves,
grouped-query causal attention, the output projection, a SwiGLU MLP, each
with its residual; final RMSNorm and the head), a LoRA app's low-rank q
and v deltas, and an FPFT app's own layer.

It takes the weights the benchmark made, upcasts one layer at a time, and
runs every sampled sequence through that layer before the next, so it
fits beside the weights.  It imports nothing of the program.

``fp8=True`` is the control: the same forward with every weight matrix
and every matmul input rounded to float8 e4m3 (per output channel and per
row scales), the precision below the served bfloat16.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, theta):
    """x (S, heads, hd) at positions 0..S-1: split halves rotated."""
    S, _, hd = x.shape
    inv = 1.0 / theta ** (torch.arange(0, hd // 2, dtype=torch.float32,
                                       device=x.device) * 2.0 / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, rows: int = 1024):
    """q (S, H, hd), k/v (S, KVH, hd); query rows in blocks."""
    S, H, hd = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty_like(q)
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        s = torch.einsum("qhd,khd->hqk", q[r0:r1], k[:r1]) / math.sqrt(hd)
        keep = (torch.arange(r1, device=q.device)[None]
                <= torch.arange(r0, r1, device=q.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
        out[r0:r1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:r1])
    return out


class Linear:
    """x @ w in fp32, or with both rounded to fp8 (the control)."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def weight(self, w: torch.Tensor, rows: int = 0) -> torch.Tensor:
        """The matrix (rows, -1) of ``w``: rows = its input width."""
        w = w.float().reshape(rows or w.shape[0], -1)
        return fp8_round(w, 0) if self.fp8 else w

    def __call__(self, x, w):
        if self.fp8:
            x = fp8_round(x, -1)
        return x @ w


def layer(x, p, d, lin: Linear, lora: Optional[dict]):
    """One dense block on one sequence x (S, D); p holds the layer's
    weights, already prepared by ``lin.weight`` (norms in fp32)."""
    S = x.shape[0]
    H, KVH, hd = d["H"], d["KVH"], d["hd"]
    h = rms_norm(x, p["ln1"], d["eps"])
    q = lin(h, p["wq"])
    k = lin(h, p["wk"])
    v = lin(h, p["wv"])
    if lora is not None:
        q = q + lin(lin(h, lora["a_q"]), lora["b_q"]) * lora["scaling"]
        v = v + lin(lin(h, lora["a_v"]), lora["b_v"]) * lora["scaling"]
    q = rope(q.reshape(S, H, hd), d["theta"])
    k = rope(k.reshape(S, KVH, hd), d["theta"])
    o = causal_attention(q, k, v.reshape(S, KVH, hd))
    x = x + lin(o.reshape(S, H * hd), p["wo"])
    h = rms_norm(x, p["ln2"], d["eps"])
    g = torch.nn.functional.silu(lin(h, p["w_gate"]))
    return x + lin(g * lin(h, p["w_up"]), p["w_down"])


def _prepared(tensors: dict, lin: Linear) -> dict:
    """Norm scales in fp32; matrices (input width, output width), the
    output projection's (H, hd, D) folded to (H * hd, D)."""
    return {k: (v.float() if k.startswith("ln") else
                lin.weight(v, v.shape[0] * v.shape[1] if k == "wo" else 0))
            for k, v in tensors.items()}


@torch.no_grad()
def logits(weights: dict, d: dict, seqs: List[Tuple[str, torch.Tensor, int]],
           *, fp8: bool = False) -> List[torch.Tensor]:
    """seqs: (app, token ids (T,) on the weights' device, first position);
    returns each sequence's fp32 logits (T - first, V) at positions
    first..T-1."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lin = Linear(fp8)
        base, apps = weights["base"], weights["apps"]
        hs = [base["embed"][t.long()].float() for _, t, _ in seqs]
        for i in range(d["L"]):
            p = _prepared({k: v[i] for k, v in base["layers"].items()}, lin)
            own = {}
            for name, app in apps.items():
                if app["kind"] == "fpft" and app["layer"] == i:
                    own[name] = _prepared(app["params"], lin)
                elif app["kind"] == "lora":
                    own[name] = {k: lin.weight(app[k][i])
                                 for k in ("a_q", "b_q", "a_v", "b_v")}
                    own[name]["scaling"] = app["scaling"]
            for j, (app, _, _) in enumerate(seqs):
                kind = apps[app]["kind"] if app in apps else "base"
                hs[j] = layer(hs[j], own.get(app, p) if kind == "fpft" else p,
                              d, lin, own[app] if kind == "lora" else None)
            del p, own
        head = lin.weight(base["lm_head"])
        out = []
        for h, (_, _, first) in zip(hs, seqs):
            out.append(lin(rms_norm(h[first:], base["final_ln"].float(),
                                    d["eps"]), head))
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
