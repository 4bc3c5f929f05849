"""Plain PyTorch flash attention forward — the port of
``repro.kernels.flash_attention.ref``: fp32 scores of q against K/V's
query group, scaled by ``sm_scale``, masked at -1e30 when causal, fp32
softmax and fp32 ``P @ V``, cast to q's dtype.  Any S.  A sliding window
(``window`` = W > 0, causal only) is the reference prefill's
(``repro.models.layers.causal_attention(window=W)``): row i keeps key j
iff i - W < j <= i.

Rows go in chunks of ``CHUNK`` queries, each against only the keys its
window span (or causal prefix) can keep: a masked key's p is exactly 0,
so a row's function is that of the whole masked score row, and no
(B, Hq, S, S) score tensor is built (25.8 GB in fp32 at B = 2, 48 heads
and S = 8,192).

The CUDA kernel rounds at no other place in bf16: its tensor-core route
feeds P to ``P @ V`` as a bf16 pair (hi = bf16(p), lo = bf16(p - hi)),
which keeps p to about 2^-17, and rounds only the output.  So the two
agree in bf16 within two ulps of the output, not only at the bf16
tolerance."""
import math

import torch

NEG_INF = -1e30
CHUNK = 1024  # query rows per block of scores


def check_window(causal: bool, window: int) -> None:
    """``window``: 0 for none, else W > 0 with ``causal`` (the reference
    has no windowed attention that is not causal)."""
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if window and not causal:
        raise ValueError("flash_attention: a window needs causal=True")


def flash_attention_ref(q, k, v, *, causal: bool = True, sm_scale=None,
                        window: int = 0):
    """q: (B, Hq, S, hd); k, v: (B, KVH, S, hd).  Returns (B, Hq, S, hd)."""
    check_window(causal, window)
    B, Hq, S, hd = q.shape
    KVH = k.shape[1]
    G = Hq // KVH
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, KVH, G, S, hd)
    out = torch.empty(B, KVH, G, S, hd, dtype=q.dtype, device=q.device)
    for c0 in range(0, S, CHUNK):
        c1 = min(S, c0 + CHUNK)
        lo = max(0, c0 - window + 1) if window else 0
        hi = c1 if causal else S
        s = torch.einsum("bkgqd,bksd->bkgqs", qg[:, :, :, c0:c1].float(),
                         k[:, :, lo:hi].float()) * sm_scale
        if causal:
            i = torch.arange(c0, c1, device=q.device)[:, None]
            j = torch.arange(lo, hi, device=q.device)[None, :]
            keep = j <= i
            if window:
                keep &= j > i - window
            s = s.masked_fill(~keep, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out[:, :, :, c0:c1] = torch.einsum(
            "bkgqs,bksd->bkgqd", p, v[:, :, lo:hi].float()).to(q.dtype)
    return out.reshape(B, Hq, S, hd)
