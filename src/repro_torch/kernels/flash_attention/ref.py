"""Plain PyTorch flash attention forward — the port of
``repro.kernels.flash_attention.ref``: K/V repeated over the query group,
fp32 scores scaled by ``sm_scale``, a ``tril`` mask at -1e30 when causal,
fp32 softmax and fp32 ``P @ V``, cast to q's dtype.  Any S.

The CUDA kernel rounds at no other place in bf16: its tensor-core route
feeds P to ``P @ V`` as a bf16 pair (hi = bf16(p), lo = bf16(p - hi)),
which keeps p to about 2^-17, and rounds only the output.  So the two
agree in bf16 within two ulps of the output, not only at the bf16
tolerance."""
import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, sm_scale=None):
    """q: (B, Hq, S, hd); k, v: (B, KVH, S, hd).  Returns (B, Hq, S, hd)."""
    B, Hq, S, hd = q.shape
    G = Hq // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
