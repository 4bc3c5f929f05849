"""Plain PyTorch version of paged decode attention — the port of
``repro.kernels.paged_attention.ref``: gather each sequence's pages into a
dense cache, mask positions at or past ``seq_len``, fp32 softmax."""
import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_tables, seq_lens):
    """q: (B, Hq, hd); pages: (P, page, KVH, hd); block_tables: (B, n)."""
    B, Hq, hd = q.shape
    _, page, KVH, _ = k_pages.shape
    n = block_tables.shape[1]
    G = Hq // KVH
    tables = block_tables.long()
    # gather each sequence's pages -> dense (B, n*page, KVH, hd)
    k = k_pages[tables].reshape(B, n * page, KVH, hd)
    v = v_pages[tables].reshape(B, n * page, KVH, hd)
    qg = q.reshape(B, KVH, G, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) / math.sqrt(hd)
    pos = torch.arange(n * page, device=q.device)[None, None, None]
    s = s.masked_fill(pos >= seq_lens.to(q.device)[:, None, None, None],
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o.reshape(B, Hq, hd).to(q.dtype)
