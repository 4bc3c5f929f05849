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


def paged_attention_split_ref(q, k_pages, v_pages, block_tables, seq_lens,
                              split_tokens: int):
    """Tests-only plain model of the CUDA kernel's split: each run of
    ``split_tokens`` positions from 0 gives an fp32 partial (m, l, acc),
    with masked scores at ``NEG_INF`` and ``p = exp(s - m)``; splits that
    start at or past ``seq_len`` take no part; the live partials are
    rescaled by their maxima and summed in split order.  Splits cover the
    whole table (``ceil(n * page / split_tokens)``), as the kernel's grid
    does."""
    B, Hq, hd = q.shape
    _, page, KVH, _ = k_pages.shape
    n = block_tables.shape[1]
    G = Hq // KVH
    n_splits = -(-n * page // split_tokens)
    span = n_splits * split_tokens
    tables = block_tables.long()
    k = k_pages[tables].reshape(B, n * page, KVH, hd).float()
    v = v_pages[tables].reshape(B, n * page, KVH, hd).float()
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, span - n * page))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, span - n * page))
    qg = q.reshape(B, KVH, G, hd).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) / math.sqrt(hd)
    lens = seq_lens.to(q.device).long()
    pos = torch.arange(span, device=q.device)
    s = s.masked_fill(pos[None, None, None] >= lens[:, None, None, None],
                      NEG_INF)
    s = s.reshape(B, KVH, G, n_splits, split_tokens)
    m = s.amax(dim=-1)                                    # (B, KVH, G, ns)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgcs,bcshd->bhgcd", p,
                       v.reshape(B, n_splits, split_tokens, KVH, hd))
    live = torch.arange(n_splits, device=q.device)[None] * split_tokens \
        < lens[:, None]                                   # (B, ns)
    M = torch.full_like(m[..., 0], NEG_INF)
    L = torch.zeros_like(M)
    A = torch.zeros_like(acc[..., 0, :])
    for c in range(n_splits):
        M = torch.where(live[:, c, None, None], torch.maximum(M, m[..., c]),
                        M)
    for c in range(n_splits):
        w = torch.exp(m[..., c] - M)
        keep = live[:, c, None, None]
        L = torch.where(keep, L + l[..., c] * w, L)
        A = torch.where(keep[..., None], A + acc[..., c, :] * w[..., None], A)
    o = A / L.clamp_min(1e-30)[..., None]
    return o.reshape(B, Hq, hd).to(q.dtype)
