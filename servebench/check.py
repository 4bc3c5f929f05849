"""The comparison that decides ``correct`` for a served model.

Once the window has closed and the program's state is freed, a sample of
the requests the program finished, drawn from the seed with the longest
request of each app in it, is run through the plain float32 reference
(``reference/<config's reference>.py``) over its prompt and served tokens.
At each served position the gap is the reference's best logit minus the
reference's logit of the token the program served: 0 where the program
chose the reference's argmax, small where bfloat16 rounding flipped a
near tie.  The number compared is the widest gap.

The control puts the reference in the program's place one precision
below the served bfloat16 (float8 e4m3): at the same positions it reads
the gap of the token the float8 forward puts first.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch


def pick_sample(recs: List[dict], finished: Dict[int, np.ndarray], seed: int,
                min_tokens: int, max_requests: int) -> List[int]:
    """Request indices: the longest finished request of each app, then
    others in an order drawn from the seed until ``min_tokens`` served
    tokens or ``max_requests`` requests."""
    done = [r for r in recs if r["idx"] in finished]
    longest: Dict[str, dict] = {}
    for r in done:
        key = (r["prompt_len"] + r["gen_len"], -r["idx"])
        cur = longest.get(r["app"])
        if cur is None or key > (cur["prompt_len"] + cur["gen_len"],
                                 -cur["idx"]):
            longest[r["app"]] = r
    chosen = sorted(r["idx"] for r in longest.values())
    served = sum(recs[i]["gen_len"] for i in chosen)
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    rest = [r["idx"] for r in done if r["idx"] not in set(chosen)]
    for i in rng.permutation(rest) if rest else []:
        if served >= min_tokens or len(chosen) >= max_requests:
            break
        chosen.append(int(i))
        served += recs[int(i)]["gen_len"]
    return chosen


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of
    ``tokens``."""
    return ref.max(-1).values - ref.gather(-1, tokens[:, None].long())[:, 0]


def compare(cfg: dict, weights: dict, dims: dict, reqs, finished, sample,
            device, control: bool = False) -> dict:
    """The numbers compared, from the reference over the sampled requests;
    with ``control`` also the float8 control's."""
    ref_mod = importlib.import_module(f"servebench.reference.{cfg['reference']}")
    seqs, served = [], []
    for i in sample:
        r, toks = reqs[i], np.asarray(finished[i], np.int64)
        full = np.concatenate([r.prompt.astype(np.int64), toks[:-1]])
        seqs.append((r.app, torch.as_tensor(full, device=device),
                     r.prompt_len - 1))
        served.append(torch.as_tensor(toks, device=device))
    ref = ref_mod.logits(weights, dims, seqs)
    g = torch.cat([gaps(lg, t) for lg, t in zip(ref, served)])
    out = {"widest_gap": float(g.max()), "positions": int(g.numel()),
           "flips": int((g > 0).sum()), "requests": len(sample)}
    if control:
        low = ref_mod.logits(weights, dims, seqs, fp8=True)
        cg = torch.cat([gaps(lg, lo.argmax(-1)) for lg, lo in zip(ref, low)])
        out["control_widest_gap"] = float(cg.max())
        out["control_flips"] = int((cg > 0).sum())
    return out
