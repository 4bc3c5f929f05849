"""Engine driver: BlockLLM as its users run it, ``BlockEngine.submit`` and
``step`` over a zoo of one foundation and its fine-tuned apps.

The driver makes the weights itself, on the device from the seed, in the
type they are served in, and registers them through the program's
``zoo_from_params``.  It serves the mix's requests open loop (each sent at
its due time) or closed loop (each client sends its next request when the
last one finished), synchronises the device after every engine step and
stamps the tokens that step made with that time: a token is delivered
once it exists on the device at the end of the step that made it.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.api import ServeRequest
from repro_torch.serving.demo import zoo_from_params
from repro_torch.serving.engine import BlockEngine, EngineConfig

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: dict) -> ModelConfig:
    """The program's config object for the file's published widths."""
    m = cfg["model"]
    return ModelConfig(
        name=cfg["name"], family="dense", num_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab_size=m["vocab_size"], head_dim=m["head_dim"],
        rope_theta=float(m["rope_theta"]), norm_eps=float(m["norm_eps"]))


def dims(cfg: dict) -> dict:
    m = cfg["model"]
    return {"L": m["num_hidden_layers"], "D": m["hidden_size"],
            "H": m["num_attention_heads"], "KVH": m["num_key_value_heads"],
            "hd": m["head_dim"], "F": m["intermediate_size"],
            "V": m["vocab_size"], "eps": float(m["norm_eps"]),
            "theta": float(m["rope_theta"])}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every tensor of the zoo, drawn on ``device`` from ``seed`` with one
    generator, one call per stacked tensor, in the served type: the
    foundation (layers stacked on a leading axis), the FPFT app's own
    layer and the LoRA app's stacked A and B.  Norm scales are ones in
    fp32, as the program's init makes them."""
    d = dims(cfg)
    L, D, H, KVH, hd, F, V = (d[k] for k in ("L", "D", "H", "KVH", "hd",
                                             "F", "V"))
    dt = DTYPES[cfg["serving"]["dtype"]]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))

    def normal(shape, std):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            0.0, std, generator=g)

    layers = {
        "ln1": torch.ones((L, D), dtype=torch.float32, device=device),
        "ln2": torch.ones((L, D), dtype=torch.float32, device=device),
        "wq": normal((L, D, H, hd), D ** -0.5),
        "wk": normal((L, D, KVH, hd), D ** -0.5),
        "wv": normal((L, D, KVH, hd), D ** -0.5),
        "wo": normal((L, H, hd, D), (H * hd) ** -0.5),
        "w_gate": normal((L, D, F), D ** -0.5),
        "w_up": normal((L, D, F), D ** -0.5),
        "w_down": normal((L, F, D), F ** -0.5),
    }
    base = {"embed": normal((V, D), D ** -0.5), "layers": layers,
            "final_ln": torch.ones((D,), dtype=torch.float32, device=device),
            "lm_head": normal((D, V), D ** -0.5)}
    apps = {}
    for name, app in cfg["zoo"].items():
        if app["kind"] == "fpft":
            i, sigma = app["layer"], app["sigma"]
            own = {}
            for k, full in layers.items():
                x = full[i]
                std = x.float().std(correction=0).item()
                own[k] = (x.float() + sigma * std * normal(x.shape, 1.0)
                          .float()).to(x.dtype)
            apps[name] = {"kind": "fpft", "layer": i, "params": own}
        elif app["kind"] == "lora":
            r = app["rank"]
            apps[name] = {"kind": "lora", "scaling": float(app["scaling"]),
                          "a_q": normal((L, D, r), D ** -0.5),
                          "b_q": normal((L, r, H * hd), app["b_std"]),
                          "a_v": normal((L, D, r), D ** -0.5),
                          "b_v": normal((L, r, KVH * hd), app["b_std"])}
        else:
            raise ValueError(f"zoo app kind {app['kind']!r}")
    return {"base": base, "apps": apps}


def register(cfg: dict, weights: dict, device):
    """The zoo through the program's own registration: ``base``, the FPFT
    app as ``vicuna`` and the LoRA app as ``app-lora``, the names
    ``zoo_from_params`` gives them."""
    mc = model_config(cfg)
    base = weights["base"]
    ft, peft_trees = None, {}
    for name, app in weights["apps"].items():
        if app["kind"] == "fpft":
            if name != "vicuna":
                raise ValueError("zoo_from_params names the FPFT app vicuna")
            i = app["layer"]
            ft = dict(base)
            ft["layers"] = {k: [app["params"][k] if j == i else full[j]
                                for j in range(mc.num_layers)]
                            for k, full in base["layers"].items()}
        else:
            if name != "app-lora":
                raise ValueError("zoo_from_params names the LoRA app app-lora")
            scaling = torch.tensor(app["scaling"], dtype=torch.float32,
                                   device=device)
            peft_trees["lora"] = [
                {"a_q": app["a_q"][j], "b_q": app["b_q"][j],
                 "a_v": app["a_v"][j], "b_v": app["b_v"][j],
                 "scaling": scaling} for j in range(mc.num_layers)]
    if ft is None:
        raise ValueError("the zoo needs its FPFT app")
    return zoo_from_params(mc, base, ft, peft_trees, device)


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Session:
    """One engine over one zoo, driven by one run's requests."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str):
        self.cfg, self.mix = cfg, mix
        self.device = torch.device(device)
        self.dims = dims(cfg)
        s = cfg["serving"]
        if s["policy"] != "fcfs":
            raise ValueError("tokens are counted for fcfs admission only")
        t = [time.perf_counter()]
        self.weights = make_weights(cfg, seed, self.device)
        self._sync()
        t.append(time.perf_counter())
        self.zoo = register(cfg, self.weights, self.device)
        t.append(time.perf_counter())
        self.engine = None
        self.reset()
        self._sync()
        t.append(time.perf_counter())
        self.setup_parts = {"weights_s": t[1] - t[0], "zoo_s": t[2] - t[1],
                            "engine_s": t[3] - t[2]}

    def reset(self) -> None:
        """A fresh engine (empty pools and queues) over the same zoo."""
        s = self.cfg["serving"]
        self.engine = None
        gc.collect()
        self.engine = BlockEngine(self.zoo, max_len=s["max_len"],
                                  config=EngineConfig(
            max_active=s["max_active"], max_block_batch=s["max_block_batch"],
            page_size=s["page_size"], num_pages=s["num_pages"],
            policy="fcfs", device=str(self.device), compute_dtype=s["dtype"]))
        self.finished: Dict[int, np.ndarray] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self, reqs) -> None:
        """Every prefill bucket the run's prompts fall in, once per app,
        and a full decode group per app; drained before the run starts."""
        t0 = time.perf_counter()
        e = self.engine
        apps = sorted({r.app for r in reqs})
        buckets = sorted({_bucket(r.prompt_len) for r in reqs})
        rng = np.random.default_rng(0)
        V = self.dims["V"]
        for b in buckets:
            n = min(b, max(r.prompt_len for r in reqs))
            for a in apps:
                e.submit(ServeRequest(app=a, gen_len=2, prompt_tokens=(
                    rng.integers(0, V, n, dtype=np.int32))))
            e.drain()
        width = self.cfg["serving"]["max_block_batch"]
        for a in apps:
            for _ in range(width):
                e.submit(ServeRequest(app=a, gen_len=4, prompt_tokens=(
                    rng.integers(0, V, 64, dtype=np.int32))))
        e.drain()
        self._sync()
        self.setup_parts["warm_s"] = time.perf_counter() - t0

    def _used_pages(self) -> int:
        return sum(p.used_pages for p in self.engine.pools.values())

    def usable_pages(self) -> int:
        return sum(p.num_pages - 1 for p in self.engine.pools.values())

    def run(self, reqs, seconds: float, t_proc: float, tracer=None) -> dict:
        """Pre-roll, then the measured window; returns the run's record.
        ``tracer`` (traced runs) traces the window's last ``trace_s``
        seconds, from a step boundary to the close, and wraps the
        program's layers in host spans meanwhile."""
        e, mix = self.engine, self.mix
        closed = mix["loop"] == "closed"
        clock = time.perf_counter
        preroll = float(mix["preroll_s"])
        trace_s = float(mix["trace_s"])
        recs = [{"idx": r.idx, "app": r.app, "prompt_len": r.prompt_len,
                 "gen_len": r.gen_len, "due": None, "times": []}
                for r in reqs]
        by_rid: Dict[int, dict] = {}
        steps: List[dict] = []
        nxt = 0
        t0 = clock()
        if closed:  # every client sends its first request at once
            for _ in range(min(mix["clients"], len(reqs))):
                recs[nxt]["due"] = t0
                nxt += 1
        w0 = t0 + preroll
        w_end = w0 + seconds
        win = None       # (first step boundary >= w0) state snapshot
        traced = None    # [t_start, t_stop]
        seen = set()
        step_wall = e.metrics.histogram("step_wall_s")
        queue_wait = e.metrics.histogram("queue_wait_s")
        kv_used_max = 0
        while True:
            now = clock()
            if win is None and now >= w0:
                win = {"t": now, "steps": len(steps),
                       "counters": dict(e.stats),
                       "step_wall_n": step_wall.count,
                       "queue_wait_n": queue_wait.count,
                       "setup_peak": (torch.cuda.max_memory_allocated(
                           self.device) if self.device.type == "cuda"
                           else 0)}
                if self.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(self.device)
                kv_used_max = self._used_pages()
            # the traced slice is the window's last trace_s seconds: the
            # profiler's own cost then falls on the window's end, and its
            # events are read once the window has closed
            if (tracer is not None and traced is None
                    and now >= w_end - trace_s):
                tracer.start()
                traced = [clock(), None]
            if now >= w_end:
                w1 = now
                break
            # open loop: everything due by now is sent
            while (not closed and nxt < len(reqs)
                   and t0 + reqs[nxt].due <= now):
                self._submit(reqs[nxt], recs[nxt], t0 + reqs[nxt].due,
                             by_rid)
                nxt += 1
            if closed:
                for rec in recs[:nxt]:
                    if rec["due"] is not None and "rid" not in rec:
                        self._submit(reqs[rec["idx"]], rec, rec["due"],
                                     by_rid)
            if not e.active and not e.scheduler.waiting:
                if closed:  # the clients have nothing left to send
                    w1 = clock()
                    break
                wake = min(t0 + reqs[nxt].due if nxt < len(reqs) else w_end,
                           w_end)
                time.sleep(max(0.0, wake - clock()))
                continue
            ts = clock()
            calls0 = e.stats["group_calls"]
            results = e.step() or []
            self._sync()
            t = clock()
            step = {"t0": ts, "t": t, "decode": [], "prefill": [],
                    "inflight": len(e.active) + e.scheduler.waiting,
                    "groups": e.stats["group_calls"] - calls0}
            for s in e.active:
                rec = by_rid[s.rid]
                if s.rid not in seen:  # prefilled in this step
                    seen.add(s.rid)
                    rec["times"].append(t)
                    step["prefill"].append((rec["app"], rec["prompt_len"]))
                # one decode token: the pending token attended over the
                # prompt and the tokens delivered before it
                keys = rec["prompt_len"] + len(rec["times"])
                rec["times"].append(t)
                step["decode"].append((rec["app"], keys))
            for res in results:
                rec = by_rid[res.rid]
                if res.rid not in seen:  # prefilled and finished at once
                    seen.add(res.rid)
                    rec["times"].append(t)
                    step["prefill"].append((rec["app"], rec["prompt_len"]))
                toks = np.asarray(res.tokens)
                if len(toks) != rec["gen_len"] or len(rec["times"]) \
                        != rec["gen_len"]:
                    raise RuntimeError(
                        f"request {rec['idx']}: {len(toks)} tokens served, "
                        f"{len(rec['times'])} delivered, "
                        f"{rec['gen_len']} asked")
                self.finished[rec["idx"]] = toks
                rec["done"] = t
                if closed and nxt < len(reqs):
                    recs[nxt]["due"] = t
                    nxt += 1
            steps.append(step)
            if win is not None:
                kv_used_max = max(kv_used_max, self._used_pages())
        if traced is not None:
            tracer.stop()
            traced[1] = clock()
        if win is None:
            raise RuntimeError("the pre-roll outlasted the run")
        window_peak = (torch.cuda.max_memory_allocated(self.device)
                       if self.device.type == "cuda" else 0)
        c0, c1 = win["counters"], dict(e.stats)
        return {
            "t_proc": t_proc, "t0": t0, "w0": w0, "w_end": w_end, "w1": w1,
            "w0_step": win["t"], "requests": recs, "steps": steps,
            "win_steps": len(steps) - win["steps"],
            "counters": {k: c1[k] - c0.get(k, 0) for k in c1},
            "step_wall_s": list(step_wall._values[win["step_wall_n"]:]),
            "step_wall_exact": step_wall.count <= len(step_wall._values),
            "queue_wait_s": list(queue_wait._values[win["queue_wait_n"]:]),
            "queue_wait_exact": queue_wait.count <= len(queue_wait._values),
            "kv_used_max": kv_used_max, "kv_usable": self.usable_pages(),
            "setup_peak_bytes": win["setup_peak"],
            "window_peak_bytes": window_peak,
            "traced": traced, "dims": self.dims,
            "setup_parts": dict(self.setup_parts, preroll_s=w0 - t0),
            "lora_rank": {a: w["a_q"].shape[-1]
                          for a, w in self.weights["apps"].items()
                          if w["kind"] == "lora"},
        }

    def _submit(self, req, rec, due: float, by_rid) -> None:
        rec["due"] = due
        rid = self.engine.submit(ServeRequest(
            app=req.app, gen_len=req.gen_len, prompt_tokens=req.prompt))
        rec["rid"] = rid
        by_rid[rid] = rec

    def host_spans(self):
        """(object, method name, span name): the program's layers a traced
        run wraps in host spans, to say what the host did in each idle gap
        of the device."""
        e = self.engine
        return [(e, "_admit", "engine.admit"),
                (e.executor, "prefill_batched", "executor.prefill_batched"),
                (e.executor, "fused_step", "executor.fused_step"),
                (e.executor, "retire_states", "executor.retire_states"),
                (e, "step", "engine.step")]

    def close(self) -> None:
        """Free the program's state: the engine, its pools and the zoo.  The
        weights made here stay, for the reference."""
        self.engine = None
        self.zoo = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
