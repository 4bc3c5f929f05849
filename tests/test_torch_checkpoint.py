"""The PyTorch port's checkpointing (``repro_torch/checkpoint``) and its
restart path through ``training/train_loop.train``, the training launcher
and the train-and-partition example, on the CPU.

Checkpoints cross between the packages: one written by the JAX
``Checkpointer`` restores in the port, and the port's restores in JAX,
both bitwise, with the same manifest (leaf order, key paths, shapes,
dtypes).  A restart on the CPU is bitwise the uninterrupted run.
"""
import json
import os
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from repro_torch.bridge import to_torch
from repro_torch.checkpoint import Checkpointer, install_preemption_hook
from repro_torch.configs import get_reduced_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import TrainConfig, train
from repro_torch.tree import tree_leaves


def _state(seed=0):
    cfg = get_reduced_config("tinyllama-1.1b")
    params = build_model(cfg).init(torch.Generator().manual_seed(seed),
                                   "cpu")
    opt = adamw_init(params)
    opt["step"] = torch.tensor(7, dtype=torch.int32)
    opt["m"] = {k: (v if not isinstance(v, dict) else
                    {kk: vv + 0.5 for kk, vv in v.items()})
                for k, v in opt["m"].items()}
    return {"params": params, "opt": opt}


def _equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_round_trip_is_bitwise(tmp_path):
    state = _state()
    ck = Checkpointer(str(tmp_path))
    ck.save(7, state, blocking=True)
    assert ck.latest_step() == 7
    template = _state(seed=1)
    got = ck.restore(template)
    assert _equal(got, state) and not _equal(template, state)
    assert list(got["params"]) == list(state["params"])
    manifest = json.loads((tmp_path / "step_00000007" /
                           "manifest.json").read_text())
    assert manifest["step"] == 7
    paths = [m["path"] for m in manifest["leaves"]]
    assert paths[0] == "(DictKey(key='opt'), DictKey(key='m'), " \
                       "DictKey(key='embed'))"
    assert paths.index("(DictKey(key='opt'), DictKey(key='step'))") == \
        len(tree_leaves(state["opt"]["m"]))


def test_async_save_copies_before_returning_and_wait_publishes(tmp_path):
    state = _state()
    want = [t.clone() for t in tree_leaves(state)]
    ck = Checkpointer(str(tmp_path))
    gate = threading.Event()
    ck._pool.submit(gate.wait)  # hold the writer thread
    ck.save(3, state)
    assert ck.latest_step() is None  # not yet published
    for t in tree_leaves(state):
        t.add_(1)  # the caller goes on writing its tensors
    assert ck.save(3, state) == tmp_path / "step_00000003"  # pending: no-op
    gate.set()
    ck.wait()
    assert ck.latest_step() == 3
    got = ck.restore(_state(seed=1))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), want))


def test_gc_keeps_the_last_steps_and_ignores_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    tree = {"w": torch.arange(4.0)}
    for step in (1, 2, 3, 4):
        ck.save(step, {"w": tree["w"] + step})
    ck.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_00000003", "step_00000004"]
    (tmp_path / ".tmp_step_00000009").mkdir()  # a write cut short
    (tmp_path / "step_00000009.partial").mkdir()
    assert ck.latest_step() == 4
    assert torch.equal(ck.restore(tree)["w"], torch.arange(4.0) + 4)
    assert torch.equal(ck.restore(tree, step=3)["w"], torch.arange(4.0) + 3)
    ck.save(4, {"w": tree["w"]}, blocking=True)  # idempotent per step
    assert torch.equal(ck.restore(tree)["w"], torch.arange(4.0) + 4)


def test_restore_checks_the_template(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.zeros(2), "b": torch.zeros(3)}, blocking=True)
    with pytest.raises(ValueError, match="tree mismatch"):
        ck.restore({"a": torch.zeros(2)})
    with pytest.raises(ValueError):  # sorted order: a (2,) then b (3,)
        ck.restore({"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError):
        ck.restore({"a": torch.zeros(2, dtype=torch.float64),
                    "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="needs the mesh"):
        ck.restore({"a": torch.zeros(2), "b": torch.zeros(3)},
                   shardings=object())
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"a": torch.zeros(2)})
    with pytest.raises(TypeError):
        ck.save(2, {"a": torch.zeros(2, dtype=torch.bfloat16)})


def _jax_state(seed=0):
    from repro.configs import get_reduced_config as j_cfg
    from repro.models.model import build_model as j_build
    from repro.training.optimizer import adamw_init as j_adamw_init

    params = j_build(j_cfg("tinyllama-1.1b")).init(jax.random.PRNGKey(seed))
    opt = j_adamw_init(params)
    opt["step"] = opt["step"] + 7
    return {"params": params, "opt": opt}


def _as_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _manifest(d):
    return json.loads((d / "manifest.json").read_text())


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    from repro.checkpoint import Checkpointer as JCheckpointer

    state = _jax_state()
    JCheckpointer(str(tmp_path / "jax")).save(7, state, blocking=True)
    got = Checkpointer(str(tmp_path / "jax")).restore(_state(seed=1))
    want = to_torch(_as_np(state), device="cpu")
    assert _equal(got, want)
    assert got["opt"]["step"].dtype == torch.int32
    # the port writes the same manifest for the same tree
    Checkpointer(str(tmp_path / "port")).save(7, got, blocking=True)
    assert _manifest(tmp_path / "port" / "step_00000007") == \
        _manifest(tmp_path / "jax" / "step_00000007")


def test_port_checkpoint_restores_in_jax(tmp_path):
    from repro.checkpoint import Checkpointer as JCheckpointer

    state = _state()
    Checkpointer(str(tmp_path)).save(7, state, blocking=True)
    got = JCheckpointer(str(tmp_path)).restore(_jax_state(seed=1))
    for a, b in zip(jax.tree.leaves(_as_np(got)), tree_leaves(state)):
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())


def _train(tmp, steps, **kw):
    cfg = get_reduced_config("tinyllama-1.1b")
    dc = DataConfig(vocab_size=cfg.vocab_size, global_batch=4, seq_len=16)
    return train(cfg, TrainConfig(steps=steps, ckpt_dir=tmp, ckpt_every=2,
                                  microbatches=2),
                 dc, device="cpu", compute_dtype=torch.float32, **kw)


def test_resume_is_bitwise_on_the_cpu(tmp_path):
    """2 steps, a checkpoint, a restart that restores it and runs 2 more:
    the losses and parameters of the uninterrupted 4 steps, bitwise."""
    whole = _train(None, 4)
    first = _train(str(tmp_path), 2)
    assert Checkpointer(str(tmp_path)).latest_step() == 2
    rest = _train(str(tmp_path), 4)
    assert len(rest["losses"]) == 2
    assert first["losses"] + rest["losses"] == whole["losses"]
    assert int(rest["opt_state"]["step"]) == 4
    assert _equal(rest["params"], whole["params"])
    assert _equal(rest["opt_state"], whole["opt_state"])


def test_sigterm_writes_a_blocking_checkpoint(tmp_path):
    state = _state()
    ck = Checkpointer(str(tmp_path))
    old = signal.getsignal(signal.SIGTERM)
    try:
        install_preemption_hook(ck, lambda: (11, state))
        os.kill(os.getpid(), signal.SIGTERM)
        assert ck.latest_step() == 11
        assert _equal(ck.restore(_state(seed=1)), state)
    finally:
        signal.signal(signal.SIGTERM, old)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launcher

    out = launcher.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps",
                         "3", "--batch", "4", "--seq", "16", "--device",
                         "cpu", "--microbatches", "2", "--grad-compress",
                         "int8", "--ckpt", str(tmp_path)])
    assert len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert Checkpointer(str(tmp_path)).latest_step() == 3
    assert "tinyllama-1.1b-reduced: loss" in capsys.readouterr().out


def test_example_trains_registers_and_profiles(tmp_path, capsys):
    from repro_torch.examples import train_and_partition

    out, zoo, rec = train_and_partition.main(
        ["--steps", "3", "--device", "cpu", "--ckpt", str(tmp_path)])
    assert len(out["losses"]) == 3
    assert set(zoo.chains) == {"trained-base", "trained-lora"}
    assert zoo.redundancy_fraction() > 0
    assert sorted(rec.compute_time_per_token) == [1, 8]
    base = zoo.blocks[zoo.chains["trained-base"].steps[0].block_id]
    assert torch.equal(base.params["embed"], out["params"]["embed"])
    assert Checkpointer(str(tmp_path)).latest_step() == 3
    assert "redundancy removed" in capsys.readouterr().out
