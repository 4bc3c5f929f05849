"""The whole harness on the CPU (the look for a card skipped) with the
timed path broken underneath: ``correct`` has to come out false for each
fault a serving cell can have.  (One card: there is no exchange between
chips to leave out.)"""
import pytest
import torch

from repro_torch.serving import executor
from servebench.tests import _tiny

REAL_DECODE = executor.chain_decode_fused
REAL_PREFILL = executor.chain_prefill_fused


def _unchanged(*a, **k):
    """A decode step that returns its state unchanged: the pending token
    again, the cache lengths not advanced."""
    tokens, kv_len = a[2], a[6]
    nxt, probs, pk, pv, _ = REAL_DECODE(*a, **k)
    return tokens.clone(), probs, pk, pv, kv_len


def _half_left_out(*a, **k):
    """Half of the group's lanes left out: they take the first lane's
    token."""
    nxt, probs, pk, pv, kv = REAL_DECODE(*a, **k)
    nxt = nxt.clone()
    nxt[nxt.shape[0] // 2:] = nxt[0]
    return nxt, probs, pk, pv, kv


def _decode_token_altered(*a, **k):
    nxt, probs, pk, pv, kv = REAL_DECODE(*a, **k)
    nxt = nxt.clone()
    nxt[0] = (nxt[0] + 1) % probs.shape[-1]
    return nxt, probs, pk, pv, kv


def _prefill_token_altered(*a, **k):
    nxt, probs, kvs = REAL_PREFILL(*a, **k)
    return (nxt + 1) % probs.shape[-1], probs, kvs


FAULTS = {"state_unchanged": ("chain_decode_fused", _unchanged),
          "half_batch_left_out": ("chain_decode_fused", _half_left_out),
          "decode_token_altered": ("chain_decode_fused",
                                   _decode_token_altered),
          "prefill_token_altered": ("chain_prefill_fused",
                                    _prefill_token_altered)}


def _config():
    """The tiny zoo, every finished request compared, so that a fault in
    any lane shows whatever the sample would have drawn."""
    cfg = _tiny.config()
    cfg["check"].update(min_tokens=10 ** 6, max_requests=10 ** 6)
    return cfg


@pytest.fixture(scope="module")
def sound():
    """A sound run first: it also takes the process's first-call costs,
    so the faulted runs finish as many requests as a sound one."""
    torch.manual_seed(0)
    return _tiny.run(cfg=_config(), mix=_tiny.mix(), seconds=2.5)


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["sample"]["positions"] >= 60


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, sound, monkeypatch):
    name, fn = FAULTS[fault]
    monkeypatch.setattr(executor, name, fn)
    out = _tiny.run(cfg=_config(), mix=_tiny.mix(), seconds=2.5)
    assert out["sample"]["positions"] >= 60
    c = out["checks"]["widest_gap"]
    assert not out["correct"], (fault, c)
    assert c["value"] > c["limit"]
