"""counts.py against hand-worked cases."""
import pytest

from servebench import counts

D = {"L": 2, "D": 8, "H": 4, "KVH": 2, "hd": 2, "F": 16, "V": 10}


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(989e12, 6.7e12) == pytest.approx(2.0)


def test_paged_decode():
    f, b = counts.paged_decode(D, keys=5)
    # 4 * H * hd * keys per layer: 4*4*2*5 = 160, two layers
    assert f == 320
    # K and V: 2*5*2*2 = 40; q, o: 2*4*2 = 16; new K/V: 2*2*2 = 8 -> 64
    # elements of 2 bytes, two layers
    assert b == 64 * 2 * 2


def test_flash_prefill():
    f, b = counts.flash_prefill(D, S=3)
    assert f == 4 * 4 * 2 * 6 * 2          # 6 causal pairs
    assert b == (2 * 3 * 4 * 2 + 2 * 3 * 2 * 2) * 2 * 2


def test_lora_qv():
    f, b = counts.lora_qv(D, rank=1, tokens=3, weight_reads=2)
    # q: n = 8, v: n = 4
    fq = 2 * 3 * (8 * 8 + 1 * (8 + 8))
    fv = 2 * 3 * (8 * 4 + 1 * (8 + 4))
    assert f == (fq + fv) * 2
    bq = (2 * (8 * 8 + 8 + 8) + 3 * (8 + 8)) * 2
    bv = (2 * (8 * 4 + 8 + 4) + 3 * (8 + 4)) * 2
    assert b == (bq + bv) * 2


def test_model_flops():
    layer = 8 * (4 + 4) * 2 + 4 * 2 * 8 + 3 * 8 * 16   # 128 + 64 + 384
    assert counts.dense_layer_params(D) == layer
    assert counts.token_flops(D, keys=0) == 2 * (2 * layer + 8 * 10)
    assert counts.token_flops(D, keys=3) == 2 * (2 * layer + 80) \
        + 4 * 4 * 2 * 3 * 2
    assert counts.token_flops(D, 0, lora_rank=1) - counts.token_flops(
        D, 0) == 2 * 1 * (16 + 12) * 2
    # a prefill of S tokens needs the head once
    assert counts.prompt_flops(D, 2) == 2 * 2 * 2 * layer \
        + 4 * 4 * 2 * 2 * 3 + 2 * 80
