"""JAX's threefry PRNG draws, in numpy — so the port draws the reference's
random numbers without importing JAX.

``PRNGKey``, ``split``, ``random_bits`` (32-bit) and ``normal`` (float32)
reproduce ``jax.random``'s default threefry2x32 implementation in the
partitionable mode (``jax_threefry_partitionable``, on by default since
JAX 0.5): each element's counter is its flat index as a 64-bit number
split into (hi, lo) words, and its 32 random bits are the xor of the two
threefry output words.  ``normal`` maps the bits to a uniform in
(-1, 1) by JAX's mantissa transform and returns ``sqrt(2) * erfinv(u)``
with XLA's float32 ``erf_inv`` polynomial (Giles, "Approximating the
erfinv function", 2010) and XLA's ``log1p`` and CPU ``log``
approximations inside it, evaluated in float32 in XLA's order, each
multiply-add rounded once as LLVM's fma contraction rounds it on the CPU.
The draws equal ``jax.random.normal``'s on the CPU (bitwise on every
draw the tests take); an fma emulated through float64 can round a tie
differently, so the promise is one float32 ulp.

Keys are ``np.uint32`` arrays of shape (2,), as JAX's raw keys are.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# XLA's float32 erf_inv coefficients, highest degree first, for
# w = -log1p(-x^2) < 5 and >= 5
_ERFINV_LT5 = np.array(
    [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941], np.float32)
_ERFINV_GE5 = np.array(
    [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682], np.float32)


def PRNGKey(seed: int) -> np.ndarray:
    """The raw key of ``jax.random.PRNGKey(seed)``: the 64-bit seed's
    (hi, lo) words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], _U32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block cipher (20 rounds) of the counter words
    ``(x0, x1)`` under ``key``, elementwise."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, _U32(k0 ^ k1 ^ _U32(0x1BD11BDA)))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def _counters(shape) -> Tuple[np.ndarray, np.ndarray]:
    """Each element's flat index as (hi, lo) 32-bit words."""
    n = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (n >> np.uint64(32)).astype(_U32), \
        (n & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    b0, b1 = threefry2x32(key, *_counters((num,)))
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    b0, b1 = threefry2x32(key, *_counters(tuple(shape)))
    return b0 ^ b1


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once (the product is exact in
    float64), as LLVM contracts XLA's multiply-adds on the CPU."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _poly(x: np.ndarray, coeffs) -> np.ndarray:
    """Horner from the highest degree, one fma a step."""
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, np.float32(c))
    return p


def _log_f32(v: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` for positive normal ``v`` (Cephes ``logf``
    as Eigen vectorises it): v = m * 2^e with m in [sqrt(1/2), sqrt(2)),
    log(m) by a degree-9 polynomial in m - 1, then + e * log(2) in two
    parts."""
    f32 = np.float32
    bits = np.maximum(v, np.array(0x00800000, _U32).view(f32)).view(_U32)
    e = f32(1.0) + ((bits >> _U32(23)).astype(np.int32) - 0x7F).astype(f32)
    m = ((bits & _U32(0x807FFFFF)) | np.array(0.5, f32).view(_U32)).view(f32)
    low = m < f32(0.707106781186547524)
    e = e - np.where(low, f32(1.0), f32(0.0))
    t = (m - f32(1.0)) + np.where(low, m, f32(0.0))
    t2 = t * t
    t3 = t2 * t
    y = _fma(_fma(t, f32(7.0376836292e-2), f32(-1.1514610310e-1)), t,
             f32(1.1676998740e-1))
    y1 = _fma(_fma(t, f32(-1.2420140846e-1), f32(1.4249322787e-1)), t,
              f32(-1.6668057665e-1))
    y2 = _fma(_fma(t, f32(2.0000714765e-1), f32(-2.4999993993e-1)), t,
              f32(3.3333331174e-1))
    y = _fma(_fma(_fma(y, t3, y1), t3, y2), t3, f32(-2.12194440e-4) * e)
    t = _fma(f32(-0.5), t2, t) + y
    return _fma(f32(0.693359375), e, t)


# Cephes log1p rational coefficients XLA uses for |x| < sqrt(2) - 1
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``log1p`` for x in (-1, 0]."""
    f32 = np.float32
    x2 = x * x
    r = _poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)
    small = x + _fma(f32(-0.5), x2, (x * x2) * r)
    with np.errstate(divide="ignore"):
        large = _log_f32(f32(1.0) + x)
    return np.where(np.abs(x) < f32(0.41421356237309504880), small, large)


def _erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``: w = -log1p(-x^2), then a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x."""
    f32 = np.float32
    w = -_log1p_f32(x * -x)
    lt = w < f32(5.0)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3.0))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, c_lt, c_ge))
    return np.where(np.abs(x) == f32(1.0), x * f32(np.inf), p * x)


def uniform(key: np.ndarray, shape, minval: float, maxval: float
            ) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled into [minval, maxval)."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2)) * _erfinv_f32(u)
