"""Threefry-2x32 and the bit paths of `jax.random`, in numpy.

The JAX package's `--init_stream threefry` draws its parameters with
`jax.random` (stemgnn_tpu/models/stemgnn.py `init_params`). This module
computes the same numbers without JAX, following jax 0.9's default PRNG
(`jax_default_prng_impl` threefry2x32, `jax_threefry_partitionable` on,
64-bit types off), from jax/_src/prng.py and jax/_src/random.py:

- `threefry_2x32(key, x0, x1)`: the hash, 20 rounds with a key injection
  every 4 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3").
- `prng_key(seed)`: `jax.random.PRNGKey`, the key (0, seed mod 2**32) of a
  seed in [-2**31, 2**31).
- `split(key, n)`: key i is the hash of the 64-bit count i (high word,
  low word).
- `random_bits(key, shape)`: 32 bits an entry, the two words of the hash
  of the entry's flat index XOR'ed.
- `uniform(key, shape, minval, maxval)` at f32: 23 random mantissa bits
  under the exponent of 1.0, minus 1, times (maxval - minval), plus minval,
  at least minval; minval and maxval rounded to f32 first.
- `normal(key, shape)` at f32: a uniform on (nextafter(-1, 0), 1), then
  sqrt(2) * erf_inv, with XLA's f32 erf_inv (a degree-8 polynomial in
  w = -log1p(-x * x), XLA's chlo legalization).

All arithmetic is on numpy arrays of uint32, which wrap, and f32, with
XLA's arithmetic on the CPU written out where numpy's differs: a * b + c
contracted into one fused multiply-add (`fma`), and XLA's own f32 log and
log1p (`log_xla`, `log1p_xla`; numpy's libm log1p differs from XLA's on
about one input in six). So the uniform and the normal draws are bitwise
those of `jax.random` on the CPU (tests/test_torch_port_threefry.py); on
an accelerator XLA's log1p, and so a normal draw, can differ from them in
the last bits.
"""

from __future__ import annotations

import math

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry_2x32(key, x0, x1):
    """The Threefry-2x32 hash of the count pairs (x0, x1) (uint32 arrays of
    one shape) under `key` (two uint32 words): two uint32 arrays."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(_PARITY))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) as two uint32 words."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise ValueError(f"seed {seed}: jax.random.PRNGKey takes it as an int32")
    return np.array([0, seed & 0xFFFFFFFF], dtype=_U32)


def _counts(n: int):
    """The 64-bit counts 0 .. n-1 as (high words, low words)."""
    idx = np.arange(n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(_U32), (idx & np.uint64(0xFFFFFFFF)).astype(_U32)


def split(key, n: int = 2) -> np.ndarray:
    """jax.random.split(key, n): [n, 2] uint32."""
    b0, b1 = threefry_2x32(key, *_counts(n))
    return np.stack([b0, b1], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """32 random bits an entry, as jax.random.bits(key, shape, uint32)."""
    shape = tuple(shape)
    b0, b1 = threefry_2x32(key, *_counts(math.prod(shape)))
    return (b0 ^ b1).reshape(shape)


def fma(a, b, c) -> np.ndarray:
    """a * b + c for f32 arrays, rounded once to f32, as XLA on the CPU
    contracts a multiply and an add. The product is exact in f64; the sum is
    formed in f64 rounded to odd (TwoSum gives its error), which rounds to
    f32 as the exact sum would (53 >= 2 * 24 + 2 bits)."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32)
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(np.uint64) & np.uint64(1)) == 0
    s = np.where((err != 0) & even, np.nextafter(s, s + err), s)
    return s.astype(np.float32)


def uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    floats = ((bits >> _U32(32 - 23)) | np.float32(1.0).view(_U32)).view(np.float32)
    floats = floats - np.float32(1.0)
    return np.maximum(lo, fma(floats, hi - lo, lo))


# XLA's f32 erf_inv (Giles, "Approximating the erfinv function"): the
# coefficients for w < 5 and for w >= 5, highest degree first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


# XLA's log1p for |x| below sqrt(2) - 1 (elemental_ir_emitter.cc EmitLog1p,
# after Cephes): x - x^2 / 2 + x^3 P(x) / Q(x), highest degree last
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# XLA's CPU log (polynomial_approximations.cc, after Cephes' logf)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _f32(*vs):
    return [np.float32(v) for v in vs]


def _poly(x, coeffs):
    p = np.zeros_like(x)
    for c in coeffs:
        p = fma(p, x, np.float32(c))
    return p


def _flush(x: np.ndarray) -> np.ndarray:
    """x with its subnormals as zeros of their sign: the CPU's flush-to-zero
    under XLA."""
    x = np.asarray(x, np.float32)
    return np.where(np.abs(x) < np.finfo(np.float32).tiny, np.float32(0) * x, x)


def log_xla(x: np.ndarray) -> np.ndarray:
    """XLA's f32 log on the CPU: x = m 2^e with m in [sqrt(1/2), sqrt(2)),
    log(m) by Cephes' polynomial in m - 1, plus e log(2) in two parts; a
    subnormal input counts as zero."""
    x = _flush(x)
    p = _f32(*_LOG_P)
    q1, q2, half, one = _f32(_LOG_Q1, _LOG_Q2, 0.5, 1.0)
    bits = np.maximum(np.float32(np.finfo(np.float32).tiny), x).view(np.int32)
    m = ((bits & ~0x7F800000) | half.view(np.int32)).view(np.float32)
    e = one + ((bits >> 23) - 0x7F).astype(np.float32)
    low = m < np.float32(0.707106781186547524)
    e = e - np.where(low, one, np.float32(0))
    m = (m - one) + np.where(low, m, np.float32(0))
    x2 = m * m
    x3 = x2 * m
    y = fma(fma(m, p[0], p[1]), m, p[2])
    y1 = fma(fma(m, p[3], p[4]), m, p[5])
    y2 = fma(fma(m, p[6], p[7]), m, p[8])
    y = fma(fma(fma(y, x3, y1), x3, y2), x3, q1 * e)
    out = ((m - half * x2) + y) + q2 * e
    out = np.where(x == 0, np.float32(-np.inf), out)
    out = np.where(x == np.inf, np.float32(np.inf), out)
    return np.where((x < 0) | np.isnan(x), np.float32(np.nan), out)


def log1p_xla(x: np.ndarray) -> np.ndarray:
    """XLA's f32 log1p on the CPU: a rational function of x below
    sqrt(2) - 1 in magnitude, else log(1 + x); a subnormal input counts as
    zero."""
    x = _flush(x)
    x2 = x * x
    small = (x * x2) * (_poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN))
    small = x + fma(np.float32(-0.5), x2, small)
    with np.errstate(invalid="ignore", divide="ignore"):
        large = log_xla(x + np.float32(1.0))
    return np.where(np.abs(x) < np.float32(0.41421356237309504880), small, large)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erf_inv, op for op in f32, subnormals flushed to zero."""
    x = _flush(x)
    w = -log1p_xla(x * -x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, np.where(lt, np.float32(a), np.float32(b)))
    return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), _flush(p * x))


def normal(key, shape) -> np.ndarray:
    """jax.random.normal(key, shape, float32)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, np.float32(1.0))
    return np.float32(np.sqrt(2)) * erf_inv(u)
