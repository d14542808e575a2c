"""The JAX package's initial parameters for a seed, drawn in numpy.

Every trainer of the JAX package starts from ``model.init(PRNGKey(seed))``.
This module draws the same numbers without JAX, so every trainer of the port
starts where the JAX package starts for the same seed:

  * ``threefry2x32`` and the key functions ``key``, ``split``, ``fold_in``
    and ``random_bits`` in JAX's partitionable layout (the counter of element
    i is the (hi, lo) pair of the flat index i, and the two output words are
    XORed into one);
  * ``uniform``, ``normal`` and ``truncated_normal`` as ``jax.random`` forms
    them from those bits, with the arithmetic of XLA's CPU program: its
    float32 ``erf_inv`` polynomial, its ``log1p`` (a Cephes rational below
    sqrt(2) - 1, a Cephes ``log`` of 1 + x above), and the fused
    multiply-adds it contracts (``fma``);
  * ``param_key``: Flax's key of one parameter, the root key folded with the
    first four bytes of the SHA-1 of the scope's path names and the scope's
    ``params`` counter (which counts its ``self.param`` calls from 1);
  * the initializers of the JAX models (``lecun_normal``, ``embed_normal``,
    ``normal_init``, ``xavier_uniform``, ``zeros``, ``ones``, ``constant``)
    and ``init_from_seed``, which draws every leaf of a port model in Flax's
    layout and loads it through ``bridge.load_flax_params`` (``build``:
    a fresh model with that init).

Everything is computed on the host, so an init is one and the same whatever
the device, and uses only IEEE operations (no libm call), so it is one and
the same whatever numpy. The normal draws are bit-equal to the JAX package's
on the CPU (``tests/test_torch_flax_init.py``); ``fma`` rounds twice where
the sum lands on a float32 midpoint, which it detects and corrects.

XLA folds a jitted ``normal(key) * std`` into ``erf_inv(u) * (sqrt(2) *
std)``, and an eager one multiplies by ``sqrt(2)`` first: ``jitted`` says
which one the JAX site ran (``jax.jit(model.init)`` or ``model.init``).
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Mapping

import numpy as np
import torch
from torch import nn

from recsys_tpu_torch.bridge import load_flax_params, torch_to_flax

F32 = np.float32
U32 = np.uint32
CHUNK = 1 << 16   # elements drawn at a time: a chunk's arrays stay in the core's cache
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

# erf(-2 / sqrt(2)) and erf(2 / sqrt(2)) - erf(-2 / sqrt(2)) in float32, as
# XLA evaluates them for ``truncated_normal(-2, 2)``
ERF_LO = F32(-0.954499722)
ERF_RANGE = F32(1.90899944)
SQRT2 = F32(np.sqrt(2))
TRUNC_STD = 0.87962566103423978   # sd of a standard normal truncated to (-2, 2)


# -- threefry and keys -----------------------------------------------------------------

def threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds on counter words ``x0``, ``x1`` (uint32)."""
    ks = (U32(k0), U32(k1), U32(k0) ^ U32(k1) ^ U32(0x1BD11BDA))
    x0 = np.array(x0, U32, ndmin=1) + ks[0]
    x1 = np.array(x1, U32, ndmin=1) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = (x1 << U32(r)) | (x1 >> U32(32 - r))
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as the JAX package runs it (64-bit types
    off): the seed's low 32 bits, high word 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], U32)


def _counters(start: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    idx = np.arange(start, start + n, dtype=np.uint64)
    return (idx >> np.uint64(32)).astype(U32), idx.astype(U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) keys."""
    y0, y1 = threefry2x32(k[0], k[1], *_counters(0, num))
    return np.stack([y0, y1], axis=1)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in`` with a 32-bit ``data``."""
    y0, y1 = threefry2x32(k[0], k[1], U32(0), U32(int(data) & 0xFFFFFFFF))
    return np.array([y0[0], y1[0]], U32)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits``: uint32 of ``shape``, drawn ``CHUNK`` at a time."""
    n = int(np.prod(shape, dtype=np.int64))
    out = np.empty(n, U32)
    for start in range(0, n, CHUNK):
        y0, y1 = threefry2x32(k[0], k[1], *_counters(start, min(CHUNK, n - start)))
        np.bitwise_xor(y0, y1, out=out[start:start + len(y0)])
    return out.reshape(shape)


# -- XLA's float32 arithmetic ------------------------------------------------------------

def fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as the fused multiply-add of XLA's
    CPU program. The product is exact in float64; where the float64 sum lands
    on a float32 midpoint its rounding error decides the direction."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = np.asarray(p + c)
    tie = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)
    if tie.any():
        p, c, st = np.broadcast_to(p, s.shape)[tie], np.broadcast_to(c, s.shape)[tie], s[tie]
        t = st - p
        err = (p - (st - t)) + (c - t)
        s[tie] = np.where(err == 0, st, np.nextafter(st, np.where(err > 0, np.inf, -np.inf)))
    return s.astype(F32)


_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def log(v: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` (Cephes) for positive finite ``v``."""
    v = np.maximum(np.asarray(v, F32), np.array(0x00800000, U32).view(F32))
    b = v.view(U32)
    e = F32(1) + ((b >> U32(23)).astype(np.int32) - 0x7F).astype(F32)
    m = ((b & U32(0x807FFFFF)) | U32(0x3F000000)).view(F32)
    low = m < F32(0.707106781186547524)
    x = (m - F32(1)) + np.where(low, m, F32(0))
    e = e - np.where(low, F32(1), F32(0))
    x2 = x * x
    x3 = x2 * x
    p = [F32(c) for c in _LOG_P]
    y, y1, y2 = fma(x, p[0], p[1]), fma(x, p[3], p[4]), fma(x, p[6], p[7])
    y, y1, y2 = fma(y, x, p[2]), fma(y1, x, p[5]), fma(y2, x, p[8])
    y = fma(fma(fma(y, x3, y1), x3, y2), x3, F32(-2.12194440e-4) * e)
    return fma(F32(0.693359375), e, fma(F32(-0.5), x2, x) + y)


def log1p(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p`` for x > -1 (each branch computed where it
    is taken)."""
    x = np.asarray(x, F32)
    out = np.empty_like(x)
    small = np.abs(x) < F32(0.41421356237309504880)
    xs = x[small]
    num = np.zeros_like(xs)
    den = np.zeros_like(xs)
    for c in _LOG1P_NUM:
        num = fma(num, xs, F32(c))
    for c in _LOG1P_DEN:
        den = fma(den, xs, F32(c))
    x2 = xs * xs
    out[small] = xs + fma(F32(-0.5), x2, (xs * x2) * (num / den))
    out[~small] = log(x[~small] + F32(1))
    return out


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv``: a 9-term polynomial in ``w - 2.5`` for
    ``w = -log1p(-x^2) < 5``, else in ``sqrt(w) - 3``; +-inf at +-1."""
    x = np.asarray(x, F32)
    w = -log1p(x * -x)
    lt = w < F32(5)
    w = np.where(lt, w - F32(2.5), np.sqrt(w) - F32(3))
    p = np.where(lt, F32(_ERFINV_LT5[0]), F32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, w, np.where(lt, F32(a), F32(b)))
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == F32(1), x * F32(np.inf), p * x)


# -- distributions ---------------------------------------------------------------------

def _unit_floats(k: np.ndarray, shape) -> np.ndarray:
    """[0, 1) with 23 random mantissa bits, as ``jax.random.uniform`` forms them."""
    return ((random_bits(k, shape) >> U32(9)) | U32(0x3F800000)).view(F32) - F32(1)


def uniform(k: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` called on its own: ``max(minval, f * (maxval -
    minval) + minval)``, the multiply-add fused (by a power of two the product
    is exact, and the plain multiply-add rounds once too). Inside a larger
    jitted program XLA may fold constant bounds otherwise; the initializers
    draw only over (-1, 1), where every form gives the same bits."""
    lo, hi = F32(minval), F32(maxval)
    f = _unit_floats(k, shape)
    if np.frexp(hi - lo)[0] == 0.5:
        return np.maximum(lo, f * (hi - lo) + lo)
    return np.maximum(lo, fma(f, hi - lo, lo))


def _chunked(k: np.ndarray, shape, transform: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """``transform`` of ``_unit_floats`` over ``shape``, CHUNK elements at a time
    (the float64 arithmetic of ``fma`` stays bounded)."""
    f = _unit_floats(k, shape).reshape(-1)
    for start in range(0, f.size, CHUNK):
        f[start:start + CHUNK] = transform(f[start:start + CHUNK])
    return f.reshape(shape)


def _normal_erf_inv(k: np.ndarray, shape) -> np.ndarray:
    """``erf_inv(u)`` of ``jax.random.normal``'s uniform over (-1, 1)."""
    lo = np.nextafter(F32(-1), F32(0))
    return _chunked(k, shape, lambda f: erf_inv(np.maximum(lo, f * F32(2) + lo)))


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal``: ``sqrt(2) * erf_inv(u)``."""
    return SQRT2 * _normal_erf_inv(k, shape)


def truncated_normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.truncated_normal(k, -2, 2, shape)``."""
    def draw(f):
        u = np.maximum(ERF_LO, fma(f, ERF_RANGE, ERF_LO))
        return np.clip(SQRT2 * erf_inv(u), np.nextafter(F32(-2), F32(0)),
                       np.nextafter(F32(2), F32(0)))
    return _chunked(k, shape, draw)


# -- Flax's keys and initializers --------------------------------------------------------

def param_key(root: np.ndarray, path: tuple[str, ...], counter: int) -> np.ndarray:
    """The key Flax gives the ``counter``-th ``self.param`` of the scope at
    ``path`` under ``root`` (names and counter hashed with no separator)."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


Init = Callable[[np.ndarray, tuple, bool], np.ndarray]


def _fans(shape: tuple, in_axis: int, out_axis: int) -> tuple[float, float]:
    """``jax.nn.initializers._compute_fans`` for one in and one out axis."""
    in_size, out_size = shape[in_axis], shape[out_axis]
    receptive = math.prod(shape) / in_size / out_size
    return in_size * receptive, out_size * receptive


def lecun_normal(k: np.ndarray, shape: tuple, jitted: bool) -> np.ndarray:
    """Flax's default kernel init on a 2-D (flattened) kernel."""
    std = np.sqrt(F32(1.0 / _fans(shape, -2, -1)[0])) / F32(TRUNC_STD)
    return truncated_normal(k, shape) * std


def embed_normal(k: np.ndarray, shape: tuple, jitted: bool) -> np.ndarray:
    """``nn.Embed``'s default: normal with std 1 / sqrt(features)."""
    std = np.sqrt(F32(1.0 / _fans(shape, -2, 0)[0]))
    return _scaled_normal(k, shape, std, jitted)


def normal_init(std: float) -> Init:
    """``nn.initializers.normal(std)``."""
    return lambda k, shape, jitted: _scaled_normal(k, shape, F32(std), jitted)


def _scaled_normal(k: np.ndarray, shape: tuple, std: np.float32, jitted: bool) -> np.ndarray:
    if jitted:
        return _normal_erf_inv(k, shape) * (SQRT2 * std)
    return normal(k, shape) * std


def xavier_uniform(k: np.ndarray, shape: tuple, jitted: bool) -> np.ndarray:
    fan_in, fan_out = _fans(shape, -2, -1)
    return uniform(k, shape, -1.0, 1.0) * np.sqrt(F32(3) * F32(1.0 / ((fan_in + fan_out) / 2)))


def zeros(k: np.ndarray, shape: tuple, jitted: bool) -> np.ndarray:
    return np.zeros(shape, F32)


def ones(k: np.ndarray, shape: tuple, jitted: bool) -> np.ndarray:
    return np.ones(shape, F32)


def constant(value) -> Init:
    return lambda k, shape, jitted: np.full(shape, value, F32)


# Raw parameters (``self.param`` outside Dense / LayerNorm / Embed) by the
# class of the module that holds them and their name: (initializer, the order
# of the call in the Flax module's setup or __call__), from the JAX package's
# ``recsys_tpu/models/`` file and line named beside each. Dense and
# DenseGeneral (kernel 1, bias 2), LayerNorm (scale 1, bias 2) and Embed
# (embedding 1) need no entry.
PARAM_RULES: dict[tuple[str, str], tuple[Init, int]] = {
    ("HybridItemTower", "std_field_embedding"): (normal_init(0.02), 1),   # item_tower.py:49
    ("HybridItemTower", "re_field_embedding"): (normal_init(0.02), 2),    # item_tower.py:65
    ("HashTextEncoder", "pos_embedding"): (normal_init(0.02), 1),         # text_encoder.py:42
    ("PretrainedTextEncoder", "pretrained_embedding"): (normal_init(0.02), 1),  # :82
    ("PretrainedTextEncoder", "pos_embedding"): (normal_init(0.02), 2),   # text_encoder.py:86
    ("SASRecItemTower", "item_matrix"): (normal_init(0.02), 1),           # user_tower.py:44
    ("SASRecUserTower", "seq_gate"): (zeros, 1),                          # user_tower.py:72
    ("SASRecUserTower", "pos_embedding"): (normal_init(0.02), 2),         # user_tower.py:74
    ("SASRecUserTower", "static_gate"): (zeros, 3),                       # user_tower.py:90
    ("ResidualAdapter", "gate"): (constant(2.0), 1),                      # hybrid_tower.py:41
    ("SequenceCentricFusion", "gate_gnn"): (constant(-5.0), 1),           # hybrid_tower.py:68
    ("SequenceCentricFusion", "gate_meta"): (constant(-5.0), 2),          # hybrid_tower.py:70
    ("HybridUserTower", "pos_embedding"): (normal_init(0.02), 1),         # hybrid_tower.py:95
    ("HybridUserTower", "logit_scale"): (constant(log(F32(1 / 0.07))), 2),  # :103
    ("LightGCL", "user_emb"): (xavier_uniform, 1),                        # lightgcl.py:46
    ("LightGCL", "item_emb"): (xavier_uniform, 2),                        # lightgcl.py:47
    ("MagnitudeEncoder", "logit_scale"): (constant(log(F32(10.0))), 1),   # lightgcl.py:112
    ("DeepFM", "bias"): (zeros, 1),                                       # reranker.py:86
}


def _leaf_rule(node: Mapping, name: str, owner: str) -> tuple[Init, int]:
    if (owner, name) in PARAM_RULES:
        return PARAM_RULES[(owner, name)]
    if name == "kernel":
        return lecun_normal, 1
    if name == "bias" and ("kernel" in node or "scale" in node):
        return zeros, 2
    if name == "scale":
        return ones, 1
    if name == "embedding":
        return embed_normal, 1
    raise KeyError(f"no init rule for {owner}'s parameter {name!r}")


def _flat_kernel_shape(path: tuple[str, ...], shape: tuple) -> tuple:
    """Flax draws a DenseGeneral kernel at its 2-D shape: attention's
    (in, H, hd) query / key / value kernels at (in, H*hd), (H, hd, out) out
    kernels at (H*hd, out)."""
    if len(shape) != 3:
        return shape
    if path[-1] == "out":
        return (shape[0] * shape[1], shape[2])
    return (shape[0], shape[1] * shape[2])


def init_from_seed(model: nn.Module, root: np.ndarray, *, jitted: bool = True) -> nn.Module:
    """Load into ``model`` the parameters Flax's ``init`` of its JAX twin
    draws from the key ``root`` (every leaf, in Flax's layout, from its own
    key); ``jitted``: the JAX site jits ``model.init``. Returns ``model``."""
    owners = {name: type(m).__name__ for name, m in model.named_modules()}

    def draw(node: Mapping, path: tuple[str, ...]) -> dict:
        out = {}
        for name, value in node.items():
            if isinstance(value, Mapping):
                out[name] = draw(value, path + (name,))
                continue
            init, counter = _leaf_rule(node, name, owners[".".join(path)])
            shape = _flat_kernel_shape(path, value.shape) if name == "kernel" else value.shape
            leaf = init(param_key(root, path, counter), tuple(shape), jitted)
            out[name] = leaf.reshape(value.shape)
        return out

    with torch.no_grad():
        return load_flax_params(model, draw(torch_to_flax(model), ()))


def build(make: Callable[[], nn.Module], root: np.ndarray | None, *,
          jitted: bool = True) -> nn.Module:
    """``make()`` with the JAX package's init for ``root`` in place of the
    module's own, whose draws leave torch's global generator as they found it.
    ``root`` None: no draw, for a caller that loads every parameter next."""
    with torch.random.fork_rng(devices=[]):
        model = make()
    return model if root is None else init_from_seed(model, root, jitted=jitted)
