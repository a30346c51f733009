"""In-kernel counter-based RNG for the census kernel.

Every draw is a murmur3-finalizer hash of (seed, lane, iteration, call-site
tag): stateless, so a lane's stream depends only on its global slot and the
loop iteration, never on how lanes are grouped into blocks — the analog of the
reference's per-thread ``XorShift64`` pool (``rng.hpp``).

``DrawPool`` serves uniform variates with minimal hash count:

* ``u23(it)`` burns a full 32-bit word for a 23-bit-mantissa uniform — used
  for the exponential distance/time draws, where tail resolution matters
  (``exp23`` wraps the -log);
* ``u16(it)`` packs TWO 16-bit variates per word (angles, in-cell positions —
  smooth transforms where 1.5e-5 resolution is far below Monte Carlo noise),
  halving the hash count on those call sites.

u16 MUST NOT feed probability-THRESHOLD tests (``u < p``): the comparison
quantizes p to multiples of 1/65536, so rare branches (p ≲ 1e-4 — e.g. the
absorption fraction sigma_a/sigma_t in scattering-dominated cells, DDMC
albedo acceptance at large sigma_t*dx, the DDMC event selector) inherit O(1)
relative bias — P(u16 < 1e-5) = 1/65536, +53%. Threshold draws use ``u23``
(granularity 1.2e-7); ``tests/test_pallas.py::test_rare_absorption_unbiased``
is the regression gate.

The pool is a Python-side trace helper: the census loop body is traced once,
so each call site gets a fixed word/half assignment and a fixed tag. Create
ONE pool per traced loop body.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Python float, NOT a jnp constant: module-level jax arrays would be traced
# as captured constants by pallas_call (rejected); a literal folds in-place.
_TINY = 1.0e-37


def make_raw_bits(n, seed_scalar, lane_offset):
    """Build the (it, tag) -> u32[n] bits source for one block of ``n`` lanes.

    ``seed_scalar``: i32/u32 scalar; ``lane_offset``: the global slot of the
    block's first lane (static int or traced i32 scalar)."""
    lane = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    lane_id = (lane + lane_offset).astype(jnp.uint32)
    seed_u = jnp.asarray(seed_scalar).astype(jnp.uint32)

    def raw_bits(it, tag):
        x = (
            seed_u
            + lane_id
            + it.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
            + jnp.uint32((tag * 0x85EBCA6B) & 0xFFFFFFFF)
        )
        x = x ^ (x >> 16)
        x = x * jnp.uint32(0x7FEB352D)
        x = x ^ (x >> 15)
        x = x * jnp.uint32(0x846CA68B)
        x = x ^ (x >> 16)
        return x

    return raw_bits


def _bits_to_unit(bits, n):
    """The low ``n`` bits of ``bits`` (u32) as a uniform on [0, 1)."""
    return (bits & ((1 << n) - 1)).astype(jnp.int32).astype(jnp.float32) * (
        1.0 / (1 << n)
    )


class DrawPool:
    """See module docstring. One instance per traced loop body."""

    def __init__(self, raw_bits):
        self._raw = raw_bits
        self._tag = 0
        self._spare = None

    def _bits(self, it):
        b = self._raw(it, self._tag)
        self._tag += 1
        return b

    def u23(self, it):
        return _bits_to_unit(self._bits(it) >> 9, 23)

    def u16(self, it):
        if self._spare is not None:
            u, self._spare = self._spare, None
            return u
        b = self._bits(it)
        self._spare = _bits_to_unit(b >> 16, 16)
        return _bits_to_unit(b, 16)

    def exp23(self, it):
        return -jnp.log(jnp.maximum(self.u23(it), _TINY))

    def circle(self, it):
        """(cos phi, sin phi) for phi ~ U[0, 2pi) from ONE word, with a single
        transcendental: c = cos(pi*u) over a 23-bit u covers (-1, 1] with
        exactly the arccos density of the cosine of a uniform angle, and
        |sin| = sqrt(1 - c^2) takes its sign from an independent raw bit."""
        b = self._bits(it)
        u = _bits_to_unit(b >> 9, 23)
        ch = jnp.cos(3.14159265358979 * u)
        sh = jnp.sqrt(jnp.maximum(1.0 - ch * ch, 0.0))
        return ch, jnp.where((b & 1) != 0, -sh, sh)
