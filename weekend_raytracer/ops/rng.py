"""Counter/hash RNG: vectorized Jenkins-seeded PCG on uint32 lanes.

Capability parity with the reference's per-pixel-per-frame deterministic RNG
(raytracer.wgsl:498-521: ``initRng`` = jenkinsHash(pixel_index ^
jenkinsHash(frame)), ``rngNextInt`` = one PCG output-permutation step). The
reference threads one u32 state per fragment; here every pixel lane carries
its own u32 state as an element of a state array, so the exact same integer
recurrence runs vectorized — and identically in jitted XLA, in
Pallas kernels, and in NumPy (the test oracle).

Deviation from the reference (documented): floats are derived from the top
24 bits (``(state >> 8) * 2^-24``) instead of ``f32(state)/f32(0xffffffff)``
— same distribution, exact in f32, and needs only a signed int->float
conversion.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_INV_2_24 = float(1.0 / (1 << 24))


def jenkins_hash(x: jnp.ndarray) -> jnp.ndarray:
    """Jenkins one-at-a-time finalizer (raytracer.wgsl:513-521)."""
    x = jnp.asarray(x, dtype=jnp.uint32)
    x = x + (x << 10)
    x = x ^ (x >> 6)
    x = x + (x << 3)
    x = x ^ (x >> 11)
    x = x + (x << 15)
    return x


def init_state(pixel_index: jnp.ndarray, frame: jnp.ndarray) -> jnp.ndarray:
    """Seed per-lane states (raytracer.wgsl:498-502).

    pixel_index = x + y * width (the reference's dot(pixel, (1, width))).
    """
    pixel_index = jnp.asarray(pixel_index, dtype=jnp.uint32)
    frame = jnp.asarray(frame, dtype=jnp.uint32)
    return jenkins_hash(pixel_index ^ jenkins_hash(frame))


GOLDEN = 0x9E3779B9  # 2^32 / golden ratio: odd, full-period sample stride


def init_sample_state(
    pixel_index: jnp.ndarray, frame: jnp.ndarray, sample
) -> jnp.ndarray:
    """Seed for one (pixel, frame, sample) draw stream.

    Unlike the reference's carried stream (one seed per pixel per frame,
    samples drawing sequentially, wgsl:498-502 + 113-119), each sample gets
    an independent seed. A path's draws then depend only on its own bounce
    index — bit-identical across the XLA scan, the fused GPU kernel
    (a block's early bounce exit cannot shift later samples' draws), and
    the NumPy oracle.
    """
    pixel_index = jnp.asarray(pixel_index, dtype=jnp.uint32)
    frame = jnp.asarray(frame, dtype=jnp.uint32)
    mix = jnp.uint32(GOLDEN) * (jnp.asarray(sample, jnp.uint32) + jnp.uint32(1))
    return jenkins_hash(pixel_index ^ jenkins_hash(frame) ^ mix)


def next_state(state: jnp.ndarray) -> jnp.ndarray:
    """One PCG step (raytracer.wgsl:504-511); returns the new state."""
    old = state + jnp.uint32(747796405) + jnp.uint32(2891336453)
    shift = (old >> 28) + jnp.uint32(4)
    word = ((old >> shift) ^ old) * jnp.uint32(277803737)
    return (word >> 22) ^ word


def next_float(state: jnp.ndarray):
    """Advance and return (new_state, uniform f32 in [0, 1))."""
    state = next_state(state)
    # Top 24 bits; bitcast to int32 (sign bit is clear after >> 8) so the
    # float conversion is a signed one.
    top = jax.lax.bitcast_convert_type(state >> 8, jnp.int32)
    value = top.astype(jnp.float32) * jnp.float32(_INV_2_24)
    return state, value


def next_floats(state: jnp.ndarray, n: int):
    """Advance n times; returns (new_state, tuple of n f32 arrays)."""
    outs = []
    for _ in range(n):
        state, v = next_float(state)
        outs.append(v)
    return state, tuple(outs)
