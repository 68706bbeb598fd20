"""Spatial acceleration: morton-ordered sphere chunks.

The reference brute-forces every sphere per ray (raytracer.wgsl:137-145).
To scale to the BASELINE.md 10k-sphere configs, the rebuild uses the
a tile-granular analogue of an LBVH: spheres are sorted along a Morton curve
and grouped into fixed-size chunks; each chunk (and, for large scenes, each
super-chunk of chunks) carries a conservative bounding sphere. Kernels test
a whole ray *tile* against a chunk bound with a handful of vector ops and
skip the chunk's spheres entirely when no lane can hit — data-independent
control flow at tile granularity instead of per-ray stack traversal
(SURVEY.md §7 hard part (f)). No render path reads these chunks yet; they
are the starting point of a culling pass (ROADMAP R2).

Everything here is pure jnp (runs under jit, on device): a pointer-free,
sort-based "LBVH build" in the spirit of Karras 2012 but flattened to two
levels because tile-granularity culling makes deep trees unprofitable on
SIMD tiles.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp


def _part1by2(x: jnp.ndarray) -> jnp.ndarray:
    """Spread 10 bits out to every 3rd bit (standard Morton interleave)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(
    cx: jnp.ndarray, cy: jnp.ndarray, cz: jnp.ndarray,
    lo: jnp.ndarray, hi: jnp.ndarray,
) -> jnp.ndarray:
    """30-bit Morton codes for points quantized into [lo, hi]^3."""
    span = jnp.maximum(hi - lo, 1e-6)
    q = lambda v, i: jnp.clip(
        ((v - lo[i]) / span[i] * 1024.0), 0.0, 1023.0
    ).astype(jnp.uint32)
    return (
        _part1by2(q(cx, 0))
        | (_part1by2(q(cy, 1)) << 1)
        | (_part1by2(q(cz, 2)) << 2)
    )


class ChunkedScene(NamedTuple):
    """Morton-sorted per-sphere attributes + per-chunk AABBs.

    attrs: tuple of 12 (S_pad,) f32 arrays (cx, cy, cz, rad, mid, mx,
           a1r, a1g, a1b, a2r, a2g, a2b), sorted and padded by duplicating
           the last sphere (duplicates are harmless for closest-hit).
    bounds: 6 (NC,) f32 arrays (lox, loy, loz, hix, hiy, hiz). AABBs beat
            bounding spheres decisively for flat sphere fields: a grazing
            ray stays outside a thin y-slab until near its hit point,
            where it would pass within a fat bounding sphere's radius for
            most of its flight.
    """

    attrs: Tuple[jnp.ndarray, ...]
    bounds: Tuple[jnp.ndarray, ...]


def order_front_to_back(scene: ChunkedScene, eye: jnp.ndarray,
                        chunk_size: int) -> ChunkedScene:
    """Reorder whole chunks by distance from the camera eye.

    Closest-hit sweeps visit chunks in array order; putting near chunks
    first tightens each lane's best-t early, so later (farther) chunk
    bounds fail the `t_near < best_t` cull. Pure permutation — results are
    identical, only the amount of skipped work changes. Runs under jit in
    the render step (as does the whole chunk build: a sort + gathers over
    the sphere arrays, sub-millisecond even at 10k spheres and so left in
    the per-frame trace rather than cached across the jit boundary).
    """
    lox, loy, loz, hix, hiy, hiz = scene.bounds
    cx = 0.5 * (lox + hix)
    cy = 0.5 * (loy + hiy)
    cz = 0.5 * (loz + hiz)
    d2 = (cx - eye[0]) ** 2 + (cy - eye[1]) ** 2 + (cz - eye[2]) ** 2
    order = jnp.argsort(d2)
    sphere_order = (order[:, None] * chunk_size
                    + jnp.arange(chunk_size)[None, :]).reshape(-1)
    return ChunkedScene(
        attrs=tuple(a[sphere_order] for a in scene.attrs),
        bounds=tuple(b[order] for b in scene.bounds),
    )


def super_bounds(scene: ChunkedScene, super_factor: int):
    """Level-2 AABBs over groups of ``super_factor`` chunks.

    Returns (chunk_bounds_padded, super_bounds): 6 (NCP,) and 6 (NSC,)
    arrays; chunk count is padded to a multiple of super_factor with
    unhittable boxes (lo > hi at a far location).
    """
    nc = scene.bounds[0].shape[0]
    pad = (-nc) % super_factor
    # Pad with a ZERO-EXTENT box at a far point (lo == hi == +1e9), NOT an
    # inverted box: the kernel's slab test sorts each axis pair with
    # min/max, which would normalize an inverted box into an infinite one
    # that always passes — and its sweep would then read sphere attributes
    # past the end of the arrays. A far degenerate box fails the
    # `t_near < best_t` check for every ray (best_t <= MAX_T << 1e9/|d|).
    far = 1.0e9
    padded = tuple(
        jnp.concatenate([b, jnp.full((pad,), far)]) for b in scene.bounds
    )
    nsc = (nc + pad) // super_factor
    g = lambda a: a.reshape(nsc, super_factor)
    supers = tuple(
        [g(b).min(axis=1) for b in padded[:3]]
        + [g(b).max(axis=1) for b in padded[3:]]
    )
    return padded, supers


def build_chunks(attrs: Tuple[jnp.ndarray, ...], chunk_size: int) -> ChunkedScene:
    """Sort spheres along the Morton curve and bound fixed-size chunks.

    Quantization bounds use inner percentiles so a huge ground sphere
    (center far outside the cluster, e.g. (0,-1000,0) in the RTiOW scene)
    doesn't collapse everyone else's codes; outliers just land in edge
    cells and their chunk bound grows to cover them (that chunk is then
    simply never culled — correct, and cheap because it's one chunk).
    """
    cx, cy, cz, rad = attrs[0], attrs[1], attrs[2], attrs[3]
    lo = jnp.stack([
        jnp.percentile(cx, 5), jnp.percentile(cy, 5), jnp.percentile(cz, 5)
    ])
    hi = jnp.stack([
        jnp.percentile(cx, 95), jnp.percentile(cy, 95), jnp.percentile(cz, 95)
    ])
    codes = morton_codes(cx, cy, cz, lo, hi)
    order = jnp.argsort(codes)
    attrs = tuple(a[order] for a in attrs)

    s = attrs[0].shape[0]
    pad = (-s) % chunk_size
    if pad:
        attrs = tuple(
            jnp.concatenate([a, jnp.broadcast_to(a[-1], (pad,))]) for a in attrs
        )
    cx, cy, cz, rad = attrs[0], attrs[1], attrs[2], attrs[3]
    nc = cx.shape[0] // chunk_size
    g = lambda a: a.reshape(nc, chunk_size)
    gx, gy, gz = g(cx), g(cy), g(cz)
    # |rad|: negative radii (hollow-glass shells) still bound by magnitude
    gr = jnp.abs(g(rad))
    bounds = (
        (gx - gr).min(axis=1), (gy - gr).min(axis=1), (gz - gr).min(axis=1),
        (gx + gr).max(axis=1), (gy + gr).max(axis=1), (gz + gr).max(axis=1),
    )
    return ChunkedScene(attrs=attrs, bounds=bounds)
