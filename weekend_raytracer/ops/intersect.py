"""Ray-sphere intersection: vectorized closest-hit over sphere chunks.

Capability parity with the reference's brute-force closest-hit loop
(raytracer.wgsl:137-145 over all spheres, quadratic + nearer/farther root
selection in rayIntersectSphere wgsl:407-429, hit-record derivation with
spherical UVs in sphereIntersection wgsl:431-440).

Data-parallel formulation: instead of a scalar loop per ray, intersection
is a [lanes x chunk] broadcast with a running min-reduction scanned over
sphere chunks — elementwise work with static shapes. Ray directions are unit vectors,
so the quadratic uses a = 1 (the reference divides by dot(d, d) instead;
same geometry).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.spheres import SphereSoA

MIN_T = 1.0e-3  # raytracer.wgsl:7
MAX_T = 1.0e3  # raytracer.wgsl:8

_PI = 3.14159265358979
_FRAC_1_PI = 1.0 / _PI


def _chunk_hit_t(
    o: jnp.ndarray,  # [N, 3]
    d: jnp.ndarray,  # [N, 3]
    centers: jnp.ndarray,  # [C, 3]
    radii: jnp.ndarray,  # [C]
) -> jnp.ndarray:
    """Per-(ray, sphere) hit parameter t in (MIN_T, MAX_T), else MAX_T.

    Root selection mirrors wgsl:414-426: prefer the nearer root, fall back
    to the farther one if the nearer is out of range.
    """
    oc = o[:, None, :] - centers[None, :, :]  # [N, C, 3]
    b = jnp.sum(oc * d[:, None, :], axis=-1)  # [N, C]
    c = jnp.sum(oc * oc, axis=-1) - (radii * radii)[None, :]
    disc = b * b - c
    hit = disc > 0.0
    sq = jnp.sqrt(jnp.where(hit, disc, 0.0))
    t_near = -b - sq
    t_far = -b + sq
    near_ok = hit & (t_near > MIN_T) & (t_near < MAX_T)
    far_ok = hit & (t_far > MIN_T) & (t_far < MAX_T)
    t = jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, MAX_T))
    return t


def intersect(
    o: jnp.ndarray,
    d: jnp.ndarray,
    spheres: SphereSoA,
    chunk_size: int = 512,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closest hit over the whole scene.

    Returns (t [N] f32 — MAX_T on miss, sphere_idx [N] i32, hit [N] bool).
    Scans the sphere array in chunks of ``chunk_size`` to bound the live
    [N, C] intermediate, carrying the running (min-t, argmin) pair.
    """
    n_spheres = spheres.centers.shape[0]
    if n_spheres <= chunk_size:
        t = _chunk_hit_t(o, d, spheres.centers, spheres.radii)  # [N, S]
        best_t = jnp.min(t, axis=-1)
        best_idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
        return best_t, best_idx, best_t < MAX_T

    # Pad to a multiple of chunk_size with unhittable spheres.
    pad = (-n_spheres) % chunk_size
    centers = jnp.concatenate(
        [spheres.centers, jnp.full((pad, 3), 1.0e8, dtype=jnp.float32)], axis=0
    )
    radii = jnp.concatenate([spheres.radii, jnp.zeros((pad,), dtype=jnp.float32)])
    k = centers.shape[0] // chunk_size
    centers = centers.reshape(k, chunk_size, 3)
    radii = radii.reshape(k, chunk_size)

    def body(carry, chunk):
        best_t, best_idx, base = carry
        cc, rr = chunk
        t = _chunk_hit_t(o, d, cc, rr)  # [N, C]
        ct = jnp.min(t, axis=-1)
        ci = jnp.argmin(t, axis=-1).astype(jnp.int32) + base
        better = ct < best_t
        return (
            jnp.where(better, ct, best_t),
            jnp.where(better, ci, best_idx),
            base + chunk_size,
        ), None

    init = (
        jnp.full(o.shape[:1], MAX_T, dtype=jnp.float32),
        jnp.zeros(o.shape[:1], dtype=jnp.int32),
        jnp.int32(0),
    )
    (best_t, best_idx, _), _ = jax.lax.scan(body, init, (centers, radii))
    return best_t, best_idx, best_t < MAX_T


def hit_record(
    o: jnp.ndarray,
    d: jnp.ndarray,
    t: jnp.ndarray,
    sphere_idx: jnp.ndarray,
    spheres: SphereSoA,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Derive (p [N,3], n [N,3], u [N], v [N]) from a closest hit.

    Mirrors sphereIntersection (wgsl:431-440): outward-scaled normal
    (p - c) / r — negative radii flip the normal, the RTiOW hollow-glass
    trick — and spherical UVs u = phi / 2pi, v = theta / pi with
    theta = acos(-n.y), phi = atan2(-n.z, n.x) + pi.
    """
    c = spheres.centers[sphere_idx]  # [N, 3]
    r = spheres.radii[sphere_idx]  # [N]
    p = o + t[:, None] * d
    n = (p - c) / jnp.where(r == 0.0, 1.0, r)[:, None]
    theta = jnp.arccos(jnp.clip(-n[:, 1], -1.0, 1.0))
    phi = jnp.arctan2(-n[:, 2], n[:, 0]) + _PI
    u = 0.5 * _FRAC_1_PI * phi
    v = _FRAC_1_PI * theta
    return p, n, u, v
