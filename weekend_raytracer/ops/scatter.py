"""Material scatter: branchless vectorized evaluation of all material models.

Capability parity with the reference's ``scatterRay`` material switch and the
five scatter functions (raytracer.wgsl:174-314): lambertian (cosine-weighted
hemisphere sampling through a Pixar orthonormal basis, wgsl:204-242), metal
(mirror + fuzz, wgsl:244-248), dielectric (refract/Schlick-reflect,
wgsl:250-298), checkerboard (3D-sine parity choosing between two lambertian
albedos, wgsl:300-307), and the aggressive-pink missing-material signal
(wgsl:309-314).

Data-parallel formulation: the reference's per-fragment ``switch`` becomes
evaluate-all-branches + one-hot select (the 4-way "expert" branch of
SURVEY.md §2). Every branch is a handful of elementwise ops, so masked
evaluation beats divergent control flow.

Intentional fixes relative to reference bugs (SURVEY.md §8 — match intent,
not the bug):
 - dielectric reflection branch actually assigns the reflected direction
   (wgsl:269-271 discards it);
 - Schlick uses the canonical r0 + (1 - r0)(1 - cos)^5 (wgsl:294-298 has
   pow((1-r0)(1-cos), 5));
 - unit-sphere sampling uses cos(theta) = 1 - 2u (wgsl:480-491 is
   pole-biased);
 - fuzz perturbs the *normalized* reflected direction (the reference
   perturbs an unnormalized one, making fuzz depend on ray length).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from ..models.materials import (
    CHECKERBOARD,
    DIELECTRIC,
    EMISSIVE,
    ERROR_PINK,
    LAMBERTIAN,
    METAL,
    MaterialTable,
)

_EPSILON = 1.0e-3  # raytracer.wgsl:1
_PI = 3.14159265358979
_FRAC_1_PI = 1.0 / _PI


class ScatterResult(NamedTuple):
    direction: jnp.ndarray  # [N, 3] unit
    albedo: jnp.ndarray  # [N, 3] throughput multiplier
    emission: jnp.ndarray  # [N, 3] radiance for terminating (emissive) hits
    terminate: jnp.ndarray  # [N] bool: path ends at this hit (area light)


def texture_lookup(
    desc: jnp.ndarray,  # i32 [N, 3] (width, height, offset)
    u: jnp.ndarray,
    v: jnp.ndarray,
    pool: jnp.ndarray,  # f32 [P, 3]
) -> jnp.ndarray:
    """Nearest-texel pool gather (textureLookup, wgsl:377-387).

    Clamps the texel index to the image bounds (the reference's u32 cast can
    index one past the edge at u == 1; clamping is the intended behavior).
    """
    w = desc[:, 0]
    h = desc[:, 1]
    off = desc[:, 2]
    uu = jnp.clip(u, 0.0, 1.0)
    vv = 1.0 - jnp.clip(v, 0.0, 1.0)
    j = jnp.minimum((uu * w.astype(jnp.float32)).astype(jnp.int32), w - 1)
    i = jnp.minimum((vv * h.astype(jnp.float32)).astype(jnp.int32), h - 1)
    idx = off + i * w + j
    return pool[idx]


def pixar_onb(n: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Branchless orthonormal basis from a unit normal (pixarOnb, wgsl:233-242,
    after Duff et al. 2017). Returns tangents (u [N,3], v [N,3])."""
    s = jnp.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    u = jnp.stack(
        [1.0 + s * n[:, 0] * n[:, 0] * a, s * b, -s * n[:, 0]], axis=-1
    )
    v = jnp.stack([b, s + n[:, 1] * n[:, 1] * a, -n[:, 1]], axis=-1)
    return u, v


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    return d - 2.0 * jnp.sum(d * n, axis=-1, keepdims=True) * n


def unit_sphere_sample(u1, u2, u3) -> jnp.ndarray:
    """Uniform point in the unit ball: r ~ u^(1/3), cos(theta) = 1 - 2u."""
    r = jnp.cbrt(u1)
    cos_t = 1.0 - 2.0 * u2
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = (2.0 * _PI) * u3
    return jnp.stack(
        [r * sin_t * jnp.cos(phi), r * sin_t * jnp.sin(phi), r * cos_t], axis=-1
    )


def cosine_hemisphere_dir(n: jnp.ndarray, r1, r2) -> jnp.ndarray:
    """Cosine-weighted hemisphere direction about n (sampleLambertian,
    wgsl:214-227): z = sqrt(1 - r2), (x, y) on the sqrt(r2) circle."""
    sqrt_r2 = jnp.sqrt(r2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - r2))
    phi = (2.0 * _PI) * r1
    x = jnp.cos(phi) * sqrt_r2
    y = jnp.sin(phi) * sqrt_r2
    tu, tv = pixar_onb(n)
    return x[:, None] * tu + y[:, None] * tv + z[:, None] * n


def _lambertian_throughput(n, wi, albedo):
    """eval/pdf ratio computed as the reference does (wgsl:204-231):
    (albedo/pi * max(eps, n.wi)) / max(eps, n.wi/pi)."""
    ndotwi = jnp.sum(n * wi, axis=-1)
    ev = _FRAC_1_PI * jnp.maximum(_EPSILON, ndotwi)
    pdf = jnp.maximum(_EPSILON, ndotwi * _FRAC_1_PI)
    return albedo * (ev / pdf)[:, None]


def _schlick(cosine, ior):
    r0 = (1.0 - ior) / (1.0 + ior)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * jnp.power(1.0 - cosine, 5.0)


def scatter(
    d: jnp.ndarray,  # [N, 3] unit incoming direction
    n: jnp.ndarray,  # [N, 3] outward hit normal
    p: jnp.ndarray,  # [N, 3] hit point (checkerboard parity; origin for all)
    u: jnp.ndarray,  # [N] spherical u
    v: jnp.ndarray,  # [N] spherical v
    mat_idx: jnp.ndarray,  # [N] i32 per-lane material index
    table: MaterialTable,
    rands: Tuple[jnp.ndarray, ...],  # 4 uniform [N] draws (r1, r2, r3, r4)
) -> ScatterResult:
    """Evaluate all material branches and select per lane by material id."""
    r1, r2, r3, r4 = rands
    mid = table.ids[mat_idx]  # [N] material model id
    x = table.x[mat_idx]  # [N] fuzz / ior
    tex1 = table.tex1[mat_idx]  # [N, 3]
    tex2 = table.tex2[mat_idx]

    albedo1 = texture_lookup(tex1, u, v, table.pool)
    albedo2 = texture_lookup(tex2, u, v, table.pool)

    # --- lambertian / checkerboard / missing share the diffuse direction ---
    diffuse_dir = cosine_hemisphere_dir(n, r1, r2)
    sphere_pt = unit_sphere_sample(r1, r2, r3)

    # checkerboard parity (wgsl:300-307)
    sines = jnp.sin(5.0 * p[:, 0]) * jnp.sin(5.0 * p[:, 1]) * jnp.sin(5.0 * p[:, 2])
    checker_albedo = jnp.where((sines < 0.0)[:, None], albedo1, albedo2)

    lam_thr = _lambertian_throughput(n, diffuse_dir, albedo1)
    chk_thr = _lambertian_throughput(n, diffuse_dir, checker_albedo)

    # --- metal (wgsl:244-248) ---
    refl = reflect(d, n)
    metal_dir = refl + x[:, None] * sphere_pt
    metal_thr = albedo1

    # --- dielectric (wgsl:250-298, with intent fixes) ---
    ddotn = jnp.sum(d * n, axis=-1)
    front = ddotn < 0.0
    outward_n = jnp.where(front[:, None], n, -n)
    eta = jnp.where(front, 1.0 / x, x)
    cosine = jnp.where(front, -ddotn, x * ddotn)
    dt = jnp.sum(d * outward_n, axis=-1)
    disc = 1.0 - eta * eta * (1.0 - dt * dt)
    can_refract = disc > 0.0
    refr = eta[:, None] * (d - dt[:, None] * outward_n) - jnp.sqrt(
        jnp.maximum(disc, 0.0)
    )[:, None] * outward_n
    reflect_prob = jnp.where(
        can_refract, _schlick(jnp.clip(cosine, 0.0, 1.0), x), 1.0
    )
    use_reflect = r4 < reflect_prob
    diel_dir = jnp.where(use_reflect[:, None], refl, refr)
    diel_thr = jnp.ones_like(metal_thr)

    # --- missing material (wgsl:309-314) ---
    miss_dir = n + sphere_pt
    miss_thr = jnp.broadcast_to(
        jnp.asarray(ERROR_PINK, dtype=jnp.float32), metal_thr.shape
    )

    # --- select by material id ---
    def sel(id_, yes_dir, yes_thr, no_dir, no_thr):
        m = (mid == id_)[:, None]
        return jnp.where(m, yes_dir, no_dir), jnp.where(m, yes_thr, no_thr)

    direction, thr = miss_dir, miss_thr
    direction, thr = sel(CHECKERBOARD, diffuse_dir, chk_thr, direction, thr)
    direction, thr = sel(DIELECTRIC, diel_dir, diel_thr, direction, thr)
    direction, thr = sel(METAL, metal_dir, metal_thr, direction, thr)
    direction, thr = sel(LAMBERTIAN, diffuse_dir, lam_thr, direction, thr)

    # --- emissive area light: terminate with x * albedo radiance ---
    terminate = mid == EMISSIVE
    emission = x[:, None] * albedo1

    norm = jnp.linalg.norm(direction, axis=-1, keepdims=True)
    direction = direction / jnp.maximum(norm, 1.0e-12)
    return ScatterResult(
        direction=direction, albedo=thr, emission=emission, terminate=terminate
    )
