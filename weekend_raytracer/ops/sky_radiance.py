"""Sky radiance evaluation: the Hosek-Wilkie-form distribution, vectorized.

Exact reimplementation of the reference shader's ``radiance()``
(raytracer.wgsl:316-343) and its call site on ray miss (wgsl:154-167):
per-channel 9-parameter extended-Perez distribution evaluated at
(theta = angle from zenith, gamma = angle from sun), scaled by a per-channel
radiance. Runs on [N] lane batches; pure jnp so it works inside both the
jitted XLA tracer and Pallas kernels.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..models.sky import SkyState


def sky_radiance(directions: jnp.ndarray, sky: SkyState) -> jnp.ndarray:
    """Radiance [N, 3] for unit ray directions [N, 3] that missed the scene.

    Mirrors raytracer.wgsl:154-167 (theta/gamma setup) and 316-343 (the
    distribution). ``directions`` must be normalized.
    """
    v = directions
    s = sky.sun_direction
    cos_theta_signed = jnp.clip(v[..., 1], -1.0, 1.0)
    theta = jnp.arccos(cos_theta_signed)
    # elementwise, not `v @ s`: an f32 matrix product may run in TF32 on
    # a GPU's tensor cores (~3 decimal digits)
    cos_gamma = jnp.clip(jnp.sum(v * s, axis=-1), -1.0, 1.0)
    gamma = jnp.arccos(cos_gamma)
    return sky_radiance_angles(theta, gamma, sky)


def sky_radiance_angles(theta: jnp.ndarray, gamma: jnp.ndarray, sky: SkyState) -> jnp.ndarray:
    """Evaluate the 9-param distribution for all 3 channels; returns [..., 3].

    theta/gamma are [...]-shaped; broadcast against params [3, 9].
    """
    p = sky.params  # [3, 9]
    t = theta[..., None]  # [..., 1]
    g = gamma[..., None]

    cos_gamma = jnp.cos(g)
    cos_gamma2 = cos_gamma * cos_gamma
    cos_theta = jnp.abs(jnp.cos(t))

    p0, p1, p2 = p[:, 0], p[:, 1], p[:, 2]
    p3, p4, p5 = p[:, 3], p[:, 4], p[:, 5]
    p6, p7, p8 = p[:, 6], p[:, 7], p[:, 8]

    exp_m = jnp.exp(p4 * g)
    ray_m = cos_gamma2
    mie_lhs = 1.0 + cos_gamma2
    mie_rhs = jnp.power(1.0 + p8 * p8 - 2.0 * p8 * cos_gamma, 1.5)
    mie_m = mie_lhs / mie_rhs
    zenith = jnp.sqrt(cos_theta)

    lhs = 1.0 + p0 * jnp.exp(p1 / (cos_theta + 0.01))
    rhs = p2 + p3 * exp_m + p5 * ray_m + p6 * mie_m + p7 * zenith
    return sky.radiances * lhs * rhs
