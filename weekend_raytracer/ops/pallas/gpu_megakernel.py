"""Fused path-tracing megakernel for NVIDIA GPUs (Pallas, Triton route).

The GPU shape of the reference's per-pixel fragment shader
(raytracer.wgsl:50-172): one (pixel, sample) path per lane, a block of
``block`` lanes per program (one lane per thread), and the whole path in
registers.

 - The sample loop and the bounce loop run inside the kernel, so no ray
   state goes through device memory between bounces (the XLA path runs
   them as ``lax.scan`` iterations over HBM-resident arrays).
 - The bounce loop stops when no lane of the block is alive. The test is
   a max-reduction over an int mask: ``jnp.any`` does not lower on this
   route.
 - Closest hit is the same brute-force sweep as ``ops/intersect.py``: a
   loop over every sphere, reading the SoA scene by scalar loads (10k
   spheres are ~160 KB, which L1/L2 serve). No culling, so a comparison
   with the XLA path measures fusion alone.
 - The winner's geometry, the material table and the texture pool are
   read by per-lane gathers at full resolution: the same estimator as the
   XLA path.
 - RNG is ``ops/rng.py``; draws depend only on (pixel, frame, sample,
   bounce), so live-lane draws match the XLA path and the NumPy oracle.
 - The frame is added to the accumulator inside the kernel; the
   accumulator is aliased in and out. Blocks share no state.

Lanes past the last pixel are clamped onto it: they recompute that
pixel's path exactly and store the identical value, so no store mask is
needed.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...models import materials as _mat
from ...models.camera import CameraBasis
from ...models.sky import SkyState
from .. import rng
from ..intersect import MAX_T, MIN_T
from ..tracer import Scene

# Launch shape, chosen by measurement on an H100 (PERF.md): 64 lanes in
# two warps, one lane per thread, beat 128 and 256 lanes on every cell; a
# smaller block stops bouncing sooner once its own paths are dead.
# Pipeline stages made no difference.
BLOCK = 64  # lanes per program
NUM_WARPS = 2

_EPS = 1.0e-3
_PI = 3.14159265358979
_FRAC_1_PI = 1.0 / _PI

# Offsets into the packed f32 constants vector (camera basis, then sky).
_EYE, _HORIZ, _VERT, _U, _V, _LENS, _LLC = 0, 3, 6, 9, 12, 15, 16
_SKY_P = 19  # [3, 9] row-major
_SKY_RAD = _SKY_P + 27
_SUN = _SKY_RAD + 3


def _pack_consts(basis: CameraBasis, sky: SkyState) -> jnp.ndarray:
    parts = [
        basis.eye, basis.horizontal, basis.vertical, basis.u, basis.v,
        jnp.reshape(basis.lens_radius, (1,)), basis.lower_left_corner,
        jnp.reshape(sky.params, (27,)), sky.radiances, sky.sun_direction,
    ]
    return jnp.concatenate([jnp.asarray(p, jnp.float32).reshape(-1)
                            for p in parts])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _normalize(a, floor=None):
    n = jnp.sqrt(_dot(a, a))
    if floor is not None:
        n = jnp.maximum(n, floor)
    return tuple(c / n for c in a)


def _where3(m, a, b):
    return tuple(jnp.where(m, x, y) for x, y in zip(a, b))


def _texture(tex_ref, pool_ref, mat, first, u, v):
    """Nearest-texel pool gather (ops/scatter.texture_lookup)."""
    k = 0 if first else 3
    w = tex_ref[k, mat]
    h = tex_ref[k + 1, mat]
    off = tex_ref[k + 2, mat]
    uu = jnp.clip(u, 0.0, 1.0)
    vv = 1.0 - jnp.clip(v, 0.0, 1.0)
    j = jnp.minimum((uu * w.astype(jnp.float32)).astype(jnp.int32), w - 1)
    i = jnp.minimum((vv * h.astype(jnp.float32)).astype(jnp.int32), h - 1)
    idx = off + i * w + j
    return tuple(pool_ref[idx, c] for c in range(3))


def _lambertian_throughput(n, wi, albedo):
    ndotwi = _dot(n, wi)
    ratio = (_FRAC_1_PI * jnp.maximum(_EPS, ndotwi)) / jnp.maximum(
        _EPS, ndotwi * _FRAC_1_PI)
    return tuple(a * ratio for a in albedo)


def _scatter(d, n, p, u, v, mat, rands, mid_ref, x_ref, tex_ref, pool_ref):
    """Per-lane ops/scatter.scatter: every branch evaluated, selected by
    material id. Returns (direction, albedo, emission, terminate)."""
    r1, r2, r3, r4 = rands
    mid = mid_ref[mat]
    x = x_ref[mat]
    albedo1 = _texture(tex_ref, pool_ref, mat, True, u, v)
    albedo2 = _texture(tex_ref, pool_ref, mat, False, u, v)

    # cosine-weighted hemisphere direction through the Pixar ONB
    s = jnp.where(n[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[2])
    b = n[0] * n[1] * a
    tu = (1.0 + s * n[0] * n[0] * a, s * b, -s * n[0])
    tv = (b, s + n[1] * n[1] * a, -n[1])
    sqrt_r2 = jnp.sqrt(r2)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - r2))
    phi = (2.0 * _PI) * r1
    cx = jnp.cos(phi) * sqrt_r2
    cy = jnp.sin(phi) * sqrt_r2
    diffuse = tuple(cx * tu[k] + cy * tv[k] + z * n[k] for k in range(3))

    # uniform point in the unit ball
    rr = jnp.cbrt(r1)
    cos_t = 1.0 - 2.0 * r2
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi3 = (2.0 * _PI) * r3
    ball = (rr * sin_t * jnp.cos(phi3), rr * sin_t * jnp.sin(phi3),
            rr * cos_t)

    sines = jnp.sin(5.0 * p[0]) * jnp.sin(5.0 * p[1]) * jnp.sin(5.0 * p[2])
    checker = _where3(sines < 0.0, albedo1, albedo2)
    lam_thr = _lambertian_throughput(n, diffuse, albedo1)
    chk_thr = _lambertian_throughput(n, diffuse, checker)

    ddotn = _dot(d, n)
    refl = tuple(d[k] - 2.0 * ddotn * n[k] for k in range(3))
    metal = tuple(refl[k] + x * ball[k] for k in range(3))

    front = ddotn < 0.0
    out_n = _where3(front, n, tuple(-c for c in n))
    eta = jnp.where(front, 1.0 / x, x)
    cosine = jnp.where(front, -ddotn, x * ddotn)
    dt = _dot(d, out_n)
    disc = 1.0 - eta * eta * (1.0 - dt * dt)
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    refr = tuple(eta * (d[k] - dt * out_n[k]) - sq * out_n[k]
                 for k in range(3))
    r0 = (1.0 - x) / (1.0 + x)
    r0 = r0 * r0
    schlick = r0 + (1.0 - r0) * jnp.power(
        1.0 - jnp.clip(cosine, 0.0, 1.0), 5.0)
    reflect_prob = jnp.where(disc > 0.0, schlick, 1.0)
    diel = _where3(r4 < reflect_prob, refl, refr)

    one = jnp.ones_like(x)
    direction = tuple(n[k] + ball[k] for k in range(3))
    thr = tuple(c * one for c in _mat.ERROR_PINK)
    for id_, yes_dir, yes_thr in (
        (_mat.CHECKERBOARD, diffuse, chk_thr),
        (_mat.DIELECTRIC, diel, (one, one, one)),
        (_mat.METAL, metal, albedo1),
        (_mat.LAMBERTIAN, diffuse, lam_thr),
    ):
        m = mid == id_
        direction = _where3(m, yes_dir, direction)
        thr = _where3(m, yes_thr, thr)

    emission = tuple(x * c for c in albedo1)
    return (_normalize(direction, 1.0e-12), thr, emission,
            mid == _mat.EMISSIVE)


def _sky(c_ref, d):
    """ops/sky_radiance.sky_radiance for one lane vector."""
    sun = tuple(c_ref[_SUN + k] for k in range(3))
    theta = jnp.arccos(jnp.clip(d[1], -1.0, 1.0))
    gamma = jnp.arccos(jnp.clip(_dot(d, sun), -1.0, 1.0))
    cos_gamma = jnp.cos(gamma)
    cos_gamma2 = cos_gamma * cos_gamma
    cos_theta = jnp.abs(jnp.cos(theta))
    zenith = jnp.sqrt(cos_theta)
    out = []
    for ch in range(3):
        p = [c_ref[_SKY_P + 9 * ch + k] for k in range(9)]
        exp_m = jnp.exp(p[4] * gamma)
        mie_rhs = jnp.power(1.0 + p[8] * p[8] - 2.0 * p[8] * cos_gamma, 1.5)
        mie_m = (1.0 + cos_gamma2) / mie_rhs
        lhs = 1.0 + p[0] * jnp.exp(p[1] / (cos_theta + 0.01))
        rhs = (p[2] + p[3] * exp_m + p[5] * cos_gamma2 + p[6] * mie_m
               + p[7] * zenith)
        out.append(c_ref[_SKY_RAD + ch] * lhs * rhs)
    return tuple(out)


def _closest_hit(sph_ref, o, d, n_spheres):
    """Brute-force closest hit (ops/intersect.intersect): (t, index)."""
    shape = o[0].shape

    def body(i, carry):
        best_t, best_i = carry
        oc = tuple(o[k] - sph_ref[k, i] for k in range(3))
        r = sph_ref[3, i]
        b = _dot(oc, d)
        c = _dot(oc, oc) - r * r
        disc = b * b - c
        hit = disc > 0.0
        sq = jnp.sqrt(jnp.where(hit, disc, 0.0))
        t_near = -b - sq
        t_far = -b + sq
        near_ok = hit & (t_near > MIN_T) & (t_near < MAX_T)
        far_ok = hit & (t_far > MIN_T) & (t_far < MAX_T)
        t = jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, MAX_T))
        better = t < best_t
        return jnp.where(better, t, best_t), jnp.where(better, i, best_i)

    init = (jnp.full(shape, MAX_T, jnp.float32), jnp.zeros(shape, jnp.int32))
    return jax.lax.fori_loop(0, n_spheres, body, init)


def _kernel(meta_ref, c_ref, sph_ref, smat_ref, mid_ref, x_ref, tex_ref,
            pool_ref, acc_in_ref, acc_out_ref, *, width, aim_height,
            n_pixels, spp, num_bounces, block):
    lane = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    pix = jnp.minimum(lane, n_pixels - 1)
    frame = meta_ref[0]
    gpix = meta_ref[1].astype(jnp.int32) * width + pix
    xf = (gpix % width).astype(jnp.float32)
    yf = (gpix // width).astype(jnp.float32)
    pix_u32 = gpix.astype(jnp.uint32)
    n_spheres = sph_ref.shape[1]

    eye = tuple(c_ref[_EYE + k] for k in range(3))
    horiz = tuple(c_ref[_HORIZ + k] for k in range(3))
    vert = tuple(c_ref[_VERT + k] for k in range(3))
    cam_u = tuple(c_ref[_U + k] for k in range(3))
    cam_v = tuple(c_ref[_V + k] for k in range(3))
    llc = tuple(c_ref[_LLC + k] for k in range(3))
    lens = c_ref[_LENS]

    def bounce(carry):
        i, o, d, thr, color, alive, state = carry
        t, sidx = _closest_hit(sph_ref, o, d, n_spheres)
        hit = t < MAX_T
        centre = tuple(sph_ref[k, sidx] for k in range(3))
        r = sph_ref[3, sidx]
        p = tuple(o[k] + t * d[k] for k in range(3))
        safe_r = jnp.where(r == 0.0, 1.0, r)
        n = tuple((p[k] - centre[k]) / safe_r for k in range(3))
        theta = jnp.arccos(jnp.clip(-n[1], -1.0, 1.0))
        phi = jnp.arctan2(-n[2], n[0]) + _PI
        u = 0.5 * _FRAC_1_PI * phi
        v = _FRAC_1_PI * theta
        mat = smat_ref[sidx]

        state, rands = rng.next_floats(state, 4)
        sdir, albedo, emission, terminate = _scatter(
            d, n, p, u, v, mat, rands, mid_ref, x_ref, tex_ref, pool_ref)
        sky = _sky(c_ref, d)

        live = alive > 0
        miss_now = live & ~hit
        lit = live & hit & terminate
        scattering = live & hit & ~terminate
        thr = _where3(scattering, tuple(a * b for a, b in zip(thr, albedo)),
                      thr)
        color = _where3(miss_now, sky, color)
        color = _where3(lit, emission, color)
        o = _where3(scattering, p, o)
        d = _where3(scattering, sdir, d)
        return i + 1, o, d, thr, color, scattering.astype(jnp.int32), state

    def any_alive(carry):
        i, *_, alive, _state = carry
        return (i < num_bounces) & (jnp.max(alive) > 0)

    def sample(s, acc):
        state = rng.init_sample_state(pix_u32, frame, s.astype(jnp.uint32))
        state, (ju, jv, dr, da) = rng.next_floats(state, 4)
        su = (xf + ju) * (1.0 / float(width))
        sv = 1.0 - (yf + jv) * (1.0 / float(aim_height))
        rad = jnp.sqrt(dr)
        alpha = (2.0 * _PI) * da
        lx = lens * rad * jnp.cos(alpha)
        ly = lens * rad * jnp.sin(alpha)
        o = tuple(eye[k] + (lx * cam_u[k] + ly * cam_v[k]) for k in range(3))
        d = _normalize(tuple(
            llc[k] + su * horiz[k] + sv * vert[k] - o[k] for k in range(3)))
        zeros = jnp.zeros_like(xf)
        ones = jnp.ones_like(xf)
        init = (jnp.int32(0), o, d, (ones, ones, ones),
                (zeros, zeros, zeros), jnp.ones_like(pix), state)
        _, _, _, thr, color, _, _ = jax.lax.while_loop(any_alive, bounce, init)
        return tuple(a + t * c for a, t, c in zip(acc, thr, color))

    zeros = jnp.zeros((block,), jnp.float32)
    acc = jax.lax.fori_loop(0, spp, sample, (zeros, zeros, zeros))
    keep = meta_ref[2] == 0
    for ch in range(3):
        old = jnp.where(keep, acc_in_ref[pix, ch], 0.0)
        acc_out_ref[pix, ch] = old + acc[ch]


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "num_bounces", "full_height",
                     "block", "num_warps", "interpret"),
)
def render_image_triton(
    accum: jnp.ndarray,  # [H*W, 3] accumulated radiance
    frame: jnp.ndarray,  # u32 scalar
    clear: jnp.ndarray,  # bool scalar
    scene: Scene,
    sky: SkyState,
    basis: CameraBasis,
    *,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    row_offset=0,
    full_height: int | None = None,
    block: int = BLOCK,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
) -> jnp.ndarray:
    """One progressive frame; same contract as ops.tracer.render_image.

    ``row_offset``/``full_height`` render rows [row_offset, row_offset +
    height) of a ``full_height``-row image: RNG seeds and camera aim use
    global pixel coordinates, as one shard of a mesh does
    (parallel/sharding.py). ``interpret=True`` runs the kernel on the CPU
    through the Pallas interpreter (tests only).
    """
    n = width * height
    if accum.shape != (n, 3):
        raise ValueError(f"accum shape {accum.shape} != {(n, 3)}")
    meta = jnp.stack([
        jnp.asarray(frame, jnp.uint32),
        jnp.asarray(row_offset, jnp.uint32),
        jnp.asarray(clear, jnp.uint32),
    ])
    sph = scene.spheres
    sph_soa = jnp.concatenate([sph.centers.T, sph.radii[None, :]], axis=0)
    mats = scene.materials
    tex = jnp.concatenate([mats.tex1.T, mats.tex2.T], axis=0)  # [6, M]
    kernel = functools.partial(
        _kernel, width=width, aim_height=full_height or height, n_pixels=n,
        spp=spp, num_bounces=num_bounces, block=block)
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, block),),
        out_shape=jax.ShapeDtypeStruct(accum.shape, accum.dtype),
        input_output_aliases={8: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="path_trace",
    )(meta, _pack_consts(basis, sky), sph_soa, sph.material_idx, mats.ids,
      mats.x, tex, mats.pool, accum)
