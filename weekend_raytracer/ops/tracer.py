"""Batched wavefront path tracer: the jitted-XLA reference compute path.

A data-parallel formulation of the reference's WGSL megakernel
(raytracer.wgsl:50-172). Where the reference runs one fragment-shader
invocation per pixel with scalar control flow (sample loop wgsl:113-119,
bounce loop with early break wgsl:130-169), this tracer keeps SoA ray state
for a whole batch of pixels and runs:

    lax.scan over samples-per-pixel
      -> lax.scan over bounce depth (dead lanes masked, no data-dependent
         control flow — XLA sees a static dataflow graph)
         -> chunk-scanned brute-force sphere intersection (ops/intersect.py)
         -> branchless material scatter (ops/scatter.py)
         -> sky radiance on miss (ops/sky_radiance.py)

Everything is pure functions over arrays; the GPU megakernel
(ops/pallas/gpu_megakernel.py) is a fused drop-in for the same math, and
this path doubles as its correctness oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.camera import CameraBasis, make_rays
from ..models.materials import MaterialTable
from ..models.sky import SkyState
from ..models.spheres import SphereSoA
from . import rng
from .intersect import hit_record, intersect
from .scatter import scatter
from .sky_radiance import sky_radiance


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Scene:
    """Device scene: sphere SoA + material table (reference Scene,
    mod.rs:413-416)."""

    spheres: SphereSoA
    materials: MaterialTable

    def tree_flatten(self):
        return ((self.spheres, self.materials), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def trace_paths(
    o: jnp.ndarray,  # [N, 3]
    d: jnp.ndarray,  # [N, 3] unit
    states: jnp.ndarray,  # [N] uint32 rng states
    scene: Scene,
    sky: SkyState,
    num_bounces: int,
    sphere_chunk: int = 512,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Trace one path per lane; returns (radiance [N, 3], rng states).

    Mirrors rayColor (wgsl:124-172): iterate bounces, multiply throughput on
    scatter, fetch sky radiance and stop on miss. Lanes whose ray has
    terminated are masked; radiance of paths that never miss within the
    bounce budget is 0 (same as the reference).
    """

    def bounce(carry, _):
        o, d, throughput, color, alive, states = carry
        t, sidx, hit = intersect(o, d, scene.spheres, chunk_size=sphere_chunk)
        p, n, u, v = hit_record(o, d, t, sidx, scene.spheres)
        mat_idx = scene.spheres.material_idx[sidx]

        states, rands = rng.next_floats(states, 4)
        sc = scatter(d, n, p, u, v, mat_idx, scene.materials, rands)

        sky_rgb = sky_radiance(d, sky)

        active_hit = alive & hit
        miss_now = alive & ~hit
        lit = active_hit & sc.terminate  # emissive hit ends the path
        scattering = active_hit & ~sc.terminate

        throughput = jnp.where(scattering[:, None], throughput * sc.albedo, throughput)
        color = jnp.where(miss_now[:, None], sky_rgb, color)
        color = jnp.where(lit[:, None], sc.emission, color)
        o = jnp.where(scattering[:, None], p, o)
        d = jnp.where(scattering[:, None], sc.direction, d)
        alive = scattering
        return (o, d, throughput, color, alive, states), None

    n_lanes = o.shape[0]
    init = (
        o,
        d,
        jnp.ones((n_lanes, 3), dtype=jnp.float32),
        jnp.zeros((n_lanes, 3), dtype=jnp.float32),
        jnp.ones((n_lanes,), dtype=bool),
        states,
    )
    (o, d, throughput, color, alive, states), _ = jax.lax.scan(
        bounce, init, None, length=num_bounces
    )
    return throughput * color, states


def render_pixels(
    pixel_idx: jnp.ndarray,  # [N] i32 flat pixel indices (y * width + x)
    frame: jnp.ndarray,  # u32 scalar frame number
    scene: Scene,
    sky: SkyState,
    basis: CameraBasis,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    sphere_chunk: int = 512,
) -> jnp.ndarray:
    """Sum of ``spp`` sample radiances for each pixel lane ([N, 3]).

    Mirrors fsMain + samplePixel (wgsl:50-122): per-pixel-per-frame RNG
    seeding, jittered screen positions, thin-lens camera rays, v flipped
    (wgsl:117 passes 1 - v).
    """
    x = (pixel_idx % width).astype(jnp.float32)
    y = (pixel_idx // width).astype(jnp.float32)
    inv_w = 1.0 / float(width)
    inv_h = 1.0 / float(height)
    pix_u32 = pixel_idx.astype(jnp.uint32)

    def sample(carry, s):
        acc = carry
        # independent per-sample seed (see rng.init_sample_state): draws
        # depend only on (pixel, frame, sample, bounce) — stable across
        # backends and launch shapes
        states = rng.init_sample_state(pix_u32, frame, s)
        states, (ju, jv, dr, da) = rng.next_floats(states, 4)
        su = (x + ju) * inv_w
        sv = 1.0 - (y + jv) * inv_h
        o, d = make_rays(basis, su, sv, dr, da)
        radiance, states = trace_paths(
            o, d, states, scene, sky, num_bounces, sphere_chunk
        )
        return acc + radiance, None

    acc0 = jnp.zeros((pixel_idx.shape[0], 3), dtype=jnp.float32)
    acc, _ = jax.lax.scan(sample, acc0, jnp.arange(spp, dtype=jnp.uint32))
    return acc


def default_pixel_batch(n_pixels: int) -> int | None:
    """Pixel batch bounding the [lanes x sphere_chunk] intersect
    intermediates (None: the whole image in one batch)."""
    if n_pixels <= (1 << 17):
        return None
    return 1 << 16


def render_image(
    accum: jnp.ndarray,  # [H*W, 3] accumulated radiance
    frame: jnp.ndarray,  # u32 scalar
    clear: jnp.ndarray,  # bool scalar: reset accumulation first
    scene: Scene,
    sky: SkyState,
    basis: CameraBasis,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    pixel_batch: int | None = None,
    sphere_chunk: int = 512,
    row_offset=0,
    full_height: int | None = None,
) -> jnp.ndarray:
    """One progressive frame over the whole image; returns the new accum.

    The image is processed in pixel batches via lax.map to bound the live
    [lanes x sphere_chunk] intersection intermediate; batches are a
    compile-time layout choice, not a semantic one (None:
    default_pixel_batch).

    ``row_offset``/``full_height`` render rows [row_offset, row_offset +
    height) of a ``full_height``-row image: RNG seeds and camera aim use
    global pixel coordinates, as one shard of a mesh does
    (parallel/sharding.py).
    """
    n = width * height
    accum = jnp.where(clear, jnp.zeros_like(accum), accum)
    if pixel_batch is None:
        pixel_batch = default_pixel_batch(n)
    aim_height = full_height or height
    first = jnp.asarray(row_offset, jnp.int32) * width

    if pixel_batch is None or pixel_batch >= n:
        idx = first + jnp.arange(n, dtype=jnp.int32)
        return accum + render_pixels(
            idx, frame, scene, sky, basis, width, aim_height, spp,
            num_bounces, sphere_chunk,
        )

    # Pad the pixel index list to a batch multiple with clamped (duplicate
    # edge) indices; padded lanes render redundantly and their rows are
    # dropped below, so any (n, pixel_batch) combination is valid.
    pad = (-n) % pixel_batch
    idx = first + jnp.concatenate([
        jnp.arange(n, dtype=jnp.int32),
        jnp.full((pad,), n - 1, dtype=jnp.int32),
    ]).reshape(-1, pixel_batch)

    def one_batch(batch_idx):
        return render_pixels(
            batch_idx, frame, scene, sky, basis, width, aim_height, spp,
            num_bounces, sphere_chunk,
        )

    out = jax.lax.map(one_batch, idx)
    return accum + out.reshape(-1, 3)[:n]
