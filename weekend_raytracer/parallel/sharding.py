"""Multi-chip rendering: pixel-tile + sample sharding over a device mesh.

The reference is single-process/single-GPU — its only "parallelism" is the
implicit one-fragment-per-pixel SIMT dispatch (SURVEY.md §2 checklist). The
multi-device scaling story adds an explicit 2D ``jax.sharding`` mesh:

 - ``tiles`` axis (data parallel over pixels): the image rows and the
   persistent accumulator are sharded; each chip owns its tile's
   accumulator for the whole progressive render, so no pixel data ever
   moves between chips (pixels are independent).
 - ``spp`` axis (sample parallel): chips along this axis draw decorrelated
   sample batches for the *same* pixels and merge via one ``psum`` (over
   NVLink between the cards of one host) — the Ulysses-style alternative
   noted in SURVEY.md §5.

For multi-host deployments initialize ``jax.distributed`` first and pass
the global mesh — the code below only sees mesh axes. Host transfer
remains display-only (tonemapped frames), mirroring the reference's
accumulator-never-leaves-device design.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.camera import CameraBasis
from ..models.params import RenderParamsValidationError
from ..models.sky import SkyState
from ..ops.tracer import Scene, render_image

TILE_AXIS = "tiles"
SPP_AXIS = "spp"


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    tile_shards: Optional[int] = None,
    spp_shards: int = 1,
) -> Mesh:
    """Build a (tiles, spp) mesh. Defaults to all devices on the tile axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if spp_shards < 1 or n % spp_shards != 0:
        raise RenderParamsValidationError(
            f"spp_shards ({spp_shards}) must divide the device count ({n})"
        )
    if tile_shards is None:
        tile_shards = n // spp_shards
    if tile_shards * spp_shards != n:
        raise RenderParamsValidationError(
            f"tile_shards * spp_shards ({tile_shards}x{spp_shards}) must "
            f"equal the device count ({n})"
        )
    arr = np.asarray(devices).reshape(tile_shards, spp_shards)
    return Mesh(arr, (TILE_AXIS, SPP_AXIS))


def validate_mesh_config(mesh: Mesh, viewport_size, spp_per_frame: int) -> None:
    """Typed up-front checks for rendering on a mesh (Renderer(mesh=...)).

    Heights that the tile axis doesn't divide are fine — the renderer pads
    rows — but the per-frame sample count must split evenly across the spp
    axis (samples are integers; fractional shards can't be decorrelated).
    """
    if TILE_AXIS not in mesh.shape or SPP_AXIS not in mesh.shape:
        raise RenderParamsValidationError(
            f"mesh must have ({TILE_AXIS!r}, {SPP_AXIS!r}) axes, got "
            f"{tuple(mesh.axis_names)} (use parallel.sharding.make_mesh)"
        )
    n_spp = mesh.shape[SPP_AXIS]
    if spp_per_frame % n_spp != 0:
        raise RenderParamsValidationError(
            f"num_samples_per_pixel ({spp_per_frame}) must be divisible by "
            f"the mesh spp axis ({n_spp})"
        )


def render_image_sharded(
    accum: jnp.ndarray,  # [H*W, 3], sharded over rows on the tile axis
    frame: jnp.ndarray,  # u32 scalar
    clear: jnp.ndarray,  # bool scalar
    scene: Scene,  # replicated (scene data is KBs; TP is N/A by design)
    sky: SkyState,
    basis: CameraBasis,
    *,
    width: int,
    height: int,
    spp: int,
    num_bounces: int,
    mesh: Mesh,
    backend: str = "xla",
    aim_height: Optional[int] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """One progressive frame over the mesh; returns the new accumulator.

    Semantics match ops.tracer.render_image: ``spp`` is the total samples
    per pixel added this frame, split evenly across the spp axis. Sample
    batches on different spp shards are decorrelated by folding the shard
    index into the RNG frame seed.

    ``height`` is the accumulator's (possibly padded) row count and must be
    divisible by the tile axis; ``aim_height`` is the real image height the
    camera basis was derived for (defaults to ``height``). Rows in
    [aim_height, height) render off-frame content the caller slices away —
    this is how Renderer(mesh=...) supports arbitrary viewport sizes.

    Each device owns a horizontal band of rows and renders it with the
    chosen backend ("xla" or "triton"), seeding RNG and aiming the camera
    in global image coordinates (the backends' row_offset/full_height
    arguments). ``interpret=True`` runs the Triton kernel in the Pallas
    interpreter (tests only).
    """
    n_tiles = mesh.shape[TILE_AXIS]
    n_spp = mesh.shape[SPP_AXIS]
    if aim_height is None:
        aim_height = height
    if height % n_tiles != 0:
        raise RenderParamsValidationError(
            f"accumulator height ({height}) must be divisible by the tile "
            f"axis ({n_tiles}); pad rows first (Renderer(mesh=...) does)"
        )
    if spp % n_spp != 0:
        raise RenderParamsValidationError(
            f"frame spp ({spp}) must be divisible by the spp axis ({n_spp})"
        )
    local_spp = spp // n_spp
    block_rows = height // n_tiles
    if backend == "xla":
        render = render_image
    elif backend == "triton":
        from ..ops.pallas.gpu_megakernel import render_image_triton

        render = partial(render_image_triton, interpret=interpret)
    else:
        raise RenderParamsValidationError(
            f"render_image_sharded backend must be 'xla' or 'triton', got "
            f"{backend!r}"
        )

    def shard_fn(accum_blk, frame, clear, scene, sky, basis):
        tile_idx = jax.lax.axis_index(TILE_AXIS)
        spp_idx = jax.lax.axis_index(SPP_AXIS)
        # Decorrelate sample shards: injective (frame, shard) -> seed frame.
        seed_frame = frame * jnp.uint32(n_spp) + spp_idx.astype(jnp.uint32)
        contrib = render(
            jnp.zeros_like(accum_blk), seed_frame, jnp.bool_(True),
            scene, sky, basis,
            width=width, height=block_rows, spp=local_spp,
            num_bounces=num_bounces, row_offset=tile_idx * block_rows,
            full_height=aim_height,
        )
        contrib = jax.lax.psum(contrib, SPP_AXIS)
        base = jnp.where(clear, jnp.zeros_like(accum_blk), accum_blk)
        return base + contrib

    fn = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P(TILE_AXIS, None),  # accum rows over tiles, replicated over spp
            P(), P(), P(), P(), P(),  # scalars + scene/sky/basis replicated
        ),
        out_specs=P(TILE_AXIS, None),
        check_vma=False,
    )
    return fn(accum, frame, clear, scene, sky, basis)


def sharded_accumulator(width: int, height: int, mesh: Mesh) -> jnp.ndarray:
    """Allocate the [H*W, 3] accumulator sharded over the tile axis."""
    sharding = NamedSharding(mesh, P(TILE_AXIS, None))
    return jnp.zeros((width * height, 3), dtype=jnp.float32, device=sharding)
