"""Progressive renderer: accumulation state machine + jitted frame steps.

Capability parity with the reference's ``Raytracer`` orchestrator
(src/raytracer/mod.rs:20-394) and ``RenderProgress`` (mod.rs:615-679):

 - per-frame progressive sample accumulation into a persistent device
   buffer (the reference's image storage buffer, mod.rs:76-85);
 - three-state progress machine: first-frame clear / accumulating / done
   (mod.rs:626-670), driving how many samples each frame contributes;
 - validated parameter updates with change detection: a changed parameter
   bundle re-derives the camera basis + sky state and resets accumulation
   (set_render_params, mod.rs:353-388);
 - progress = accumulated / max samples (mod.rs:390-394).

Device design: the accumulator lives in device memory as a donated f32
array — it never returns to the host except for display (the reference's
"accumulator never leaves the device", SURVEY.md §3.3). One jitted step
function per (viewport, spp, bounces, backend) signature renders a whole
frame.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .models.camera import CameraBasis
from .models.params import RenderParams, RenderParamsValidationError
from .models.scenes import SceneDesc
from .models.sky import to_sky_state
from .ops import tonemap
from .ops.tracer import Scene, render_image

# Each backend and the platforms it runs on.
BACKENDS = {"xla": ("gpu", "cpu"), "triton": ("gpu",)}
# Backend that "auto" resolves to on each supported platform. On a GPU the
# fused Triton kernel is the faster of the two on every benchmark cell
# (PERF.md); on a CPU only the XLA path runs.
AUTO_BACKEND = {"gpu": "triton", "cpu": "xla"}


class CheckpointMismatchError(ValueError):
    """A checkpoint's scene/params fingerprint doesn't match the renderer.

    Raised by Renderer.load_checkpoint instead of silently blending samples
    rendered under different scene data, camera, sky, viewport, or bounce
    depth into the accumulator."""


@dataclasses.dataclass
class GpuSamplingParams:
    """Per-frame sampling state handed to the device step (reference
    GpuSamplingParams, mod.rs:898-906)."""

    num_samples_per_pixel: int
    num_bounces: int
    accumulated_samples_per_pixel: int
    clear_accumulated_samples: bool


class RenderProgress:
    """The 3-state accumulation machine (reference mod.rs:615-679)."""

    def __init__(self):
        self._accumulated = 0

    def next_frame(self, sampling) -> GpuSamplingParams:
        current = self._accumulated
        nxt = current + sampling.num_samples_per_pixel
        if current == 0:
            self._accumulated = nxt
            return GpuSamplingParams(
                sampling.num_samples_per_pixel, sampling.num_bounces, nxt, True
            )
        if nxt <= sampling.max_samples_per_pixel:
            self._accumulated = nxt
            return GpuSamplingParams(
                sampling.num_samples_per_pixel, sampling.num_bounces, nxt, False
            )
        return GpuSamplingParams(0, sampling.num_bounces, current, False)

    def reset(self) -> None:
        self._accumulated = 0

    def restore(self, accumulated: int) -> None:
        """Set the accumulated-sample count (checkpoint resume)."""
        self._accumulated = int(accumulated)

    def accumulated_samples(self) -> int:
        return self._accumulated


class Renderer:
    """Owns device scene state and renders progressive frames.

    Parameters
    ----------
    scene : SceneDesc or prebuilt ops.tracer.Scene
    params : RenderParams (validated on construction and on update)
    backend : "auto" | "triton" (fused path-tracing kernel, GPU only) |
        "xla" (jitted wavefront tracer, every platform). "auto" picks
        AUTO_BACKEND for the platform the renderer runs on; a backend
        that cannot run there raises RenderParamsValidationError.
    mesh : optional jax.sharding.Mesh (tiles x spp axes, see
        parallel.sharding.make_mesh). When given, the accumulator is
        row-sharded over the tile axis and every frame renders under
        shard_map, merging spp-axis sample shards with one psum.
        Heights not divisible by the tile axis are padded internally.
    hw_dataset : optional path to the published Hosek-Wilkie 2012 RGB
        dataset (ArHosekSkyModelData_RGB.h or equivalent .npz). When
        given (or WRT_HW_DATASET is set), sky coefficients are cooked
        exactly like the reference's hw_skymodel crate instead of the
        built-in Preetham-derived fit (models/hw_dataset.py).
    """

    def __init__(self, scene, params: RenderParams, backend: str = "auto",
                 mesh=None, hw_dataset: Optional[str] = None):
        from .utils.cache import enable_persistent_cache

        enable_persistent_cache()
        params.validate()
        if isinstance(scene, SceneDesc):
            self._scene_desc = scene
            self._scene: Scene = scene.build()
        else:
            self._scene_desc = None
            self._scene = scene
        self._backend_request = backend
        self.mesh = mesh
        self.hw_dataset = hw_dataset
        self.backend = self._resolve_backend(params)
        self._params = params
        self._progress = RenderProgress()
        self._frame_number = 0
        self._derive_device_state()
        self._alloc_accumulator()
        self._step_cache = {}

    def _resolve_backend(self, params: RenderParams) -> str:
        """Resolve the requested backend for the platform the renderer
        runs on (re-run on every set_render_params: mesh constraints must
        hold for the NEW params, not the ones the renderer was
        constructed with)."""
        mesh = self.mesh
        if mesh is not None:
            from .parallel.sharding import validate_mesh_config

            validate_mesh_config(mesh, params.viewport_size,
                                 params.sampling.num_samples_per_pixel)
            platform = mesh.devices.flat[0].platform
        else:
            platform = jax.default_backend()
        return resolve_backend(self._backend_request, platform)

    # -- state derivation ---------------------------------------------------

    def _derive_device_state(self) -> None:
        from .models.sky import resolve_sky_state

        self._basis = CameraBasis.create(self._params.camera, self._params.viewport_size)
        self._sky, self._sky_model = resolve_sky_state(
            self._params.sky, hw_dataset_path=self.hw_dataset)

    def sky_model(self) -> str:
        """Which sky model this renderer's frames ACTUALLY use (exact
        Hosek-Wilkie dataset cooking vs the built-in Preetham fit) —
        recorded at cook time, not inferred from configuration, so the
        provenance stat can't name a model the render didn't use."""
        return self._sky_model

    def _padded_height(self) -> int:
        """Image height padded so the tile axis divides the rows evenly
        (single-device: no padding). Padding rows render off-frame content
        and are sliced away on readback."""
        h = self._params.viewport_size[1]
        if self.mesh is None:
            return h
        from .parallel.sharding import TILE_AXIS

        n_tiles = self.mesh.shape[TILE_AXIS]
        return -(-h // n_tiles) * n_tiles

    def _alloc_accumulator(self) -> None:
        w, _ = self._params.viewport_size
        hp = self._padded_height()
        if self.mesh is None:
            self._accum = jnp.zeros((w * hp, 3), dtype=jnp.float32)
        else:
            from .parallel.sharding import sharded_accumulator

            self._accum = sharded_accumulator(w, hp, self.mesh)

    # -- parameter updates (reference mod.rs:353-388) ------------------------

    @property
    def params(self) -> RenderParams:
        return self._params

    def set_render_params(self, params: RenderParams) -> bool:
        """Validate + apply; any change resets accumulation. Returns True
        if the params actually changed (reference early-outs on equality)."""
        if params == self._params:
            return False
        params.validate()
        # re-resolve BEFORE mutating state: an 'auto' renderer may need a
        # different backend for the new spp/bounces, and mesh constraints
        # must be validated against the new params (raises, leaving the
        # renderer untouched, on an incompatible combination)
        backend = self._resolve_backend(params)
        resize = params.viewport_size != self._params.viewport_size
        self.backend = backend
        self._params = params
        self._derive_device_state()
        if resize:
            self._alloc_accumulator()
        self._progress.reset()
        return True

    # -- progressive rendering ----------------------------------------------

    def _get_step(self, spp: int, bounces: int):
        w, h = self._params.viewport_size
        hp = self._padded_height()
        n_spheres = int(self._scene.spheres.centers.shape[0])
        key = (self.backend, w, h, spp, bounces, n_spheres)
        if key not in self._step_cache:
            if self.mesh is not None:
                from .parallel.sharding import render_image_sharded

                fn = partial(
                    render_image_sharded,
                    width=w,
                    height=hp,
                    aim_height=h,
                    spp=spp,
                    num_bounces=bounces,
                    mesh=self.mesh,
                    backend=self.backend,
                )
            elif self.backend == "triton":
                from .ops.pallas.gpu_megakernel import render_image_triton

                fn = partial(render_image_triton, width=w, height=h,
                             spp=spp, num_bounces=bounces)
            else:
                fn = partial(render_image, width=w, height=h, spp=spp,
                             num_bounces=bounces)
            self._step_cache[key] = jax.jit(fn, donate_argnums=(0,))
        return self._step_cache[key]

    def render_frame(self) -> bool:
        """Render one progressive frame; returns False when converged
        (the reference's 0-spp 'done' state skips device work)."""
        gpu = self._progress.next_frame(self._params.sampling)
        if gpu.num_samples_per_pixel == 0:
            return False
        step = self._get_step(gpu.num_samples_per_pixel, gpu.num_bounces)
        self._accum = step(
            self._accum,
            jnp.uint32(self._frame_number),
            jnp.bool_(gpu.clear_accumulated_samples),
            self._scene,
            self._sky,
            self._basis,
        )
        self._frame_number += 1
        return True

    def reset_accumulation(self) -> None:
        """Restart progressive accumulation without changing parameters
        (the next frame renders with the clear flag set, so the stale
        accumulator contents never blend in)."""
        self._progress.reset()

    def sync(self) -> None:
        """Wait until every queued frame has finished on the device."""
        self._accum.block_until_ready()

    def render(self, block: bool = True) -> "RenderStats":
        """Render until converged (max spp reached); returns timing stats.

        ``rays_per_sec`` is computed over warm frames only: the first frame
        is synced and timed separately (``warmup_seconds``) because it pays
        the compile on a cold cache, which would otherwise understate
        throughput (all later frames reuse the same compiled step). ``seconds`` is total wall time.
        """
        t0 = time.perf_counter()
        frames = 0
        warmup = 0.0
        warm_t0 = t0
        warm_spp0 = self._progress.accumulated_samples()
        while self.render_frame():
            frames += 1
            if frames == 1:
                self.sync()
                now = time.perf_counter()
                warmup = now - t0
                warm_t0 = now
                warm_spp0 = self._progress.accumulated_samples()
        if block:
            self.sync()
        end = time.perf_counter()
        dt = end - t0
        dt_warm = end - warm_t0
        w, h = self._params.viewport_size
        s = self._params.sampling
        total_spp = self._progress.accumulated_samples()
        rays = w * h * total_spp * s.num_bounces
        warm_rays = w * h * (total_spp - warm_spp0) * s.num_bounces
        if warm_rays > 0 and dt_warm > 0:
            rps = warm_rays / dt_warm
        else:  # single-frame render: no warm frames to measure
            rps = rays / dt if dt > 0 else 0.0
        return RenderStats(
            frames=frames,
            seconds=dt,
            samples_per_pixel=total_spp,
            rays=rays,
            rays_per_sec=rps,
            warmup_seconds=warmup,
        )

    def progress(self) -> float:
        """Fraction of max spp accumulated (reference mod.rs:390-394)."""
        return (
            self._progress.accumulated_samples()
            / self._params.sampling.max_samples_per_pixel
        )

    def accumulated_samples(self) -> int:
        return self._progress.accumulated_samples()

    # -- checkpoint / resume (SURVEY.md §5: the accumulator + sample count
    # are the render's whole persistent state; the reference keeps them
    # only in GPU memory across frames, mod.rs:615-679) ----------------------

    def _fingerprint(self) -> str:
        """Stable hash binding a checkpoint to what produced its samples:
        scene arrays + camera + sky + viewport + bounce depth.

        Sampling *counts* (spp per frame / max spp) are deliberately
        excluded: changing them only re-paces or extends the progressive
        render — every accumulated sample remains a draw from the same
        estimator — and "resume with a larger --spp" is a supported use.
        """
        h = hashlib.sha256()
        for leaf in jax.tree_util.tree_leaves(self._scene):
            a = np.asarray(leaf)
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
        p = self._params
        h.update(repr(p.camera).encode())
        h.update(repr(p.sky).encode())
        # hash the COOKED sky coefficients too: the same SkyParams cook
        # to a different estimator under the exact HW dataset vs the
        # built-in fit (and under different dataset files)
        h.update(np.asarray(self._sky.params).tobytes())
        h.update(np.asarray(self._sky.radiances).tobytes())
        h.update(repr(tuple(p.viewport_size)).encode())
        h.update(str(p.sampling.num_bounces).encode())
        # The backend is deliberately excluded: both draw the same
        # per-sample paths (same RNG, full-resolution textures), so a
        # checkpoint saved under one resumes under the other.
        return h.hexdigest()

    def save_checkpoint(self, path: str) -> None:
        """Persist the progressive render state to an .npz file."""
        np.savez_compressed(
            path,
            accum=np.asarray(self._accum),
            accumulated_spp=np.int64(self._progress.accumulated_samples()),
            frame_number=np.int64(self._frame_number),
            viewport=np.asarray(self._params.viewport_size, dtype=np.int64),
            fingerprint=np.asarray(self._fingerprint()),
        )

    def load_checkpoint(self, path: str) -> None:
        """Resume a progressive render saved by save_checkpoint.

        Raises CheckpointMismatchError unless the checkpoint's fingerprint
        (scene + camera + sky + viewport + bounces) matches this
        renderer — mismatched resumes would silently blend samples of a
        different image into the accumulator. Parameter changes after
        resume behave exactly like live changes (reset on change).
        """
        data = np.load(path)
        vp = tuple(int(v) for v in data["viewport"])
        if vp != tuple(self._params.viewport_size):
            raise CheckpointMismatchError(
                f"checkpoint viewport {vp} != current {self._params.viewport_size}"
            )
        if "fingerprint" in data:
            saved = str(data["fingerprint"])
            if saved != self._fingerprint():
                raise CheckpointMismatchError(
                    f"checkpoint {path!r} was saved with different scene/"
                    "camera/sky/bounces state than this renderer; "
                    "refusing to blend incompatible samples"
                )
        else:
            from .utils.log import get_logger

            get_logger(__name__).warning(
                "checkpoint %s has no fingerprint (pre-round-2 format); "
                "scene/params compatibility cannot be verified", path,
            )
        accum = jnp.asarray(data["accum"], dtype=jnp.float32)
        w, _ = self._params.viewport_size
        hp = self._padded_height()
        if accum.shape[0] != w * hp:
            # single-device checkpoint resumed on a padded mesh (or vice
            # versa): grow/trim the padding rows, which carry no image data
            base = np.zeros((w * hp, 3), dtype=np.float32)
            n = min(w * hp, accum.shape[0])
            base[:n] = np.asarray(accum)[:n]
            accum = jnp.asarray(base)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from .parallel.sharding import TILE_AXIS

            accum = jax.device_put(
                accum, NamedSharding(self.mesh, P(TILE_AXIS, None))
            )
        self._accum = accum
        self._progress.restore(int(data["accumulated_spp"]))
        self._frame_number = int(data["frame_number"])

    # -- readback ------------------------------------------------------------

    def mean_radiance(self) -> jnp.ndarray:
        """Accumulator / sample count as [H, W, 3] (pre-tonemap)."""
        w, h = self._params.viewport_size
        n = max(1, self._progress.accumulated_samples())
        acc = self._accum[: w * h]  # drop mesh padding rows, if any
        return (acc / n).reshape(h, w, 3)

    def image(self) -> np.ndarray:
        """Tonemapped sRGB uint8 frame [H, W, 3] (the swapchain output:
        uncharted2 of the running mean, wgsl:75-80)."""
        return np.asarray(tonemap.to_srgb_u8(self.mean_radiance()))


@dataclasses.dataclass(frozen=True)
class RenderStats:
    frames: int
    seconds: float  # total wall time, including first-frame compile
    samples_per_pixel: int
    rays: int
    rays_per_sec: float  # warm-frame throughput (compile excluded)
    warmup_seconds: float = 0.0  # first frame incl. compile


def resolve_backend(backend: str, platform: str) -> str:
    """The backend a Renderer runs for a requested name on a platform.

    "auto" maps through AUTO_BACKEND; an explicit backend must be able to
    run on the platform. Nothing falls back to another backend or to
    interpret mode.
    """
    if platform not in AUTO_BACKEND:
        raise RenderParamsValidationError(
            f"unsupported platform {platform!r}; supported: "
            f"{sorted(AUTO_BACKEND)}")
    if backend == "auto":
        return AUTO_BACKEND[platform]
    if backend not in BACKENDS:
        raise RenderParamsValidationError(
            f"unknown backend {backend!r}; choose 'auto' or one of "
            f"{list(BACKENDS)}")
    if platform not in BACKENDS[backend]:
        raise RenderParamsValidationError(
            f"backend {backend!r} does not run on platform {platform!r} "
            f"(it runs on {list(BACKENDS[backend])})")
    return backend
