"""CUDA lowering gates for the Triton kernel (no GPU needed).

Interpret-mode tests check the kernel's semantics but never run the
Pallas -> Triton lowering, where unsupported operations surface (for
example ``jnp.any``, whose reduce_or has no lowering on this route).
``jax.export`` for ``platforms=["cuda"]`` runs that lowering on the CPU;
the Triton compile itself, and what the GPU compiler refuses, show only on
the card (chip_smoke.py).
"""
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
from jax import export

from weekend_raytracer.models import scenes
from weekend_raytracer.models.camera import CameraBasis
from weekend_raytracer.models.sky import SkyParams, to_sky_state
from weekend_raytracer.ops.pallas.gpu_megakernel import render_image_triton

_TRITON_CALL = "__gpu$xla.gpu.triton"
_PACKAGE = Path(__file__).resolve().parents[1] / "weekend_raytracer"


def _export_cuda(fn, *args):
    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            _TRITON_CALL)],
    )(*args)
    return exp.mlir_module()


def _frame_args(name, w, h):
    scene = scenes.SCENES[name][0]().build()
    basis = CameraBasis.create(scenes.SCENES[name][1](), (w, h))
    return (jax.ShapeDtypeStruct((w * h, 3), jnp.float32), jnp.uint32(0),
            jnp.bool_(True), scene, to_sky_state(SkyParams()), basis)


@pytest.mark.parametrize("name,size", [
    ("rtiow", (1920, 1080)),
    ("random10k", (3840, 2160)),
    ("textured", (1920, 1080)),
    ("three", (1280, 720)),
])
def test_kernel_lowers_for_cuda_at_full_size(name, size):
    w, h = size
    mlir = _export_cuda(
        partial(render_image_triton, width=w, height=h, spp=4,
                num_bounces=8),
        *_frame_args(name, w, h))
    assert mlir.count(_TRITON_CALL) == 1


def test_shard_band_lowers_for_cuda():
    """A mesh shard's call: a traced row offset into a taller image."""
    w, h = 1920, 270

    def band(accum, frame, clear, scene, sky, basis, row):
        return render_image_triton(accum, frame, clear, scene, sky, basis,
                                   width=w, height=h, spp=2, num_bounces=8,
                                   row_offset=row, full_height=1080)

    mlir = _export_cuda(band, *_frame_args("rtiow", w, h), jnp.int32(540))
    assert _TRITON_CALL in mlir


@pytest.mark.parametrize("block,num_warps", [(128, 4), (256, 8)])
def test_kernel_lowers_for_other_launch_shapes(block, num_warps):
    w, h = 640, 360
    mlir = _export_cuda(
        partial(render_image_triton, width=w, height=h, spp=1,
                num_bounces=4, block=block, num_warps=num_warps),
        *_frame_args("rtiow", w, h))
    assert _TRITON_CALL in mlir


def test_every_pallas_call_names_the_triton_route():
    """The default route of pallas_call in this JAX is Mosaic GPU; every
    kernel in the package names Triton."""
    sources = {p: p.read_text() for p in _PACKAGE.rglob("*.py")}
    calls = {p: s for p, s in sources.items() if "pallas_call(" in s}
    assert calls, "no pallas_call found"
    for path, src in calls.items():
        assert src.count("pallas_call(") == src.count('backend="triton"'), path
