"""Triton path-tracing kernel vs the XLA path (Pallas interpreter on CPU).

Per-sample Monte-Carlo paths diverge chaotically under any last-ulp float
difference (FMA contraction, acos/atan2/sqrt implementations), so
equivalence is asserted at the levels that are stable: bit-exact RNG,
deterministic first-hit geometry, per-path agreement at 1 spp, and
statistical agreement of accumulated images. Layout choices (block size,
pixel padding, row offsets) are asserted bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from weekend_raytracer.models import scenes
from weekend_raytracer.models.camera import Camera, CameraBasis
from weekend_raytracer.models.materials import Material
from weekend_raytracer.models.scenes import SceneDesc
from weekend_raytracer.models.sky import SkyParams, SkyState, to_sky_state
from weekend_raytracer.models.spheres import Sphere
from weekend_raytracer.ops.pallas import gpu_megakernel as gm
from weekend_raytracer.ops.pallas.gpu_megakernel import render_image_triton
from weekend_raytracer.ops.tonemap import to_srgb_u8
from weekend_raytracer.ops.tracer import render_image


def _setup(name, w, h):
    desc = scenes.SCENES[name][0]()
    cam = scenes.SCENES[name][1]()
    return desc.build(), to_sky_state(SkyParams()), CameraBasis.create(
        cam, (w, h))


def _triton(*args, **kw):
    return render_image_triton(*args, interpret=True, **kw)


def _run(fn, scene, sky, basis, w, h, frames, spp, bounces, **kw):
    acc = jnp.zeros((w * h, 3), jnp.float32)
    for f in range(frames):
        acc = fn(acc, jnp.uint32(f), jnp.bool_(f == 0), scene, sky, basis,
                 width=w, height=h, spp=spp, num_bounces=bounces, **kw)
    return np.asarray(acc) / (frames * spp)


def _constant_sky(rgb):
    params = np.zeros((3, 9), np.float32)
    params[:, 2] = 1.0
    return SkyState.from_raw(params, np.asarray(rgb), np.array([0.0, 1.0, 0.0]))


@pytest.mark.parametrize("name", list(scenes.SCENES))
def test_paths_match_xla_per_scene(name):
    """One path per pixel (1 spp): at least 98% of paths agree with the
    XLA path within rtol 1e-2 / atol 1e-3, and the image means within 1e-2
    (one bright diverged path is ~0.3% of a 576-path mean). random10k's
    ground is a radius-1e4 sphere whose f32 hit points carry ~1e-4
    relative noise that no two f32 implementations share; its paths are
    held to 90%."""
    w, h = 32, 18
    scene, sky, basis = _setup(name, w, h)
    a = _run(render_image, scene, sky, basis, w, h, frames=1, spp=1,
             bounces=8)
    b = _run(_triton, scene, sky, basis, w, h, frames=1, spp=1, bounces=8)
    pixel_bar = 0.90 if name == "random10k" else 0.98
    close = np.isclose(a, b, rtol=1e-2, atol=1e-3).all(-1).mean()
    assert close >= pixel_bar, close
    assert abs(a.mean() - b.mean()) / a.mean() < 1e-2


@pytest.mark.parametrize("name", ["three", "rtiow"])
def test_statistical_equivalence(name):
    w, h = 48, 32
    scene, sky, basis = _setup(name, w, h)
    a = _run(render_image, scene, sky, basis, w, h, frames=8, spp=4,
             bounces=8)
    b = _run(_triton, scene, sky, basis, w, h, frames=8, spp=4, bounces=8)
    ta = np.asarray(to_srgb_u8(a.reshape(h, w, 3))).astype(np.float32) / 255
    tb = np.asarray(to_srgb_u8(b.reshape(h, w, 3))).astype(np.float32) / 255
    rmse = float(np.sqrt(((ta - tb) ** 2).mean()))
    assert rmse < 5e-3, rmse
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 1e-3


def test_first_hit_geometry_identical():
    """1 bounce + constant sky + no lens: color is a binary hit/miss mask
    per pixel-sample; both paths must agree except at sub-ulp silhouette
    pixels."""
    desc = SceneDesc(
        materials=[Material.lambertian((0.3, 0.4, 0.5))],
        spheres=[Sphere((0.0, 0.0, -3.0), 1.0, 0)],
    )
    cam = Camera.look_at((0, 0, 1), (0, 0, -3), vfov_degrees=40.0)
    w, h = 64, 48
    scene = desc.build()
    basis = CameraBasis.create(cam, (w, h))
    sky = _constant_sky(np.ones(3))
    a = _run(render_image, scene, sky, basis, w, h, frames=1, spp=1,
             bounces=1)
    b = _run(_triton, scene, sky, basis, w, h, frames=1, spp=1, bounces=1)
    mismatch = (np.abs(a - b) > 1e-6).any(axis=-1).mean()
    assert mismatch < 0.01, mismatch


def test_accumulation_and_clear_semantics():
    w, h = 32, 16
    scene, sky, basis = _setup("three", w, h)
    acc = jnp.ones((w * h, 3), jnp.float32) * 7.0  # stale data
    kw = dict(width=w, height=h, spp=1, num_bounces=2)
    out1 = _triton(acc, jnp.uint32(0), jnp.bool_(True), scene, sky, basis,
                   **kw)
    # clear=True must discard the stale 7.0
    assert float(np.asarray(out1).min()) < 1.0
    out2 = _triton(out1, jnp.uint32(1), jnp.bool_(False), scene, sky, basis,
                   **kw)
    frame1 = _triton(jnp.zeros_like(out1), jnp.uint32(1), jnp.bool_(True),
                     scene, sky, basis, **kw)
    # accumulation is additive: frame 1 lands on top of frame 0
    np.testing.assert_allclose(np.asarray(out2),
                               np.asarray(out1) + np.asarray(frame1),
                               rtol=1e-6, atol=1e-6)


def test_padding_lanes_recompute_the_last_pixel():
    """Pixel counts not divisible by the block: the clamped tail lanes
    store the last pixel's own value, so the image equals a render whose
    block divides it."""
    w, h = 24, 16  # 384 pixels: 3 blocks of 128, or 2 of 256 (1 padded)
    scene, sky, basis = _setup("single", w, h)
    args = (jnp.zeros((w * h, 3), jnp.float32), jnp.uint32(0),
            jnp.bool_(True), scene, sky, basis)
    kw = dict(width=w, height=h, spp=1, num_bounces=2)
    padded = np.asarray(_triton(*args, block=256, **kw))
    exact = np.asarray(_triton(*args, block=128, **kw))
    assert padded.shape == (w * h, 3)
    assert np.isfinite(padded).all()
    np.testing.assert_array_equal(padded, exact)


@pytest.mark.parametrize("block", [32, 128, 256])
def test_block_size_invariant(block):
    """A path's arithmetic does not depend on which block it runs in: a
    block's early exit only stops lanes that are already dead."""
    w, h = 40, 28
    scene, sky, basis = _setup("three", w, h)
    ref = _run(_triton, scene, sky, basis, w, h, frames=1, spp=2, bounces=6)
    got = _run(_triton, scene, sky, basis, w, h, frames=1, spp=2, bounces=6,
               block=block)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("row_offset", [0, 5, 11])
def test_row_offset_renders_a_band_of_the_full_image(row_offset):
    """row_offset/full_height render rows of a larger image with global
    RNG seeds and camera aim: the band equals those rows of the full
    render (how a mesh shard renders its rows)."""
    w, h, band = 24, 16, 5
    scene, sky, basis = _setup("three", w, h)
    full = np.asarray(_triton(
        jnp.zeros((w * h, 3), jnp.float32), jnp.uint32(2), jnp.bool_(True),
        scene, sky, basis, width=w, height=h, spp=2, num_bounces=4))
    part = np.asarray(_triton(
        jnp.zeros((w * band, 3), jnp.float32), jnp.uint32(2),
        jnp.bool_(True), scene, sky, basis, width=w, height=band, spp=2,
        num_bounces=4, row_offset=row_offset, full_height=h))
    np.testing.assert_array_equal(
        part, full[row_offset * w:(row_offset + band) * w])


def test_frames_draw_different_samples_deterministically():
    w, h = 24, 16
    scene, sky, basis = _setup("three", w, h)

    def frame(f):
        return np.asarray(_triton(
            jnp.zeros((w * h, 3), jnp.float32), jnp.uint32(f),
            jnp.bool_(True), scene, sky, basis, width=w, height=h, spp=1,
            num_bounces=4))

    np.testing.assert_array_equal(frame(3), frame(3))
    assert (frame(3) != frame(4)).any()


def test_emissive_in_kernel():
    """Emissive termination matches the XLA path in the fused kernel."""
    desc = SceneDesc(
        materials=[
            Material.lambertian((0.7, 0.7, 0.7)),
            Material.emissive((1.0, 0.8, 0.5), intensity=8.0),
        ],
        spheres=[
            Sphere((0.0, -100.5, 0.0), 100.0, 0),
            Sphere((0.0, 2.5, 0.0), 1.0, 1),
        ],
    )
    cam = Camera.look_at((0, 1.5, 5.0), (0, 1.0, 0.0), vfov_degrees=45.0)
    w, h = 48, 32
    scene = desc.build()
    basis = CameraBasis.create(cam, (w, h))
    sky = _constant_sky(np.zeros(3))
    a = _run(render_image, scene, sky, basis, w, h, frames=8, spp=4,
             bounces=6)
    b = _run(_triton, scene, sky, basis, w, h, frames=8, spp=4, bounces=6)
    assert a.mean() > 0.01  # the light illuminates the scene
    assert abs(a.mean() - b.mean()) / a.mean() < 0.02
    assert np.isclose(a, b, rtol=1e-2, atol=1e-3).all(-1).mean() > 0.9


@pytest.mark.parametrize("seed", [11, 29])
def test_random_scene_fuzz_equivalence(seed):
    """Randomized small scenes (all material kinds, random geometry) must
    agree statistically between the fused kernel and the XLA path."""
    rs = np.random.RandomState(seed)
    materials = [
        Material.checkerboard(tuple(rs.rand(3)), tuple(rs.rand(3))),
        Material.dielectric(1.3 + 0.4 * rs.rand()),
        Material.emissive(tuple(0.5 + 0.5 * rs.rand(3)), intensity=3.0),
    ]
    spheres = [Sphere((0.0, -200.5, 0.0), 200.0, 0)]
    for i in range(40):
        materials.append(
            Material.metal(tuple(rs.rand(3)), fuzz=0.5 * rs.rand())
            if rs.rand() < 0.3 else Material.lambertian(tuple(rs.rand(3)))
        )
        spheres.append(Sphere(
            (float(rs.uniform(-6, 6)), float(rs.uniform(0.2, 1.0)),
             float(rs.uniform(-6, 6))),
            float(rs.uniform(0.15, 0.6)), 3 + i))
    spheres.append(Sphere((0.0, 4.0, 0.0), 1.0, 2))  # the light
    desc = SceneDesc(materials=materials, spheres=spheres)
    cam = Camera.look_at((0, 2.5, 9.0), (0, 0.5, 0), vfov_degrees=45.0,
                         aperture=0.05, focus_distance=9.0)
    w, h = 48, 32
    scene = desc.build()
    basis = CameraBasis.create(cam, (w, h))
    sky = to_sky_state(SkyParams(turbidity=3.0 + 4.0 * rs.rand(),
                                 zenith_degrees=float(rs.uniform(20, 80))))
    a = _run(render_image, scene, sky, basis, w, h, frames=4, spp=4,
             bounces=6)
    b = _run(_triton, scene, sky, basis, w, h, frames=4, spp=4, bounces=6)
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-6) < 0.03
    assert (np.abs(a - b).max(axis=-1) < 0.5).mean() > 0.9


def test_chunked_scene_matches_xla():
    """Above 512 spheres the XLA path scans sphere chunks; the kernel's
    single loop must find the same closest hits."""
    w, h = 32, 16
    desc = scenes.random_spheres(2000)
    scene = desc.build()
    basis = CameraBasis.create(scenes.random_spheres_camera(), (w, h))
    sky = to_sky_state(SkyParams())
    a = _run(render_image, scene, sky, basis, w, h, frames=1, spp=1,
             bounces=1)
    b = _run(_triton, scene, sky, basis, w, h, frames=1, spp=1, bounces=1)
    close = np.isclose(a, b, rtol=1e-2, atol=1e-3).all(-1).mean()
    assert close >= 0.98, close


def test_consts_layout():
    """The packed camera/sky vector puts each field at its offset."""
    w, h = 16, 9
    _, sky, basis = _setup("rtiow", w, h)
    c = np.asarray(gm._pack_consts(basis, sky))
    assert c.shape == (gm._SUN + 3,)
    np.testing.assert_array_equal(c[gm._EYE:gm._EYE + 3], basis.eye)
    np.testing.assert_array_equal(c[gm._LLC:gm._LLC + 3],
                                  basis.lower_left_corner)
    assert c[gm._LENS] == np.float32(basis.lens_radius)
    np.testing.assert_array_equal(c[gm._SKY_P:gm._SKY_P + 27],
                                  np.asarray(sky.params).reshape(-1))
    np.testing.assert_array_equal(c[gm._SUN:gm._SUN + 3], sky.sun_direction)


def test_accum_shape_is_checked():
    w, h = 8, 4
    scene, sky, basis = _setup("single", w, h)
    with pytest.raises(ValueError):
        _triton(jnp.zeros((w * h + 1, 3), jnp.float32), jnp.uint32(0),
                jnp.bool_(True), scene, sky, basis, width=w, height=h, spp=1,
                num_bounces=1)


def test_no_silent_interpret_fallback_on_cpu():
    """Without interpret=True the kernel is compiled for a GPU: on a CPU
    it fails instead of quietly running in the interpreter."""
    w, h = 8, 4
    scene, sky, basis = _setup("single", w, h)
    with pytest.raises(Exception) as e:
        render_image_triton(
            jnp.zeros((w * h, 3), jnp.float32), jnp.uint32(0),
            jnp.bool_(True), scene, sky, basis, width=w, height=h, spp=1,
            num_bounces=1)
    assert not isinstance(e.value, AssertionError)
