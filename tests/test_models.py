"""Unit tests for the scene/parameter data model (reference L3)."""
import math

import numpy as np
import pytest

from weekend_raytracer import (
    Angle,
    Camera,
    CameraBasis,
    Material,
    MaterialTable,
    RenderParams,
    RenderParamsValidationError,
    SamplingParams,
    Sphere,
    SphereSoA,
    Texture,
    TexturePool,
)
from weekend_raytracer.models import scenes
from weekend_raytracer.models.sky import SkyParams


# --- Angle (parity with the reference's only unit tests, angle.rs:52-93) ---

def test_angle_roundtrip():
    a = Angle.degrees(90.0)
    assert a.as_radians() == pytest.approx(math.pi / 2)
    assert Angle.from_radians(math.pi).as_degrees() == pytest.approx(180.0)


def test_angle_add():
    a = Angle.degrees(30.0) + Angle.degrees(60.0)
    assert a.as_degrees() == pytest.approx(90.0)


def test_angle_clamp():
    lo, hi = Angle.degrees(-89.0), Angle.degrees(89.0)
    assert Angle.degrees(120.0).clamp(lo, hi).as_degrees() == pytest.approx(89.0)
    assert Angle.degrees(-120.0).clamp(lo, hi).as_degrees() == pytest.approx(-89.0)
    assert Angle.degrees(10.0).clamp(lo, hi).as_degrees() == pytest.approx(10.0)


# --- Camera basis (GpuCamera::new math, mod.rs:699-741) ---

def test_camera_basis_matches_reference_math():
    cam = Camera.look_at((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov_degrees=20.0,
                         aperture=0.1, focus_distance=10.0)
    basis = CameraBasis.create(cam, (1920, 1080))
    # Reproduce mod.rs:699-741 directly.
    aspect = 1920 / 1080
    theta = math.radians(20.0)
    half_h = 10.0 * math.tan(0.5 * theta)
    half_w = aspect * half_h
    w = np.array(cam.eye_dir); w /= np.linalg.norm(w)
    v = np.array(cam.up); v /= np.linalg.norm(v)
    u = np.cross(w, v)
    eye = np.array(cam.eye_pos)
    llc = eye + 10.0 * w - half_w * u - half_h * v
    np.testing.assert_allclose(np.asarray(basis.lower_left_corner), llc, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(basis.horizontal), 2 * half_w * u, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(basis.vertical), 2 * half_h * v, rtol=1e-5)
    assert float(basis.lens_radius) == pytest.approx(0.05)


def test_camera_rays_hit_focal_plane():
    """All rays through one screen point converge at the focus distance."""
    import jax.numpy as jnp

    from weekend_raytracer.models.camera import make_rays

    cam = Camera.look_at((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), vfov_degrees=60.0,
                         aperture=0.5, focus_distance=3.0)
    basis = CameraBasis.create(cam, (100, 100))
    n = 64
    su = jnp.full((n,), 0.25)
    sv = jnp.full((n,), 0.75)
    dr = jnp.linspace(0.0, 0.99, n)
    da = jnp.linspace(0.0, 0.99, n)
    o, d = make_rays(basis, su, sv, dr, da)
    # Point on the focal plane: z = -3 for this camera.
    t = (-3.0 - o[:, 2]) / d[:, 2]
    pts = o + t[:, None] * d
    spread = np.asarray(pts).std(axis=0)
    np.testing.assert_array_less(spread, 1e-4)


# --- Textures & materials ---

def test_texture_pool_dedup_and_offsets():
    pool = TexturePool()
    red = Texture.from_color((1.0, 0.0, 0.0))
    blue = Texture.from_color((0.0, 0.0, 1.0))
    d1 = pool.add(red)
    d2 = pool.add(blue)
    d3 = pool.add(Texture.from_color((1.0, 0.0, 0.0)))  # same content
    assert d1 == (1, 1, 0)
    assert d2 == (1, 1, 1)
    assert d3 == d1
    data = pool.build()
    np.testing.assert_allclose(data[0], [1, 0, 0])
    np.testing.assert_allclose(data[1], [0, 0, 1])


def test_material_table_lowering():
    mats = [
        Material.lambertian((0.5, 0.5, 0.5)),
        Material.metal((1.0, 0.85, 0.57), fuzz=0.4),
        Material.dielectric(1.5),
        Material.checkerboard((0.1, 0.2, 0.3), (0.9, 0.9, 0.9)),
    ]
    table = MaterialTable.build(mats)
    assert table.num_materials == 4
    np.testing.assert_array_equal(np.asarray(table.ids), [0, 1, 2, 3])
    assert float(table.x[1]) == pytest.approx(0.4)
    assert float(table.x[2]) == pytest.approx(1.5)
    # solid colors lower to 1x1 pool entries
    np.testing.assert_array_equal(np.asarray(table.tex1)[:, :2], 1)


def test_material_table_image_texture_not_solid():
    img = Texture.from_array(np.random.rand(8, 16, 3).astype(np.float32))
    table = MaterialTable.build([Material.lambertian(img)])
    w, h, off = (int(v) for v in np.asarray(table.tex1)[0])
    assert (w, h) == (16, 8)
    assert table.pool.shape[0] >= off + 8 * 16


def test_sphere_soa_padding():
    soa = SphereSoA.build([Sphere((0, 0, 0), 1.0, 2)], pad_to=8)
    assert soa.centers.shape == (8, 3)
    assert float(soa.radii[3]) == 0.0
    assert int(soa.material_idx[0]) == 2


# --- Validation (mod.rs:396-485) ---

def _params(**kw):
    cam = scenes.three_spheres_camera()
    base = dict(camera=cam, viewport_size=(64, 36))
    base.update(kw)
    return RenderParams(**base)


def test_validate_ok():
    _params().validate()


@pytest.mark.parametrize(
    "sampling",
    [
        SamplingParams(max_samples_per_pixel=100, num_samples_per_pixel=3),
        SamplingParams(num_samples_per_pixel=0),
        SamplingParams(num_bounces=0),
    ],
)
def test_validate_sampling_errors(sampling):
    with pytest.raises(RenderParamsValidationError):
        _params(sampling=sampling).validate()


def test_validate_viewport_zero():
    with pytest.raises(RenderParamsValidationError):
        _params(viewport_size=(0, 10)).validate()


@pytest.mark.parametrize("vfov,aperture,focus", [(0.0, 0.1, 1.0), (91.0, 0.1, 1.0),
                                                 (30.0, 1.5, 1.0), (30.0, 0.1, 0.0)])
def test_validate_camera_errors(vfov, aperture, focus):
    cam = Camera.look_at((0, 0, 1), (0, 0, -1), vfov_degrees=vfov,
                         aperture=aperture, focus_distance=focus)
    with pytest.raises(RenderParamsValidationError):
        _params(camera=cam).validate()


@pytest.mark.parametrize(
    "sky",
    [
        SkyParams(azimuth_degrees=400.0),
        SkyParams(zenith_degrees=95.0),
        SkyParams(turbidity=0.5),
        SkyParams(albedo=(1.2, 0.0, 0.0)),
    ],
)
def test_validate_sky_errors(sky):
    with pytest.raises(RenderParamsValidationError):
        _params(sky=sky).validate()


# --- Scene ladder ---

def test_rtiow_final_scene_size():
    desc = scenes.rtiow_final()
    assert 400 <= desc.num_spheres <= 488
    scene = desc.build(pad_spheres_to=512)
    assert scene.spheres.centers.shape == (512, 3)


def test_reference_demo_scene():
    desc = scenes.reference_demo()
    assert desc.num_spheres == 5
    assert len(desc.materials) == 5
    ids = [m.id for m in desc.materials]
    assert ids == [3, 0, 1, 2, 0]  # checker, lamb, metal, dielectric, lamb


def test_scene_build_validates_material_indices():
    desc = scenes.SceneDesc(
        materials=[Material.lambertian((1, 1, 1))],
        spheres=[Sphere((0, 0, 0), 1.0, 3)],  # out of range
    )
    with pytest.raises(ValueError, match="material indices"):
        desc.build()
    with pytest.raises(ValueError, match="no spheres"):
        scenes.SceneDesc(materials=[Material.dielectric(1.5)], spheres=[]).build()


def test_sampling_envelope_smoke():
    """The reference's full UI envelope (spp/frame {1,2,4}, max {128,256,512},
    bounces [4,10]) builds valid renderers; one frame each at tiny size."""
    from weekend_raytracer import Renderer

    desc = scenes.single_sphere()
    cam = scenes.single_sphere_camera()
    for spp_frame, max_spp, bounces in [(1, 128, 4), (2, 256, 8), (4, 512, 10)]:
        params = RenderParams(
            camera=cam, viewport_size=(16, 9),
            sampling=SamplingParams(max_samples_per_pixel=max_spp,
                                    num_samples_per_pixel=spp_frame,
                                    num_bounces=bounces),
        )
        r = Renderer(desc, params)
        assert r.render_frame()
        assert r.accumulated_samples() == spp_frame


def test_look_at_orthonormal_basis():
    """look_at must orthogonalize the world-up hint: the basis derivation
    (like the reference GpuCamera) uses up as given, so a raw world up
    would shear the image plane for elevated cameras (review finding)."""
    cam = Camera.look_at((-2.0, 2.0, 1.0), (0.0, 0.0, -1.0), vfov_degrees=20.0)
    d = np.asarray(cam.eye_dir); d = d / np.linalg.norm(d)
    up = np.asarray(cam.up)
    assert abs(d @ up) < 1e-12          # orthogonal to the view direction
    assert abs(np.linalg.norm(up) - 1.0) < 1e-12
    basis = CameraBasis.create(cam, (160, 90))
    u = np.asarray(basis.u)
    v = np.asarray(basis.v)
    assert abs(np.linalg.norm(u) - 1.0) < 1e-5   # unsheared, unit axes
    assert abs(u @ v) < 1e-6


def test_texture_from_array_dark_uint8():
    img = np.ones((2, 2, 3), dtype=np.uint8)  # near-black 8-bit image
    tex = Texture.from_array(img)
    np.testing.assert_allclose(tex.data, 1.0 / 255.0, rtol=1e-6)
    fimg = np.full((2, 2, 3), 0.25, dtype=np.float32)
    np.testing.assert_allclose(Texture.from_array(fimg).data, 0.25)
