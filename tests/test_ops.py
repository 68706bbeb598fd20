"""Property tests for the compute ops: RNG, intersection, scatter, sky,
tonemap (SURVEY.md §4 rebuild test plan)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weekend_raytracer.models.materials import Material, MaterialTable
from weekend_raytracer.models.sky import SkyParams, SkyState, to_sky_state
from weekend_raytracer.models.spheres import Sphere, SphereSoA
from weekend_raytracer.ops import rng, tonemap
from weekend_raytracer.ops.intersect import MAX_T, hit_record, intersect
from weekend_raytracer.ops.scatter import (
    cosine_hemisphere_dir,
    pixar_onb,
    reflect,
    scatter,
    texture_lookup,
    unit_sphere_sample,
)
from weekend_raytracer.ops.sky_radiance import sky_radiance


# --- RNG ---

def _np_jenkins(x):
    M = 0xFFFFFFFF
    x = (x + (x << 10)) & M
    x ^= x >> 6
    x = (x + (x << 3)) & M
    x ^= x >> 11
    x = (x + (x << 15)) & M
    return x


def _np_pcg(state):
    M = 0xFFFFFFFF
    old = (state + 747796405 + 2891336453) & M
    word = (((old >> ((old >> 28) + 4)) ^ old) * 277803737) & M
    return ((word >> 22) ^ word) & M


def test_jenkins_matches_independent_impl():
    xs = np.array([0, 1, 2, 123456789, 0xDEADBEEF], dtype=np.uint64)
    expected = np.array([_np_jenkins(int(x)) for x in xs], dtype=np.uint32)
    got = np.asarray(rng.jenkins_hash(jnp.asarray(xs.astype(np.uint32))))
    np.testing.assert_array_equal(got, expected)


def test_pcg_matches_independent_impl():
    states = np.array([0, 1, 42, 0xCAFEBABE], dtype=np.uint32)
    expected = np.array([_np_pcg(int(s)) for s in states], dtype=np.uint32)
    got = np.asarray(rng.next_state(jnp.asarray(states)))
    np.testing.assert_array_equal(got, expected)


def test_rng_uniformity():
    state = rng.init_state(jnp.arange(20000, dtype=jnp.uint32), jnp.uint32(3))
    _, v = rng.next_float(state)
    v = np.asarray(v)
    assert 0.0 <= v.min() and v.max() < 1.0
    assert abs(v.mean() - 0.5) < 0.01
    assert abs(v.var() - 1.0 / 12.0) < 0.005


def test_rng_deterministic_and_frame_dependent():
    idx = jnp.arange(64, dtype=jnp.uint32)
    a = np.asarray(rng.init_state(idx, jnp.uint32(5)))
    b = np.asarray(rng.init_state(idx, jnp.uint32(5)))
    c = np.asarray(rng.init_state(idx, jnp.uint32(6)))
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()


def test_rng_sequential_independence():
    state = rng.init_state(jnp.arange(8192, dtype=jnp.uint32), jnp.uint32(0))
    state, (u1, u2) = rng.next_floats(state, 2)
    corr = np.corrcoef(np.asarray(u1), np.asarray(u2))[0, 1]
    assert abs(corr) < 0.05


# --- Intersection ---

def _soa(spheres):
    return SphereSoA.build(spheres)


def test_intersect_head_on():
    soa = _soa([Sphere((0, 0, -5), 1.0, 0)])
    o = jnp.array([[0.0, 0.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0]])
    t, idx, hit = intersect(o, d, soa)
    assert bool(hit[0])
    assert float(t[0]) == pytest.approx(4.0, rel=1e-5)
    p, n, u, v = hit_record(o, d, t, idx, soa)
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, 1], atol=1e-5)


def test_intersect_closest_of_many():
    soa = _soa([Sphere((0, 0, -10), 1.0, 0), Sphere((0, 0, -3), 0.5, 1),
                Sphere((0, 0, -20), 3.0, 2)])
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    t, idx, hit = intersect(o, d, soa)
    assert int(idx[0]) == 1
    assert float(t[0]) == pytest.approx(2.5, rel=1e-5)


def test_intersect_miss():
    soa = _soa([Sphere((0, 10, -5), 1.0, 0)])
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    t, idx, hit = intersect(o, d, soa)
    assert not bool(hit[0])
    assert float(t[0]) == MAX_T


def test_intersect_from_inside_uses_far_root():
    """Inside a sphere the near root is negative -> take the far root
    (wgsl:421-425 fallback)."""
    soa = _soa([Sphere((0, 0, 0), 2.0, 0)])
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    t, idx, hit = intersect(o, d, soa)
    assert bool(hit[0])
    assert float(t[0]) == pytest.approx(2.0, rel=1e-5)


def test_intersect_chunked_matches_single():
    rs = np.random.RandomState(0)
    spheres = [Sphere(tuple(rs.randn(3) * 5), float(rs.rand() + 0.2), 0)
               for _ in range(100)]
    soa = _soa(spheres)
    o = jnp.asarray(rs.randn(64, 3).astype(np.float32) * 3)
    d = rs.randn(64, 3).astype(np.float32)
    d = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True))
    t1, i1, h1 = intersect(o, d, soa, chunk_size=512)
    t2, i2, h2 = intersect(o, d, soa, chunk_size=16)
    np.testing.assert_allclose(np.asarray(t1), np.asarray(t2), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(h1), np.asarray(h2))
    # Equal-t ties could differ in index; hits must agree where t differs.
    same = np.asarray(t1) < MAX_T
    np.testing.assert_array_equal(np.asarray(i1)[same], np.asarray(i2)[same])


def test_negative_radius_flips_normal():
    soa = _soa([Sphere((0, 0, -5), -1.0, 0)])
    o = jnp.zeros((1, 3))
    d = jnp.array([[0.0, 0.0, -1.0]])
    t, idx, hit = intersect(o, d, soa)
    p, n, u, v = hit_record(o, d, t, idx, soa)
    # Geometric surface normal would be +z at the near point; negative
    # radius flips it inward (RTiOW hollow-glass trick).
    np.testing.assert_allclose(np.asarray(n[0]), [0, 0, -1], atol=1e-5)


def test_spherical_uv():
    soa = _soa([Sphere((0, 0, 0), 1.0, 0)])
    # Hit the +x point: n = (1,0,0); theta = acos(0) = pi/2; phi = atan2(0,1)+pi = pi
    o = jnp.array([[3.0, 0.0, 0.0]])
    d = jnp.array([[-1.0, 0.0, 0.0]])
    t, idx, hit = intersect(o, d, soa)
    p, n, u, v = hit_record(o, d, t, idx, soa)
    assert float(u[0]) == pytest.approx(0.5, abs=1e-5)
    assert float(v[0]) == pytest.approx(0.5, abs=1e-5)


# --- Scatter ---

def test_onb_orthonormal():
    rs = np.random.RandomState(1)
    n = rs.randn(256, 3)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    u, v = pixar_onb(jnp.asarray(n.astype(np.float32)))
    u, v = np.asarray(u), np.asarray(v)
    np.testing.assert_allclose(np.linalg.norm(u, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose((u * v).sum(1), 0.0, atol=1e-5)
    np.testing.assert_allclose((u * n).sum(1), 0.0, atol=1e-5)
    np.testing.assert_allclose((v * n).sum(1), 0.0, atol=1e-5)
    # right-handed: u x v == n
    np.testing.assert_allclose(np.cross(u, v), n, atol=1e-5)


def test_cosine_hemisphere_statistics():
    n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (50000, 3))
    state = rng.init_state(jnp.arange(50000, dtype=jnp.uint32), jnp.uint32(0))
    state, (r1, r2) = rng.next_floats(state, 2)
    wi = np.asarray(cosine_hemisphere_dir(n, r1, r2))
    cos = wi[:, 1]
    assert (cos > -1e-6).all()
    # E[cos] for cosine-weighted sampling = 2/3
    assert abs(cos.mean() - 2.0 / 3.0) < 0.01
    np.testing.assert_allclose(np.linalg.norm(wi, axis=1), 1.0, atol=1e-4)


def test_unit_sphere_sample_uniform():
    state = rng.init_state(jnp.arange(50000, dtype=jnp.uint32), jnp.uint32(1))
    state, (u1, u2, u3) = rng.next_floats(state, 3)
    p = np.asarray(unit_sphere_sample(u1, u2, u3))
    r = np.linalg.norm(p, axis=1)
    assert r.max() <= 1.0 + 1e-5
    # mean radius of uniform ball = 3/4; mean z = 0 (no pole bias)
    assert abs(r.mean() - 0.75) < 0.01
    assert abs(p[:, 2].mean()) < 0.01
    assert abs(p[:, 0].mean()) < 0.01


def test_reflect():
    d = jnp.array([[1.0, -1.0, 0.0]]) / np.sqrt(2)
    n = jnp.array([[0.0, 1.0, 0.0]])
    r = np.asarray(reflect(d, n))
    np.testing.assert_allclose(r, [[1 / np.sqrt(2), 1 / np.sqrt(2), 0]], atol=1e-6)


def _scatter_lane(mat, d, n, p=(0.0, 0.0, 0.0), uv=(0.5, 0.5), rands=(0.1, 0.2, 0.3, 0.9)):
    table = MaterialTable.build([mat])
    N = 1
    return scatter(
        jnp.asarray([d], dtype=jnp.float32),
        jnp.asarray([n], dtype=jnp.float32),
        jnp.asarray([p], dtype=jnp.float32),
        jnp.asarray([uv[0]], dtype=jnp.float32),
        jnp.asarray([uv[1]], dtype=jnp.float32),
        jnp.zeros((N,), dtype=jnp.int32),
        table,
        tuple(jnp.full((N,), r, dtype=jnp.float32) for r in rands),
    )


def test_scatter_lambertian_albedo_and_hemisphere():
    out = _scatter_lane(Material.lambertian((0.5, 0.25, 0.125)),
                        d=(0, 0, -1), n=(0, 0, 1))
    albedo = np.asarray(out.albedo[0])
    np.testing.assert_allclose(albedo, [0.5, 0.25, 0.125], rtol=1e-4)
    assert float(out.direction[0] @ jnp.array([0.0, 0.0, 1.0])) > 0.0


def test_scatter_metal_mirror():
    out = _scatter_lane(Material.metal((0.9, 0.9, 0.9), fuzz=0.0),
                        d=(1 / math.sqrt(2), -1 / math.sqrt(2), 0), n=(0, 1, 0))
    np.testing.assert_allclose(
        np.asarray(out.direction[0]),
        [1 / math.sqrt(2), 1 / math.sqrt(2), 0], atol=1e-5,
    )


def test_scatter_dielectric_refracts_snell():
    """Entering glass at 45 degrees: sin(t) = sin(45)/1.5."""
    d = (1 / math.sqrt(2), -1 / math.sqrt(2), 0)
    out = _scatter_lane(Material.dielectric(1.5), d=d, n=(0, 1, 0),
                        rands=(0.1, 0.2, 0.3, 0.999))  # r4 ~1 -> refract
    wi = np.asarray(out.direction[0])
    sin_t = math.sqrt(wi[0] ** 2 + wi[2] ** 2)
    assert wi[1] < 0  # transmitted into the surface
    assert sin_t == pytest.approx(math.sin(math.pi / 4) / 1.5, rel=1e-4)
    np.testing.assert_allclose(np.asarray(out.albedo[0]), [1, 1, 1], rtol=1e-6)


def test_scatter_dielectric_total_internal_reflection():
    """Leaving glass at a grazing angle -> TIR -> mirror reflection."""
    ang = math.radians(80.0)
    d = (math.sin(ang), math.cos(ang), 0.0)  # exiting, steep to the normal
    out = _scatter_lane(Material.dielectric(1.5), d=d, n=(0, 1, 0),
                        rands=(0.1, 0.2, 0.3, 0.999))
    wi = np.asarray(out.direction[0])
    np.testing.assert_allclose(wi, [math.sin(ang), -math.cos(ang), 0.0], atol=1e-5)


def test_scatter_dielectric_schlick_reflection_branch():
    """r4 = 0 forces the Fresnel-reflection branch (the reference's wgsl
    bug discarded this reflection; we implement the intent)."""
    d = (1 / math.sqrt(2), -1 / math.sqrt(2), 0)
    out = _scatter_lane(Material.dielectric(1.5), d=d, n=(0, 1, 0),
                        rands=(0.1, 0.2, 0.3, 0.0))
    wi = np.asarray(out.direction[0])
    np.testing.assert_allclose(wi, [1 / math.sqrt(2), 1 / math.sqrt(2), 0], atol=1e-5)


def test_scatter_checkerboard_parity():
    even = Material.checkerboard((1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    # sines = sin(5*0.9)^3 < 0? sin(4.5) ≈ -0.97 -> sines < 0 -> tex1 (red)
    out = _scatter_lane(even, d=(0, -1, 0), n=(0, 1, 0), p=(0.9, 0.9, 0.9))
    np.testing.assert_allclose(np.asarray(out.albedo[0]), [1, 0, 0], rtol=1e-4)
    # p = (0.3, 0.3, 0.3): sin(1.5)^3 > 0 -> tex2 (green)
    out = _scatter_lane(even, d=(0, -1, 0), n=(0, 1, 0), p=(0.3, 0.3, 0.3))
    np.testing.assert_allclose(np.asarray(out.albedo[0]), [0, 1, 0], rtol=1e-4)


def test_scatter_unknown_material_is_pink():
    table = MaterialTable.build([Material.lambertian((1, 1, 1))])
    table = table.tree_unflatten(None, (
        jnp.array([7], dtype=jnp.int32),  # unknown id
        table.tex1, table.tex2, table.x, table.pool,
    ))
    out = scatter(
        jnp.array([[0.0, 0.0, -1.0]]), jnp.array([[0.0, 0.0, 1.0]]),
        jnp.zeros((1, 3)), jnp.array([0.5]), jnp.array([0.5]),
        jnp.zeros((1,), dtype=jnp.int32), table,
        tuple(jnp.full((1,), r) for r in (0.1, 0.2, 0.3, 0.4)),
    )
    np.testing.assert_allclose(np.asarray(out.albedo[0]),
                               [0.9921, 0.24705, 0.57254], rtol=1e-4)


def test_texture_lookup_image():
    img = np.zeros((2, 4, 3), dtype=np.float32)
    img[0, 0] = [1, 0, 0]   # top-left
    img[1, 3] = [0, 0, 1]   # bottom-right
    from weekend_raytracer.models.textures import Texture, TexturePool

    pool = TexturePool()
    desc = pool.add(Texture(img))
    pdata = jnp.asarray(pool.build())
    descs = jnp.asarray([desc, desc], dtype=jnp.int32)
    # v = 1 maps to row 0 (v flipped, wgsl:379)
    rgb = np.asarray(texture_lookup(descs, jnp.array([0.0, 0.999]),
                                    jnp.array([0.999, 0.0]), pdata))
    np.testing.assert_allclose(rgb[0], [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(rgb[1], [0, 0, 1], atol=1e-6)


# --- Sky ---

def test_sky_state_shapes_and_sun_direction():
    sky = to_sky_state(SkyParams(azimuth_degrees=90.0, zenith_degrees=45.0))
    assert sky.params.shape == (3, 9)
    assert sky.radiances.shape == (3,)
    s = np.asarray(sky.sun_direction)
    np.testing.assert_allclose(
        s, [0.0, math.cos(math.radians(45)), math.sin(math.radians(45))],
        atol=1e-6,
    )


def test_sky_radiance_positive_and_sun_brightest():
    sky = to_sky_state(SkyParams(zenith_degrees=60.0, turbidity=3.0))
    dirs = np.array([
        [0.0, 1.0, 0.0],  # zenith
        [math.sin(math.radians(60.0)), math.cos(math.radians(60.0)), 0.0],  # at sun
        [0.0, 0.05, -1.0],  # near horizon away from sun
    ])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rad = np.asarray(sky_radiance(jnp.asarray(dirs, dtype=jnp.float32), sky))
    assert (rad > 0).all()
    assert rad[1].sum() > rad[0].sum()  # circumsolar brighter than zenith


def test_sky_constant_injection():
    """SkyState.from_raw with p2=1 and all shape terms zero gives a constant
    sky equal to `radiances` — used by furnace tests."""
    params = np.zeros((3, 9), dtype=np.float32)
    params[:, 2] = 1.0
    sky = SkyState.from_raw(params, np.array([2.0, 3.0, 4.0]),
                            np.array([0.0, 1.0, 0.0]))
    dirs = np.random.RandomState(0).randn(32, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    rad = np.asarray(sky_radiance(jnp.asarray(dirs, dtype=jnp.float32), sky))
    np.testing.assert_allclose(rad, np.tile([2.0, 3.0, 4.0], (32, 1)), rtol=1e-5)


# --- Tonemap ---

def test_tonemap_monotonic_and_range():
    x = jnp.linspace(0.0, 50.0, 256)[:, None].repeat(3, 1)
    y = np.asarray(tonemap.uncharted2(x))
    assert (np.diff(y[:, 0]) > -1e-7).all()
    assert y.min() >= -1e-6
    u8 = np.asarray(tonemap.to_srgb_u8(x))
    assert u8.dtype == np.uint8
    assert u8.min() >= 0 and u8.max() <= 255


def test_tonemap_zero_is_zero():
    y = np.asarray(tonemap.uncharted2(jnp.zeros((4, 3))))
    np.testing.assert_allclose(y, 0.0, atol=1e-6)


def test_scatter_emissive_terminates():
    out = _scatter_lane(Material.emissive((1.0, 0.5, 0.25), intensity=4.0),
                        d=(0, 0, -1), n=(0, 0, 1))
    assert bool(out.terminate[0])
    np.testing.assert_allclose(np.asarray(out.emission[0]), [4.0, 2.0, 1.0],
                               rtol=1e-5)


def test_scatter_non_emissive_does_not_terminate():
    out = _scatter_lane(Material.lambertian((0.5, 0.5, 0.5)),
                        d=(0, 0, -1), n=(0, 0, 1))
    assert not bool(out.terminate[0])


def test_sky_golden_values():
    """Regression pin: the fitted coefficients and the HW-form evaluator
    must not drift silently. Values are scipy-least-squares outputs
    (captured with scipy 1.17) so the tolerance is loose enough to absorb
    optimizer-stopping-point drift across scipy versions while still
    catching model changes. Directions: zenith, near-horizon (+x+z), and
    60-deg-up (-z)."""
    pytest.importorskip("scipy")
    dirs = jnp.asarray([[0.0, 1.0, 0.0], [0.7071, 0.0002, 0.7071],
                        [0.0, 0.5, -0.866]], jnp.float32)
    dirs = dirs / jnp.linalg.norm(dirs, axis=1, keepdims=True)
    golden = {
        (2.0, 30.0): [[4.649099826812744, 6.775300025939941, 12.688599586486816],
                      [23.671199798583984, 19.857999801635742, 19.89620018005371],
                      [4.81279993057251, 8.111800193786621, 15.23859977722168]],
        (4.0, 85.0): [[2.101099967956543, 2.7923998832702637, 3.71589994430542],
                      [9.030099868774414, 5.8850998878479, 2.2279000282287598],
                      [2.856300115585327, 3.418299913406372, 3.639899969100952]],
        (8.0, 60.0): [[10.916399955749512, 14.384599685668945, 18.60759925842285],
                      [22.184900283813477, 14.343799591064453, 9.591400146484375],
                      [11.007599830627441, 11.991900444030762, 11.501700401306152]],
    }
    for (t, z), want in golden.items():
        sky = to_sky_state(SkyParams(turbidity=t, zenith_degrees=z))
        rad = np.asarray(sky_radiance(dirs, sky))
        np.testing.assert_allclose(rad, np.asarray(want), rtol=0.05)


def test_sky_turbidity_flattens_gradient():
    """A clear sky (low T) has a bright horizon against a dark zenith;
    haze flattens and eventually inverts the gradient as the milky
    circumsolar veil dominates. The horizon/zenith ratio must therefore
    decrease monotonically with turbidity, and radiance must stay
    positive over the whole UI range (a low-T Preetham degeneracy used
    to flip signs — guarded by the internal T clamp)."""
    horizon = jnp.asarray([[0.9999, 0.0141, 0.0]], jnp.float32)
    zenith = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    ratios = []
    for t in (1.0, 2.5, 4.0, 9.0):
        sky = to_sky_state(SkyParams(turbidity=t, zenith_degrees=45.0,
                                     azimuth_degrees=180.0))
        h = np.asarray(sky_radiance(horizon, sky))
        zz = np.asarray(sky_radiance(zenith, sky))
        assert (h > 0).all() and (zz > 0).all(), t
        ratios.append(float(h.sum() / zz.sum()))
    assert ratios[0] > ratios[1] > ratios[2] > ratios[3], ratios


def test_sky_chromaticity_varies_across_sky():
    """The fitted per-channel parameters must reproduce Preetham's spatial
    chromaticity: deep blue zenith, warm bright horizon (the fallback
    shared-distribution mapping has constant chromaticity)."""
    pytest.importorskip("scipy")
    sky = to_sky_state(SkyParams(turbidity=3.0, zenith_degrees=60.0))
    zen = np.asarray(sky_radiance(
        jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32), sky))[0]
    hor = np.asarray(sky_radiance(
        jnp.asarray([[0.9999, 0.0141, 0.0]], jnp.float32), sky))[0]
    assert zen[2] / zen[0] > 1.5  # zenith is blue-dominant
    assert hor[2] / hor[0] < 1.1  # horizon is warm/neutral


def test_sky_accepts_list_albedo_and_caches_azimuth_free():
    """to_sky_state must accept unhashable albedo containers (normalized
    to tuples before the cache) and must not refit per azimuth."""
    import time

    from weekend_raytracer.models.sky import _fit_channels

    s1 = to_sky_state(SkyParams(albedo=[0.5, 0.5, 0.5]))  # list: must not raise
    assert s1.params.shape == (3, 9)
    # azimuth sweep shares one (t, ts) fit
    before = _fit_channels.cache_info().misses
    for az in (10.0, 20.0, 30.0, 40.0):
        to_sky_state(SkyParams(azimuth_degrees=az, turbidity=6.5,
                               zenith_degrees=33.0))
    after = _fit_channels.cache_info()
    assert after.misses - before <= 1  # one fit for the whole sweep
