"""Multi-chip sharding tests on the 8-virtual-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from weekend_raytracer.models import scenes
from weekend_raytracer.models.camera import CameraBasis
from weekend_raytracer.models.sky import SkyParams, to_sky_state
from weekend_raytracer.ops.tracer import render_image
from weekend_raytracer.parallel.sharding import (
    make_mesh,
    render_image_sharded,
    sharded_accumulator,
)


@pytest.fixture(scope="module")
def setup():
    w, h = 64, 32
    desc = scenes.three_spheres()
    scene = desc.build()
    basis = CameraBasis.create(scenes.three_spheres_camera(), (w, h))
    sky = to_sky_state(SkyParams())
    return w, h, scene, sky, basis


def test_mesh_shapes():
    m = make_mesh(jax.devices()[:8], spp_shards=2)
    assert m.shape == {"tiles": 4, "spp": 2}
    m = make_mesh(jax.devices()[:8])
    assert m.shape == {"tiles": 8, "spp": 1}


def test_tile_sharding_matches_single_device(setup):
    """Pure pixel-DP (spp_shards=1) computes the same pixels with the same
    RNG streams as the single-device tracer. Per-shard array shapes fuse
    slightly differently in XLA, so the rare silhouette sample can flip —
    require near-bitwise equality (>99.9% identical, no large outliers in
    count)."""
    w, h, scene, sky, basis = setup
    mesh = make_mesh(jax.devices()[:4], spp_shards=1)
    acc = sharded_accumulator(w, h, mesh)
    out = np.asarray(render_image_sharded(
        acc, jnp.uint32(0), jnp.bool_(True), scene, sky, basis,
        width=w, height=h, spp=2, num_bounces=4, mesh=mesh,
    ))
    ref = np.asarray(render_image(
        jnp.zeros((w * h, 3), jnp.float32), jnp.uint32(0), jnp.bool_(True),
        scene, sky, basis, width=w, height=h, spp=2, num_bounces=4,
    ))
    identical = (out == ref).mean()
    assert identical > 0.99, identical


def test_spp_sharding_statistics(setup):
    """Sample-parallel shards draw decorrelated streams and psum-merge;
    the mean image must agree with the single-device estimator."""
    w, h, scene, sky, basis = setup
    mesh = make_mesh(jax.devices()[:8], spp_shards=4)
    acc = sharded_accumulator(w, h, mesh)
    frames = 4
    spp_per_frame = 8
    for f in range(frames):
        acc = render_image_sharded(
            acc, jnp.uint32(f), jnp.bool_(f == 0), scene, sky, basis,
            width=w, height=h, spp=spp_per_frame, num_bounces=4, mesh=mesh,
        )
    sharded_mean = np.asarray(acc) / (frames * spp_per_frame)

    ref = jnp.zeros((w * h, 3), jnp.float32)
    for f in range(frames):
        ref = render_image(
            ref, jnp.uint32(f), jnp.bool_(f == 0), scene, sky, basis,
            width=w, height=h, spp=spp_per_frame, num_bounces=4,
        )
    ref_mean = np.asarray(ref) / (frames * spp_per_frame)
    # compare on the display transform: the circumsolar glow makes linear
    # radiance heavy-tailed, so linear RMSE is dominated by a few bright
    # MC-noisy pixels
    from weekend_raytracer.ops.tonemap import to_srgb_u8

    ta = np.asarray(to_srgb_u8(jnp.asarray(sharded_mean))).astype(np.float32) / 255
    tb = np.asarray(to_srgb_u8(jnp.asarray(ref_mean))).astype(np.float32) / 255
    rmse = float(np.sqrt(((ta - tb) ** 2).mean()))
    assert rmse < 0.05, rmse  # MC agreement at 32 spp
    rel_mean = abs(sharded_mean.mean() - ref_mean.mean()) / max(ref_mean.mean(), 1e-6)
    assert rel_mean < 0.05, rel_mean


def test_sharded_accum_stays_sharded(setup):
    """The accumulator keeps its tile sharding across steps (no silent
    gather to one device)."""
    w, h, scene, sky, basis = setup
    mesh = make_mesh(jax.devices()[:4], spp_shards=1)
    acc = sharded_accumulator(w, h, mesh)
    out = render_image_sharded(
        acc, jnp.uint32(0), jnp.bool_(True), scene, sky, basis,
        width=w, height=h, spp=1, num_bounces=2, mesh=mesh,
    )
    assert len(out.sharding.device_set) == 4


def test_2d_mesh_tile_and_spp(setup):
    """Full 2D mesh: 4 tile shards x 2 spp shards on 8 devices."""
    w, h, scene, sky, basis = setup
    mesh = make_mesh(jax.devices()[:8], spp_shards=2)
    acc = sharded_accumulator(w, h, mesh)
    out = render_image_sharded(
        acc, jnp.uint32(0), jnp.bool_(True), scene, sky, basis,
        width=w, height=h, spp=4, num_bounces=4, mesh=mesh,
    )
    out = np.asarray(out)
    assert np.isfinite(out).all()
    assert (out > 0).any()


# --- Renderer(mesh=...) integration ---

def _mesh_renderer(mesh, size=(64, 35), backend="xla", spp=2, max_spp=4):
    """Height 35 is deliberately not divisible by 4 tile shards."""
    from weekend_raytracer import RenderParams, Renderer, SamplingParams

    params = RenderParams(
        camera=scenes.three_spheres_camera(),
        viewport_size=size,
        sampling=SamplingParams(max_samples_per_pixel=max_spp,
                                num_samples_per_pixel=spp, num_bounces=4),
    )
    return Renderer(scenes.three_spheres(), params, backend=backend, mesh=mesh)


def test_renderer_mesh_matches_single_device():
    """The user-facing mesh path renders the same image as the single-device
    Renderer (pixel-DP only, same RNG streams), including row padding for a
    height the tile axis doesn't divide."""
    from weekend_raytracer import RenderParams, Renderer, SamplingParams

    mesh = make_mesh(jax.devices()[:4], spp_shards=1)
    r = _mesh_renderer(mesh)
    while r.render_frame():
        pass
    params = RenderParams(
        camera=scenes.three_spheres_camera(),
        viewport_size=(64, 35),
        sampling=SamplingParams(max_samples_per_pixel=4,
                                num_samples_per_pixel=2, num_bounces=4),
    )
    ref = Renderer(scenes.three_spheres(), params, backend="xla")
    while ref.render_frame():
        pass
    a = np.asarray(r.mean_radiance())
    b = np.asarray(ref.mean_radiance())
    assert a.shape == b.shape == (35, 64, 3)
    identical = (a == b).mean()
    assert identical > 0.99, identical


def test_renderer_mesh_spp_shards_and_checkpoint(tmp_path):
    """2D mesh via the Renderer; checkpoint round-trips across mesh and
    single-device renderers (padding rows added/stripped)."""
    mesh = make_mesh(jax.devices()[:8], spp_shards=2)
    r = _mesh_renderer(mesh, spp=4, max_spp=8)
    r.render_frame()
    path = str(tmp_path / "ckpt.npz")
    r.save_checkpoint(path)

    r2 = _mesh_renderer(mesh, spp=4, max_spp=8)
    r2.load_checkpoint(path)
    assert r2.accumulated_samples() == 4
    np.testing.assert_array_equal(np.asarray(r2._accum), np.asarray(r._accum))


def test_renderer_mesh_validation():
    from weekend_raytracer.models.params import RenderParamsValidationError

    mesh = make_mesh(jax.devices()[:8], spp_shards=4)
    with pytest.raises(RenderParamsValidationError):
        _mesh_renderer(mesh, spp=2)  # 2 spp not divisible by 4 spp shards
    with pytest.raises(RenderParamsValidationError):
        make_mesh(jax.devices()[:8], spp_shards=3)  # 3 doesn't divide 8
    with pytest.raises(RenderParamsValidationError):
        make_mesh(jax.devices()[:8], tile_shards=3, spp_shards=2)


# --- the Triton kernel per shard (Pallas interpreter on the CPU mesh) ---

def _triton_single(scene, sky, basis, w, h, frame, spp):
    from weekend_raytracer.ops.pallas.gpu_megakernel import (
        render_image_triton,
    )

    return np.asarray(render_image_triton(
        jnp.zeros((w * h, 3), jnp.float32), jnp.uint32(frame),
        jnp.bool_(True), scene, sky, basis, width=w, height=h, spp=spp,
        num_bounces=4, interpret=True))


@pytest.mark.parametrize("tiles", [4, 8])
def test_triton_tile_sharding_matches_single_device(setup, tiles):
    """Each device renders its band of rows with global RNG seeds and
    camera aim: the sharded frame is the single-device frame."""
    w, h, scene, sky, basis = setup
    mesh = make_mesh(jax.devices()[:tiles], spp_shards=1)
    out = np.asarray(render_image_sharded(
        sharded_accumulator(w, h, mesh), jnp.uint32(0), jnp.bool_(True),
        scene, sky, basis, width=w, height=h, spp=2, num_bounces=4,
        mesh=mesh, backend="triton", interpret=True,
    ))
    ref = _triton_single(scene, sky, basis, w, h, frame=0, spp=2)
    np.testing.assert_array_equal(out, ref)


def test_triton_spp_sharding_statistics(setup):
    """Sample shards draw decorrelated streams and merge with one psum:
    the mean agrees with the single-device kernel statistically."""
    w, h, scene, sky, basis = setup
    mesh = make_mesh(jax.devices()[:8], spp_shards=2)
    acc = sharded_accumulator(w, h, mesh)
    frames, spp = 4, 8
    for f in range(frames):
        acc = render_image_sharded(
            acc, jnp.uint32(f), jnp.bool_(f == 0), scene, sky, basis,
            width=w, height=h, spp=spp, num_bounces=4, mesh=mesh,
            backend="triton", interpret=True,
        )
    got = np.asarray(acc) / (frames * spp)
    ref = sum(_triton_single(scene, sky, basis, w, h, f, spp)
              for f in range(frames)) / (frames * spp)
    assert np.isfinite(got).all()
    assert abs(got.mean() - ref.mean()) / ref.mean() < 0.05


def test_sharded_backend_name_is_checked(setup):
    from weekend_raytracer.models.params import RenderParamsValidationError

    w, h, scene, sky, basis = setup
    mesh = make_mesh(jax.devices()[:4], spp_shards=1)
    with pytest.raises(RenderParamsValidationError):
        render_image_sharded(
            sharded_accumulator(w, h, mesh), jnp.uint32(0), jnp.bool_(True),
            scene, sky, basis, width=w, height=h, spp=2, num_bounces=4,
            mesh=mesh, backend="mosaic")


def test_xla_shards_batch_pixels(setup):
    """The XLA path batches each shard's pixels like the single-device
    path does; a batch smaller than the shard gives the same frame."""
    from weekend_raytracer.ops.tracer import render_image as ri

    w, h, scene, sky, basis = setup
    band = h // 4
    one = np.asarray(ri(
        jnp.zeros((w * band, 3), jnp.float32), jnp.uint32(0),
        jnp.bool_(True), scene, sky, basis, w, band, 2, 4,
        row_offset=band, full_height=h, pixel_batch=None))
    batched = np.asarray(ri(
        jnp.zeros((w * band, 3), jnp.float32), jnp.uint32(0),
        jnp.bool_(True), scene, sky, basis, w, band, 2, 4,
        row_offset=band, full_height=h, pixel_batch=100))
    np.testing.assert_allclose(batched, one, rtol=1e-5, atol=1e-6)


def test_renderer_mesh_auto_picks_xla_on_cpu():
    mesh = make_mesh(jax.devices()[:4], spp_shards=1)
    r = _mesh_renderer(mesh, backend="auto")
    assert r.backend == "xla"
    assert r.render_frame()
    assert r.image().shape == (35, 64, 3)


def test_renderer_mesh_refuses_triton_on_cpu():
    from weekend_raytracer.models.params import RenderParamsValidationError

    mesh = make_mesh(jax.devices()[:4], spp_shards=1)
    with pytest.raises(RenderParamsValidationError):
        _mesh_renderer(mesh, backend="triton")
