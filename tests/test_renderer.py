"""Renderer orchestration tests: progressive accumulation state machine,
parameter-change semantics, readback (reference mod.rs:303-394, 615-679)."""
import dataclasses

import numpy as np
import pytest

from weekend_raytracer import (
    RenderParams,
    RenderParamsValidationError,
    Renderer,
    RenderProgress,
    SamplingParams,
)
from weekend_raytracer.models import scenes
from weekend_raytracer.models.sky import SkyParams
from weekend_raytracer.renderer import resolve_backend


def _renderer(max_spp=8, spp=2, bounces=4, size=(32, 18)):
    params = RenderParams(
        camera=scenes.three_spheres_camera(),
        viewport_size=size,
        sampling=SamplingParams(
            max_samples_per_pixel=max_spp,
            num_samples_per_pixel=spp,
            num_bounces=bounces,
        ),
    )
    return Renderer(scenes.three_spheres(), params)


# --- RenderProgress state machine (mod.rs:626-670 three branches) ---

def test_progress_first_frame_clears():
    p = RenderProgress()
    s = SamplingParams(max_samples_per_pixel=8, num_samples_per_pixel=2)
    g = p.next_frame(s)
    assert g.clear_accumulated_samples
    assert g.num_samples_per_pixel == 2
    assert g.accumulated_samples_per_pixel == 2


def test_progress_accumulating():
    p = RenderProgress()
    s = SamplingParams(max_samples_per_pixel=8, num_samples_per_pixel=2)
    p.next_frame(s)
    g = p.next_frame(s)
    assert not g.clear_accumulated_samples
    assert g.num_samples_per_pixel == 2
    assert g.accumulated_samples_per_pixel == 4


def test_progress_done_stops_sampling():
    p = RenderProgress()
    s = SamplingParams(max_samples_per_pixel=4, num_samples_per_pixel=2)
    p.next_frame(s)
    p.next_frame(s)
    g = p.next_frame(s)
    assert g.num_samples_per_pixel == 0
    assert g.accumulated_samples_per_pixel == 4
    assert p.accumulated_samples() == 4


def test_progress_reset():
    p = RenderProgress()
    s = SamplingParams()
    p.next_frame(s)
    p.reset()
    assert p.accumulated_samples() == 0
    assert p.next_frame(s).clear_accumulated_samples


# --- Renderer ---

def test_render_to_convergence():
    r = _renderer(max_spp=8, spp=2)
    stats = r.render()
    assert stats.frames == 4
    assert stats.samples_per_pixel == 8
    assert r.progress() == pytest.approx(1.0)
    assert not r.render_frame()  # converged: no more work


def test_image_shape_and_dtype():
    r = _renderer(size=(40, 24))
    r.render()
    img = r.image()
    assert img.shape == (24, 40, 3)
    assert img.dtype == np.uint8


def test_param_change_resets_accumulation():
    r = _renderer()
    r.render()
    assert r.progress() == 1.0
    new_params = dataclasses.replace(r.params, sky=SkyParams(turbidity=7.0))
    assert r.set_render_params(new_params)
    assert r.progress() == 0.0
    assert r.render_frame()  # renders again after reset


def test_param_no_change_is_noop():
    r = _renderer()
    r.render()
    assert not r.set_render_params(r.params)
    assert r.progress() == 1.0  # untouched


def test_param_invalid_rejected():
    from weekend_raytracer import RenderParamsValidationError

    r = _renderer()
    bad = dataclasses.replace(
        r.params, sampling=SamplingParams(max_samples_per_pixel=7,
                                          num_samples_per_pixel=2),
    )
    with pytest.raises(RenderParamsValidationError):
        r.set_render_params(bad)


def test_viewport_resize_reallocates():
    r = _renderer(size=(32, 18))
    r.render()
    new_params = dataclasses.replace(r.params, viewport_size=(16, 10))
    r.set_render_params(new_params)
    r.render_frame()
    assert r.image().shape == (10, 16, 3)


def test_progressive_equals_oneshot():
    """4 frames x 2 spp must equal 1 frame x 8 spp statistically — and the
    mean over the same total sample count should agree closely (different
    RNG streams, same estimator)."""
    a = _renderer(max_spp=64, spp=2)
    a.render()
    b = _renderer(max_spp=64, spp=8)
    b.render()
    ia = a.image().astype(np.float32) / 255.0
    ib = b.image().astype(np.float32) / 255.0
    rmse = np.sqrt(np.mean((ia - ib) ** 2))
    assert rmse < 0.05  # Monte-Carlo agreement on display output, not bitwise


def test_render_deterministic():
    a = _renderer()
    a.render()
    b = _renderer()
    b.render()
    np.testing.assert_array_equal(np.asarray(a._accum), np.asarray(b._accum))


def test_checkpoint_resume(tmp_path):
    """Save mid-render, resume in a fresh renderer, converge identically."""
    a = _renderer(max_spp=8, spp=2)
    a.render_frame()
    a.render_frame()
    path = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(path)
    while a.render_frame():
        pass

    b = _renderer(max_spp=8, spp=2)
    b.load_checkpoint(path)
    assert b.accumulated_samples() == 4
    while b.render_frame():
        pass
    np.testing.assert_array_equal(np.asarray(a._accum), np.asarray(b._accum))


def test_checkpoint_viewport_mismatch(tmp_path):
    a = _renderer(size=(32, 18))
    a.render_frame()
    path = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(path)
    b = _renderer(size=(16, 10))
    with pytest.raises(ValueError):
        b.load_checkpoint(path)


def test_checkpoint_scene_mismatch(tmp_path):
    """A checkpoint saved for one scene must refuse to resume into a
    renderer with different scene/camera/sky state (VERDICT r1 #6)."""
    from weekend_raytracer import CheckpointMismatchError

    a = _renderer()
    a.render_frame()
    path = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(path)

    params = RenderParams(
        camera=scenes.rtiow_final_camera(),
        viewport_size=(32, 18),
        sampling=SamplingParams(max_samples_per_pixel=8,
                                num_samples_per_pixel=2, num_bounces=4),
    )
    b = Renderer(scenes.rtiow_final(), params)  # different scene + camera
    with pytest.raises(CheckpointMismatchError):
        b.load_checkpoint(path)

    # different bounce depth on the same scene also refuses
    c_params = dataclasses.replace(
        a.params, sampling=dataclasses.replace(a.params.sampling,
                                               num_bounces=6))
    c = Renderer(scenes.three_spheres(), c_params)
    with pytest.raises(CheckpointMismatchError):
        c.load_checkpoint(path)


def test_checkpoint_extends_spp(tmp_path):
    """Raising max spp on resume is supported (extends the render; sampling
    counts are deliberately outside the fingerprint)."""
    a = _renderer(max_spp=4, spp=2)
    a.render()
    path = str(tmp_path / "ckpt.npz")
    a.save_checkpoint(path)
    params = dataclasses.replace(
        a.params, sampling=dataclasses.replace(a.params.sampling,
                                               max_samples_per_pixel=8))
    b = Renderer(scenes.three_spheres(), params)
    b.load_checkpoint(path)
    assert b.accumulated_samples() == 4
    assert b.render_frame()  # continues past the old max


def test_render_stats_warmup():
    """rays_per_sec excludes the first (compile) frame; warmup recorded."""
    r = _renderer(max_spp=8, spp=2)
    stats = r.render()
    assert stats.frames == 4
    assert stats.warmup_seconds > 0
    assert stats.seconds >= stats.warmup_seconds
    assert stats.rays_per_sec > 0


# --- backend choice by platform ---

@pytest.mark.parametrize("backend,platform,want", [
    ("auto", "gpu", "triton"),
    ("auto", "cpu", "xla"),
    ("xla", "gpu", "xla"),
    ("xla", "cpu", "xla"),
    ("triton", "gpu", "triton"),
])
def test_resolve_backend(backend, platform, want):
    assert resolve_backend(backend, platform) == want


@pytest.mark.parametrize("platform", ["rocm", "metal", "cuda"])
def test_unsupported_platform_is_refused(platform):
    """Only the platform names JAX reports for a GPU and a CPU are
    supported; anything else is an error, never a default."""
    with pytest.raises(RenderParamsValidationError):
        resolve_backend("auto", platform)


@pytest.mark.parametrize("backend", ["mosaic", "interpret", "cpu", ""])
def test_unknown_backend_is_refused(backend):
    with pytest.raises(RenderParamsValidationError):
        resolve_backend(backend, "gpu")


def test_auto_picks_xla_on_cpu():
    r = _renderer()
    assert r.backend == "xla"
    assert r.render_frame()


def test_gpu_only_backend_refused_on_cpu():
    """An explicit backend that cannot run here raises up front; it never
    falls back to another backend or to interpret mode."""
    params = _renderer().params
    with pytest.raises(RenderParamsValidationError):
        Renderer(scenes.three_spheres(), params, backend="triton")


def test_set_render_params_keeps_the_platform_choice():
    r = _renderer()
    new = dataclasses.replace(
        r.params, sampling=dataclasses.replace(r.params.sampling,
                                               num_samples_per_pixel=4))
    assert r.set_render_params(new)
    assert r.backend == "xla"
    assert r.render_frame()


def test_checkpoint_fingerprint_ignores_backend():
    """Both backends draw the same per-sample paths, so a checkpoint saved
    under one resumes under the other."""
    r = _renderer()
    xla = r._fingerprint()
    r.backend = "triton"
    assert r._fingerprint() == xla


def test_sync_waits_for_queued_frames():
    r = _renderer(max_spp=4, spp=2)
    r.render_frame()
    r.render_frame()
    r.sync()
    assert r._accum.is_ready()
