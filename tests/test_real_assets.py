"""Real image-asset validation against the reference's shipped JPEGs.

The reference loads assets/earthmap.jpeg and assets/moon.jpeg at startup
(src/main.rs:515-547) through Texture::new_from_image
(src/raytracer/texture.rs:21-46: decode -> RGBA -> normalized float RGB).
Every other texture test in this repo runs on procedural stand-ins; these
tests exercise the REAL decode + full-res XLA sampling on the actual
reference assets.

Skipped when the reference checkout (or PIL's JPEG decoder) is absent so
the suite stays self-contained.
"""
import os

import numpy as np
import pytest

ASSETS = "/root/reference/assets"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(ASSETS), reason="reference assets not available")


def _load(name):
    from weekend_raytracer.models.textures import Texture

    try:
        return Texture.from_image(os.path.join(ASSETS, name))
    except ImportError:
        pytest.skip("PIL not available")


def test_earthmap_decode_matches_reference_semantics():
    """texture.rs:21-46: dimensions preserved, float RGB in [0, 1] =
    u8 / 255 exactly; the RTiOW earth map is 1024x512 and ocean-blue
    dominant."""
    tex = _load("earthmap.jpeg")
    assert (tex.width, tex.height) == (1024, 512)
    assert tex.data.dtype == np.float32
    assert tex.data.min() >= 0.0 and tex.data.max() <= 1.0
    # u8/255 quantization: every value is k/255 for integer k
    k = tex.data * 255.0
    assert np.allclose(k, np.round(k), atol=1e-4)
    mean = tex.mean_rgb
    assert mean[2] > mean[0]  # oceans: blue channel dominates red


def test_moon_decode_matches_reference_semantics():
    tex = _load("moon.jpeg")
    assert (tex.width, tex.height) == (1024, 512)
    assert tex.data.min() >= 0.0 and tex.data.max() <= 1.0
    mean = tex.mean_rgb
    # the NASA SVS moon map is gray: channel means agree within ~15%
    assert np.ptp(mean) < 0.15 * max(mean.max(), 1e-6)


@pytest.fixture(scope="module")
def real_demo():
    """The reference's demo scene with the REAL assets (the --assets
    CLI path, scenes.reference_demo(assets_dir=...))."""
    from weekend_raytracer.models import scenes

    try:
        desc = scenes.reference_demo(assets_dir=ASSETS)
    except ImportError:
        pytest.skip("PIL not available")
    # the real images, not procedural stand-ins, must be in the pool
    earth = desc.materials[4].tex1
    assert (earth.width, earth.height) == (1024, 512)
    return desc, scenes.reference_demo_camera()


def test_real_assets_render_xla_vs_oracle(real_demo):
    """Full-res XLA texture sampling on the real JPEGs matches the
    NumPy oracle (shared RNG draws; last-ulp MC divergence bounded the
    standard way, tests/test_tracer.py)."""
    import jax.numpy as jnp

    from weekend_raytracer import CameraBasis
    from weekend_raytracer.models.sky import SkyParams, to_sky_state
    from weekend_raytracer.ops.tracer import render_pixels

    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from oracle_np import OracleTracer

    desc, cam = real_demo
    w, h, spp, bounces = 48, 27, 2, 4
    scene = desc.build()
    basis = CameraBasis.create(cam, (w, h))
    sky = to_sky_state(SkyParams())
    idx = jnp.arange(w * h, dtype=jnp.int32)
    acc = render_pixels(idx, jnp.uint32(0), scene, sky, basis, w, h,
                        spp, bounces)
    got = np.asarray(acc).reshape(h, w, 3) / spp
    want = OracleTracer(desc, cam, w, h).render(spp, bounces) / spp
    close = np.isclose(got, want, rtol=1e-2, atol=1e-3).all(axis=-1)
    assert close.mean() > 0.98, close.mean()
    assert float(np.sqrt(np.mean((got[close] - want[close]) ** 2))) < 1e-4
