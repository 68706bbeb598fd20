"""Native host runtime (csrc/wrt_host.cpp) vs Python fallbacks."""
import os

import numpy as np
import pytest

from weekend_raytracer.utils import native


def test_library_builds_and_loads():
    assert native.available(), "libwrt_host.so should build via csrc/Makefile"


def test_tonemap_matches_device_path():
    import jax.numpy as jnp

    from weekend_raytracer.ops.tonemap import to_srgb_u8

    rs = np.random.RandomState(0)
    x = (rs.rand(64, 32, 3) * 20.0).astype(np.float32)
    want = np.asarray(to_srgb_u8(jnp.asarray(x)))
    got = native.tonemap_u8(x)
    # identical up to 1 ulp of the u8 quantizer (pow differs in libm vs XLA)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_morton_argsort_matches_jnp():
    import jax.numpy as jnp

    from weekend_raytracer.ops.bvh import morton_codes

    rs = np.random.RandomState(1)
    c = (rs.rand(500, 3) * 100 - 50).astype(np.float32)
    order = native.morton_argsort(c)
    assert sorted(order.tolist()) == list(range(500))
    lo = np.percentile(c, 5, axis=0).astype(np.float32)
    hi = np.percentile(c, 95, axis=0).astype(np.float32)
    codes = np.asarray(morton_codes(
        jnp.asarray(c[:, 0]), jnp.asarray(c[:, 1]), jnp.asarray(c[:, 2]),
        jnp.asarray(lo), jnp.asarray(hi)))
    sorted_codes = codes[order]
    assert (np.diff(sorted_codes.astype(np.int64)) >= 0).all()


def test_halfblock_render_matches_python():
    from weekend_raytracer.interactive.viewer import _halfblock_frame

    rs = np.random.RandomState(2)
    img = (rs.rand(8, 6, 3) * 255).astype(np.uint8)
    got = native.halfblock_render(img)
    want = _halfblock_frame(img) + "\n"
    assert got == want


def test_write_ppm_roundtrip(tmp_path):
    rs = np.random.RandomState(3)
    img = (rs.rand(10, 7, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "x.ppm")
    native.write_ppm(p, img)
    with open(p, "rb") as f:
        data = f.read()
    assert data.startswith(b"P6\n7 10\n255\n")
    back = np.frombuffer(data.split(b"255\n", 1)[1], dtype=np.uint8)
    np.testing.assert_array_equal(back.reshape(10, 7, 3), img)
