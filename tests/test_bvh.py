"""Morton-chunk acceleration structure tests (ops/bvh.py)."""
import jax.numpy as jnp
import numpy as np

from weekend_raytracer.ops.bvh import (
    build_chunks,
    morton_codes,
    order_front_to_back,
    super_bounds,
)


def _attrs(n, seed=0):
    rs = np.random.RandomState(seed)
    c = (rs.rand(n, 3) * 20 - 10).astype(np.float32)
    r = rs.uniform(0.1, 0.5, n).astype(np.float32)
    extra = [rs.rand(n).astype(np.float32) for _ in range(8)]
    return tuple(jnp.asarray(a) for a in
                 (c[:, 0], c[:, 1], c[:, 2], r, *extra))


def test_morton_locality():
    """Morton-adjacent codes correspond to spatially nearby points."""
    attrs = _attrs(512)
    lo = jnp.array([-10.0, -10.0, -10.0])
    hi = jnp.array([10.0, 10.0, 10.0])
    codes = np.asarray(morton_codes(attrs[0], attrs[1], attrs[2], lo, hi))
    order = np.argsort(codes)
    pts = np.stack([np.asarray(a) for a in attrs[:3]], 1)[order]
    step = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    rs = np.random.RandomState(1)
    rand_pairs = np.linalg.norm(
        pts[rs.permutation(512)] - pts[rs.permutation(512)], axis=1)
    assert step.mean() < 0.5 * rand_pairs.mean()


def test_chunks_are_permutation_and_conservative():
    n, cs = 500, 32
    attrs = _attrs(n)
    scene = build_chunks(attrs, cs)
    s = scene.attrs[0].shape[0]
    assert s % cs == 0 and s >= n
    # every original sphere present (attrs[4] is a unique-ish random tag)
    orig = set(np.asarray(attrs[4]).round(6).tolist())
    got = set(np.asarray(scene.attrs[4]).round(6).tolist())
    assert orig == got
    # chunk AABBs contain every member sphere entirely
    nc = s // cs
    cx = np.asarray(scene.attrs[0]).reshape(nc, cs)
    cy = np.asarray(scene.attrs[1]).reshape(nc, cs)
    cz = np.asarray(scene.attrs[2]).reshape(nc, cs)
    cr = np.abs(np.asarray(scene.attrs[3]).reshape(nc, cs))
    lox, loy, loz, hix, hiy, hiz = (np.asarray(b) for b in scene.bounds)
    tol = 1e-4
    assert (cx - cr >= lox[:, None] - tol).all()
    assert (cy - cr >= loy[:, None] - tol).all()
    assert (cz - cr >= loz[:, None] - tol).all()
    assert (cx + cr <= hix[:, None] + tol).all()
    assert (cy + cr <= hiy[:, None] + tol).all()
    assert (cz + cr <= hiz[:, None] + tol).all()


def test_front_to_back_ordering():
    attrs = _attrs(256)
    scene = build_chunks(attrs, 32)
    eye = jnp.array([0.0, 0.0, -50.0])
    ordered = order_front_to_back(scene, eye, 32)
    ocx = 0.5 * (np.asarray(ordered.bounds[0]) + np.asarray(ordered.bounds[3]))
    ocy = 0.5 * (np.asarray(ordered.bounds[1]) + np.asarray(ordered.bounds[4]))
    ocz = 0.5 * (np.asarray(ordered.bounds[2]) + np.asarray(ordered.bounds[5]))
    d2 = ocx ** 2 + ocy ** 2 + (ocz + 50.0) ** 2
    assert (np.diff(d2) >= -1e-3).all()
    # same sphere set, same chunk bound multiset
    np.testing.assert_allclose(
        sorted(np.asarray(scene.bounds[0]).tolist()),
        sorted(np.asarray(ordered.bounds[0]).tolist()), rtol=1e-6)


def test_super_bounds_conservative():
    attrs = _attrs(1024)
    scene = build_chunks(attrs, 32)
    padded, supers = super_bounds(scene, 8)
    assert padded[0].shape[0] % 8 == 0
    nsc = padded[0].shape[0] // 8
    for axis in range(3):
        clo = np.asarray(padded[axis]).reshape(nsc, 8)
        chi = np.asarray(padded[3 + axis]).reshape(nsc, 8)
        real = clo <= chi  # skip inverted (padding) boxes
        slo = np.asarray(supers[axis])[:, None].repeat(8, 1)
        shi = np.asarray(supers[3 + axis])[:, None].repeat(8, 1)
        assert (clo[real] >= slo[real] - 1e-4).all()
        assert (chi[real] <= shi[real] + 1e-4).all()


def test_super_bounds_padding_is_degenerate_far_box():
    """Pad chunks must be zero-extent far boxes (lo == hi == 1e9), never
    inverted boxes: a slab test that min/max-normalizes an inverted box
    turns it into an infinite one that always passes, and a sweep would
    then read sphere attributes out of bounds."""
    attrs = _attrs(330)  # 330/32 -> 11 chunks, padded to 16 for factor 8
    scene = build_chunks(attrs, 32)
    padded, supers = super_bounds(scene, 8)
    nc_real = scene.bounds[0].shape[0]
    for lo_arr, hi_arr in zip(padded[:3], padded[3:]):
        lo_pad = np.asarray(lo_arr)[nc_real:]
        hi_pad = np.asarray(hi_arr)[nc_real:]
        assert (lo_pad == hi_pad).all()
        assert (lo_pad >= 1e8).all()
