"""Sphere scene geometry as structure-of-arrays device data.

Capability parity with the reference's ``Sphere`` (src/raytracer/mod.rs:418-431:
a 32-byte padded AoS struct matching the WGSL layout, raytracer.wgsl:358-362).
On device the explicit-padding layout contract disappears: spheres are SoA
f32 arrays, the natural layout for vectorized lanes and for sphere-chunked
intersection scans.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Sphere:
    """Host-side sphere description (reference Sphere::new, mod.rs:423-431)."""

    center: Tuple[float, float, float]
    radius: float
    material_idx: int


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SphereSoA:
    """Device sphere arrays: centers [S,3] f32, radii [S] f32, mats [S] i32."""

    centers: jnp.ndarray
    radii: jnp.ndarray
    material_idx: jnp.ndarray

    def tree_flatten(self):
        return ((self.centers, self.radii, self.material_idx), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def num_spheres(self) -> int:
        return int(self.centers.shape[0])

    @staticmethod
    def build(spheres: Sequence[Sphere], pad_to: int | None = None) -> "SphereSoA":
        """Lower a sphere list to SoA arrays.

        ``pad_to`` optionally pads the arrays to a fixed size with
        impossible-to-hit spheres (radius 0 at a far distance), keeping
        shapes static across scenes of different sizes for jit-cache reuse
        and lane alignment.
        """
        centers = np.asarray([s.center for s in spheres], dtype=np.float32)
        radii = np.asarray([s.radius for s in spheres], dtype=np.float32)
        mats = np.asarray([s.material_idx for s in spheres], dtype=np.int32)
        n = len(spheres)
        if pad_to is not None and pad_to > n:
            pad = pad_to - n
            centers = np.concatenate(
                [centers, np.full((pad, 3), 1.0e8, dtype=np.float32)], axis=0
            )
            radii = np.concatenate([radii, np.zeros((pad,), dtype=np.float32)])
            mats = np.concatenate([mats, np.zeros((pad,), dtype=np.int32)])
        return SphereSoA(
            centers=jnp.asarray(centers),
            radii=jnp.asarray(radii),
            material_idx=jnp.asarray(mats),
        )
