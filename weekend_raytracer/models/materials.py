"""Material model: tagged variants lowered to SoA device tables.

Capability parity with the reference's ``Material`` enum and ``GpuMaterial``
lowering (src/raytracer/mod.rs:433-438, 757-886): four physical variants
(lambertian / metal / dielectric / checkerboard) plus the aggressive-pink
error material for unknown ids (raytracer.wgsl:309-314).

The reference packs each material as a 32-byte tagged struct
{id, desc1, desc2, x}; on device the table is SoA: one int32 id array, two
[M, 3] int32 texture-descriptor arrays, one f32 extra-scalar array.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .textures import Texture, TexturePool

# Material ids (reference raytracer.wgsl:174-202 switch arms).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
CHECKERBOARD = 3
# Beyond-reference (BASELINE.md config 4: emissive light): a diffuse area
# light — paths terminate on hit and pick up x * albedo radiance.
EMISSIVE = 4

# Unknown-material signal color (raytracer.wgsl:312).
ERROR_PINK = (0.9921, 0.24705, 0.57254)

_WHITE = Texture.from_color((1.0, 1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class Material:
    """One material variant; use the constructors below."""

    id: int
    tex1: Texture
    tex2: Texture
    x: float

    @staticmethod
    def lambertian(albedo: Texture | Tuple[float, float, float]) -> "Material":
        return Material(LAMBERTIAN, _as_tex(albedo), _WHITE, 0.0)

    @staticmethod
    def metal(albedo: Texture | Tuple[float, float, float], fuzz: float) -> "Material":
        return Material(METAL, _as_tex(albedo), _WHITE, float(fuzz))

    @staticmethod
    def dielectric(refraction_index: float) -> "Material":
        return Material(DIELECTRIC, _WHITE, _WHITE, float(refraction_index))

    @staticmethod
    def checkerboard(
        even: Texture | Tuple[float, float, float],
        odd: Texture | Tuple[float, float, float],
    ) -> "Material":
        return Material(CHECKERBOARD, _as_tex(even), _as_tex(odd), 0.0)

    @staticmethod
    def emissive(
        color: Texture | Tuple[float, float, float], intensity: float = 1.0
    ) -> "Material":
        return Material(EMISSIVE, _as_tex(color), _WHITE, float(intensity))


def _as_tex(t) -> Texture:
    return t if isinstance(t, Texture) else Texture.from_color(t)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """SoA device material table + flattened texture pool."""

    ids: jnp.ndarray  # i32 [M]
    tex1: jnp.ndarray  # i32 [M, 3]  (width, height, offset)
    tex2: jnp.ndarray  # i32 [M, 3]
    x: jnp.ndarray  # f32 [M]    (fuzz for metal, ior for dielectric)
    pool: jnp.ndarray  # f32 [P, 3]  global texture pool

    def tree_flatten(self):
        return ((self.ids, self.tex1, self.tex2, self.x, self.pool), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def num_materials(self) -> int:
        return int(self.ids.shape[0])

    @staticmethod
    def build(materials: List[Material], pool: Optional[TexturePool] = None) -> "MaterialTable":
        """Lower a material list to device arrays (reference mod.rs:757-830)."""
        pool = pool or TexturePool()
        ids, t1, t2, xs = [], [], [], []
        for m in materials:
            ids.append(m.id)
            t1.append(pool.add(m.tex1))
            t2.append(pool.add(m.tex2))
            xs.append(m.x)
        return MaterialTable(
            ids=jnp.asarray(np.asarray(ids, dtype=np.int32)),
            tex1=jnp.asarray(np.asarray(t1, dtype=np.int32)),
            tex2=jnp.asarray(np.asarray(t2, dtype=np.int32)),
            x=jnp.asarray(np.asarray(xs, dtype=np.float32)),
            pool=jnp.asarray(pool.build()),
        )
