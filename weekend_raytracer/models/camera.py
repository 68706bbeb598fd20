"""Thin-lens camera: logical parameters and the derived device basis.

Capability parity with the reference's ``Camera`` (src/raytracer/mod.rs:487-541)
and ``GpuCamera::new`` (src/raytracer/mod.rs:699-741). The basis derivation is
the same math (w = normalized view dir, v = normalized up, u = w x v, image
plane at the focus distance so the lens-disk offset produces defocus blur);
the AoS padded layout of the reference disappears — on device the basis is a
small pytree of f32 arrays broadcast against ray batches.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .angle import Angle


@dataclasses.dataclass(frozen=True)
class Camera:
    """Logical camera: eye position/direction/up + lens parameters.

    Mirrors reference src/raytracer/mod.rs:487-541 (Camera::new).
    """

    eye_pos: Tuple[float, float, float]
    eye_dir: Tuple[float, float, float]
    up: Tuple[float, float, float]
    vfov: Angle
    aperture: float
    focus_distance: float

    @staticmethod
    def look_at(
        eye: Tuple[float, float, float],
        target: Tuple[float, float, float],
        up: Tuple[float, float, float] = (0.0, 1.0, 0.0),
        vfov_degrees: float = 30.0,
        aperture: float = 0.0,
        focus_distance: float | None = None,
    ) -> "Camera":
        """Camera aimed at ``target`` with ``up`` as the world-up hint.

        The basis derivation (CameraBasis.create, like the reference's
        GpuCamera::new) uses the stored up vector *as given*, so it must be
        orthogonal to the view direction — the reference guarantees this by
        construction in its fly camera (fly_camera.rs:236-239: right =
        forward x world_up, up = right x... forward). Orthogonalize the
        world-up hint here the same way; passing it through raw would shear
        the image plane for any elevated camera.
        """
        e = np.asarray(eye, dtype=np.float64)
        t = np.asarray(target, dtype=np.float64)
        d = t - e
        if focus_distance is None:
            focus_distance = float(np.linalg.norm(d))
        f = d / np.linalg.norm(d)
        right = np.cross(f, np.asarray(up, dtype=np.float64))
        right /= np.linalg.norm(right)
        up_ortho = np.cross(right, f)
        return Camera(
            eye_pos=tuple(float(x) for x in e),
            eye_dir=tuple(float(x) for x in d),
            up=tuple(float(x) for x in up_ortho),
            vfov=Angle.degrees(vfov_degrees),
            aperture=float(aperture),
            focus_distance=float(focus_distance),
        )


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class CameraBasis:
    """Device-side camera basis (reference GpuCamera, mod.rs:681-741).

    All fields are f32 arrays of shape [3] except lens_radius ([]).
    """

    eye: jnp.ndarray
    horizontal: jnp.ndarray
    vertical: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    lens_radius: jnp.ndarray
    lower_left_corner: jnp.ndarray

    def tree_flatten(self):
        return (
            (
                self.eye,
                self.horizontal,
                self.vertical,
                self.u,
                self.v,
                self.lens_radius,
                self.lower_left_corner,
            ),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @staticmethod
    def create(camera: Camera, viewport: Tuple[int, int]) -> "CameraBasis":
        """Derive the ray-generation basis (reference mod.rs:699-741).

        Computed in float64 on host for precision, stored as f32.
        """
        width, height = viewport
        lens_radius = 0.5 * camera.aperture
        aspect = float(width) / float(height)
        theta = camera.vfov.as_radians()
        half_height = camera.focus_distance * np.tan(0.5 * theta)
        half_width = aspect * half_height

        w = np.asarray(camera.eye_dir, dtype=np.float64)
        w = w / np.linalg.norm(w)
        v = np.asarray(camera.up, dtype=np.float64)
        v = v / np.linalg.norm(v)
        u = np.cross(w, v)

        eye = np.asarray(camera.eye_pos, dtype=np.float64)
        lower_left = eye + camera.focus_distance * w - half_width * u - half_height * v
        horizontal = 2.0 * half_width * u
        vertical = 2.0 * half_height * v

        f32 = lambda x: jnp.asarray(x, dtype=jnp.float32)
        return CameraBasis(
            eye=f32(eye),
            horizontal=f32(horizontal),
            vertical=f32(vertical),
            u=f32(u),
            v=f32(v),
            lens_radius=f32(lens_radius),
            lower_left_corner=f32(lower_left),
        )


def make_rays(
    basis: CameraBasis,
    su: jnp.ndarray,
    sv: jnp.ndarray,
    disk_r: jnp.ndarray,
    disk_alpha: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Generate thin-lens camera rays for a batch of screen samples.

    Parity with cameraMakeRay (reference raytracer.wgsl:456-464) plus the
    unit-disk lens sample (wgsl:466-478). ``su``/``sv`` in [0,1] are screen
    coordinates (sv already flipped by the caller, wgsl:117 uses 1-v);
    ``disk_r``/``disk_alpha`` are uniform [0,1) random draws.

    Returns (origins [N,3], directions [N,3]); directions are normalized
    (the reference leaves them unnormalized and divides by dot(d,d) in the
    quadratic — normalizing is equivalent geometry with better numerics).
    """
    r = jnp.sqrt(disk_r)
    alpha = (2.0 * jnp.pi) * disk_alpha
    lens_x = basis.lens_radius * r * jnp.cos(alpha)
    lens_y = basis.lens_radius * r * jnp.sin(alpha)

    offset = lens_x[:, None] * basis.u[None, :] + lens_y[:, None] * basis.v[None, :]
    origin = basis.eye[None, :] + offset
    direction = (
        basis.lower_left_corner[None, :]
        + su[:, None] * basis.horizontal[None, :]
        + sv[:, None] * basis.vertical[None, :]
        - origin
    )
    direction = direction / jnp.linalg.norm(direction, axis=-1, keepdims=True)
    return origin, direction
