"""Smoke test: the path tracer's main path on NVIDIA GPUs, in one process.

    python chip_smoke.py             # one card: phases 1-6 below
    python chip_smoke.py --cards 4   # four cards: the mesh phase only

Phases (any failure exits non-zero; the JSON result line is printed only
when every phase passed):

 1. JAX's default backend must be a GPU. Nothing falls back to the CPU.
 2. The card's name and power limit, from nvidia-smi.
 3. RTiOW final scene, 1920x1080, 8 bounces, through Renderer(backend=
    "auto"): finite and non-trivial. Then the comparisons below.
 4. random10k (the chunked closest-hit branch of the XLA path) and the
    textured scene (per-lane texel gathers), a few frames each.
 5. The CLI, in-process, renders RTiOW 1080p to a PNG and saves a
    checkpoint; a second run resumes it.
 6. Warm frame time and path segments per second of every timed render.

Comparisons and their tolerances. The paths share RNG draws, but acos,
atan2, sqrt and division implementations and FMA contraction differ, and
Monte Carlo paths diverge at silhouettes under last-ulp differences, so
the per-pixel bar is loose: at least 98% of pixels within rtol 1e-2 and
atol 1e-3.

 - XLA path on the GPU vs the NumPy oracle (reference.py), 64x36, 4 spp,
   every scene in SCENES.
 - Every GPU backend other than XLA vs the XLA path at full width, one
   frame from the same seed: the per-pixel bar and image-mean radiance
   within 1e-3 (relative). RTiOW at 4 spp; random10k at 1 spp, so that
   each pixel is one path and the bar counts paths.
 - random10k vs the oracle: the ground is a sphere of radius 1e4, where
   f32 cancellation in |o - c|^2 - r^2 puts ~1e-4 relative noise on t and
   flips checker parity near boundaries; no two f32 implementations agree
   on it (an f32 and an f64 oracle agree on only ~92% of its paths). Its
   bar: 1 spp, at least 90% of pixels within the per-pixel tolerance and
   image means within 1e-2.

With --cards 4, one process drives four cards:
 - a tiles=4 mesh vs a one-card render of the same frames, at the
   per-pixel bar;
 - a tiles=2 x spp=2 mesh, whose psum crosses cards, vs the one-card
   render on the image-mean radiance (independent sample streams:
   within 5e-3 relative);
 - the XLA path on a tiles=4 mesh at 3840x2160, with each card's peak
   memory (its intersect intermediates scale with the pixel batch).

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

PIXEL_RTOL, PIXEL_ATOL = 1e-2, 1e-3
PIXEL_BAR = 0.98
MEAN_BAR = 1e-3
# random10k vs the oracle (f32 noise on the radius-1e4 ground; see above)
NOISY_PIXEL_BAR, NOISY_MEAN_BAR = 0.90, 1e-2
SPP_MESH_MEAN_BAR = 5e-3


class SmokeFailure(AssertionError):
    pass


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _agreement(got: np.ndarray, want: np.ndarray) -> dict:
    close = np.isclose(got, want, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
    return {
        "pixels_close": float(close.mean()),
        "mean_rel_diff": float(abs(got.mean() - want.mean())
                               / max(abs(want.mean()), 1e-12)),
    }


class Smoke:
    """The phases; ``size`` is the full width of the timed renders."""

    def __init__(self, card: str, size=(1920, 1080)):
        self.card = card
        self.size = tuple(size)

    def emit(self, **fields) -> None:
        print(json.dumps({**fields, "card": self.card}), flush=True)

    def params(self, scene: str, size, spp_frame: int, frames: int,
               bounces: int = 8):
        from weekend_raytracer import RenderParams, SamplingParams
        from weekend_raytracer.models import scenes

        return RenderParams(
            camera=scenes.SCENES[scene][1](),
            viewport_size=tuple(size),
            sampling=SamplingParams(
                max_samples_per_pixel=spp_frame * frames,
                num_samples_per_pixel=spp_frame,
                num_bounces=bounces,
            ),
        )

    def renderer(self, scene: str, params, backend="auto", mesh=None):
        from weekend_raytracer import Renderer
        from weekend_raytracer.models import scenes

        return Renderer(scenes.SCENES[scene][0](), params, backend=backend,
                        mesh=mesh)

    def timed_render(self, scene: str, size, spp_frame: int, frames: int,
                     backend="auto", mesh=None):
        """Render to convergence; check the image; report its timing."""
        r = self.renderer(scene, self.params(scene, size, spp_frame, frames),
                          backend, mesh)
        stats = r.render()
        img = np.asarray(r.mean_radiance())
        _check(img.shape == (size[1], size[0], 3), f"{scene}: image shape")
        _check(bool(np.isfinite(img).all()), f"{scene}: non-finite pixels")
        _check(float(img.mean()) > 1e-3 and float(img.std()) > 1e-3,
               f"{scene}: trivial image")
        warm_frames = max(stats.frames - 1, 1)
        self.emit(phase="render", scene=scene, size=list(size),
                  backend=r.backend,
                  devices=1 if mesh is None else int(mesh.devices.size),
                  frames=stats.frames, spp=stats.samples_per_pixel,
                  first_frame_seconds=stats.warmup_seconds,
                  warm_frame_seconds=(stats.seconds - stats.warmup_seconds)
                  / warm_frames,
                  path_segments_per_sec=stats.rays_per_sec)
        return r

    def one_frame(self, scene: str, size, spp: int, backend: str,
                  mesh=None) -> np.ndarray:
        r = self.renderer(scene, self.params(scene, size, spp, 1), backend,
                          mesh)
        r.render_frame()
        return np.asarray(r.mean_radiance())

    def compare(self, what: str, got, want, pixel_bar=PIXEL_BAR,
                mean_bar=MEAN_BAR, **fields) -> None:
        a = _agreement(got, want)
        ok = a["pixels_close"] >= pixel_bar and a["mean_rel_diff"] <= mean_bar
        self.emit(phase="compare", what=what, **fields, **a,
                  pixel_bar=pixel_bar, mean_bar=mean_bar, passed=ok)
        _check(ok, f"{what}: {a}")

    # -- one card ---------------------------------------------------------

    def oracle_parity(self) -> None:
        from weekend_raytracer.models import scenes
        from weekend_raytracer.reference import OracleTracer

        w, h = 64, 36
        for name, (build, cam) in scenes.SCENES.items():
            noisy = name == "random10k"
            spp = 1 if noisy else 4
            got = self.one_frame(name, (w, h), spp, "xla")
            want = OracleTracer(build(), cam(), w, h).render(spp, 8) / spp
            self.compare(
                "xla_vs_oracle", got, want, scene=name, size=[w, h], spp=spp,
                **({"pixel_bar": NOISY_PIXEL_BAR, "mean_bar": NOISY_MEAN_BAR}
                   if noisy else {}))

    def backend_parity(self, scene: str, size, spp: int) -> None:
        from weekend_raytracer.renderer import BACKENDS

        ref = self.one_frame(scene, size, spp, "xla")
        for backend in BACKENDS:
            if backend != "xla":
                got = self.one_frame(scene, size, spp, backend)
                self.compare(f"{backend}_vs_xla", got, ref, scene=scene,
                             size=list(size), spp=spp)

    def cli_and_checkpoint(self) -> None:
        from weekend_raytracer import cli

        w, h = self.size
        with tempfile.TemporaryDirectory() as tmp:
            png = os.path.join(tmp, "rtiow.png")
            ckpt = os.path.join(tmp, "rtiow.npz")
            base = ["--scene", "rtiow", "--size", f"{w}x{h}",
                    "--spp-per-frame", "4", "--bounces", "8", "-o", png,
                    "--checkpoint", ckpt, "--stats-json"]
            _check(cli.main(base + ["--spp", "8"]) == 0, "cli: first run")
            _check(os.path.getsize(png) > 0, "cli: no PNG written")
            _check(cli.main(base + ["--spp", "16"]) == 0, "cli: resume run")
            with np.load(ckpt) as data:
                resumed = np.asarray(data["accum"]) / 16
                _check(int(data["accumulated_spp"]) == 16,
                       "cli: resumed checkpoint did not reach 16 spp")
            straight = self.renderer(
                "rtiow", self.params("rtiow", self.size, 4, 4))
            straight.render()
            got = np.asarray(straight.mean_radiance()).reshape(-1, 3)
            self.compare("checkpoint_resume_vs_straight", resumed, got,
                         scene="rtiow", size=[w, h], spp=16)

    def one_card(self) -> None:
        self.timed_render("rtiow", self.size, 4, 4)
        self.oracle_parity()
        self.backend_parity("rtiow", self.size, 4)
        self.timed_render("random10k", self.size, 4, 3)
        self.backend_parity("random10k", self.size, 1)
        self.timed_render("textured", self.size, 4, 4)
        self.backend_parity("textured", self.size, 4)
        self.cli_and_checkpoint()

    # -- four cards -------------------------------------------------------

    def mesh(self, cards: int) -> None:
        import jax

        from weekend_raytracer.parallel.sharding import make_mesh

        devices = jax.devices()
        _check(len(devices) >= cards, f"need {cards} cards, have "
               f"{len(devices)}")
        devices = devices[:cards]
        size = self.size
        single = self.timed_render("rtiow", size, 4, 4)
        want = np.asarray(single.mean_radiance())

        tiles = make_mesh(devices, tile_shards=cards, spp_shards=1)
        got = np.asarray(self.timed_render("rtiow", size, 4, 4,
                                           mesh=tiles).mean_radiance())
        self.compare(f"tiles{cards}_vs_one_card", got, want, scene="rtiow",
                     size=list(size), spp=16)

        split = make_mesh(devices, tile_shards=cards // 2, spp_shards=2)
        got = np.asarray(self.timed_render("rtiow", size, 4, 4,
                                           mesh=split).mean_radiance())
        self.compare(f"tiles{cards // 2}x_spp2_vs_one_card", got, want,
                     pixel_bar=0.0, mean_bar=SPP_MESH_MEAN_BAR,
                     scene="rtiow", size=list(size), spp=16)

        big = (2 * size[0], 2 * size[1])
        self.timed_render("rtiow", big, 4, 2, backend="xla", mesh=tiles)
        self.emit(phase="memory", scene="rtiow", size=list(big),
                  backend="xla", devices=cards,
                  peak_bytes_in_use=[d.memory_stats()["peak_bytes_in_use"]
                                     for d in devices])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cards", type=int, default=1, choices=[1, 4],
                   help="4: run only the four-card mesh phase")
    args = p.parse_args(argv)

    import jax

    from weekend_raytracer.utils.metrics import (
        NoGpuError,
        card_name_and_power_limit,
        require_gpu,
    )

    try:
        require_gpu()
    except NoGpuError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1

    card = card_name_and_power_limit()
    print(f"card: {card}", flush=True)
    smoke = Smoke(card)
    try:
        if args.cards == 1:
            smoke.one_card()
        else:
            smoke.mesh(args.cards)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    dev = jax.devices()[0]
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
