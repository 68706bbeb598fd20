"""Full benchmark ladder (BASELINE.md configs) — one JSON line per config.

    python benchmarks/ladder.py [--quick] [--configs 1,3] [--backend xla]

Configs:
 1. single-sphere 400x225 @ 100 spp (CPU-oracle parity scene)
 2. three-sphere lambertian/metal/dielectric, 1280x720, deep bounces
 3. RTiOW final (~480 spheres), 1920x1080 @ 500 spp
 4. textured earth/moon (image textures, per-lane texel gathers)
 5. 10k-sphere scene at 3840x2160

Every line names the device it ran on and the backend. Exits non-zero,
printing no result, when JAX finds no GPU.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Timing-methodology revision, stamped into every result row so rows from
# different harnesses are distinguishable. Bump when run_config's protocol
# or any config's shape/spp/fold changes.
HARNESS = "h1"


def run_config(name, desc, cam, size, spp, spp_frame, bounces, backend):
    from weekend_raytracer import RenderParams, Renderer, SamplingParams
    from weekend_raytracer.utils.metrics import device_stamp

    params = RenderParams(
        camera=cam,
        viewport_size=size,
        sampling=SamplingParams(
            max_samples_per_pixel=spp,
            num_samples_per_pixel=spp_frame,
            num_bounces=bounces,
        ),
    )
    r = Renderer(desc, params, backend=backend)
    t0 = time.perf_counter()
    r.render_frame()
    r.sync()  # exclude compile
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = 0
    while r.render_frame():
        frames += 1
    r.sync()
    dt = time.perf_counter() - t0
    spp_timed = frames * spp_frame
    segments = size[0] * size[1] * spp_timed * bounces
    print(json.dumps({
        "config": name,
        "harness": HARNESS,
        **device_stamp(r.backend),
        "sky": r.sky_model(),
        "size": list(size),
        "spheres": desc.num_spheres,
        "spp": spp,
        "bounces": bounces,
        "first_frame_seconds": first,
        "seconds_timed": dt,
        "spp_timed": spp_timed,
        "segments_per_sec": segments / dt,
        "seconds_to_full_spp": dt * spp / max(spp_timed, 1),
    }), flush=True)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="reduced spp/resolution for smoke runs")
    p.add_argument("--configs", default="1,2,3,4,5")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "triton"])
    args = p.parse_args()
    q = args.quick
    want = {int(c) for c in args.configs.split(",")}

    from weekend_raytracer.models import scenes
    from weekend_raytracer.utils.metrics import NoGpuError, require_gpu

    try:
        require_gpu()
    except NoGpuError as e:
        print(f"ladder: {e}", file=sys.stderr)
        return 1

    run = functools.partial(run_config, backend=args.backend)
    if 1 in want:
        run("1-single-400x225", scenes.single_sphere(),
            scenes.single_sphere_camera(), (400, 225), 16 if q else 100, 4, 8)
    if 2 in want:
        run("2-three-720p-deep", scenes.three_spheres(),
            scenes.three_spheres_camera(), (1280, 720),
            16 if q else 128, 4 if q else 32, 10)
    if 3 in want:
        run("3-rtiow-1080p", scenes.rtiow_final(),
            scenes.rtiow_final_camera(), (1920, 1080), 20 if q else 500, 4, 8)
    if 4 in want:
        run("4-textured-1080p", scenes.textured_spheres(),
            scenes.textured_spheres_camera(),
            (640, 360) if q else (1920, 1080), 8 if q else 100, 4, 8)
    if 5 in want:
        run("5-random10k-4k", scenes.random_spheres(10000),
            scenes.random_spheres_camera(),
            (960, 540) if q else (3840, 2160), 8 if q else 64,
            4 if q else 8, 8)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
