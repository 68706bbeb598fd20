"""Headline benchmark: path segments/sec on the RTiOW final scene at 1080p.

Prints ONE JSON line: {"metric", "value", "unit", ...} stamped with the
device (platform, device_kind, card name and power limit) and backend.
Exits non-zero, printing no result, when JAX finds no GPU.

A path segment is one bounce of one sample (pixels x spp x bounces): the
tracer performs the full bounce budget of scene-intersection + scatter
work per sample, matching how the reference counts its implied ray budget
(SURVEY.md §6).

    python bench.py            # WRT_BENCH_BACKEND=xla|triton overrides auto
"""
from __future__ import annotations

import json
import os
import sys
import time


def main() -> int:
    from weekend_raytracer import RenderParams, Renderer, SamplingParams
    from weekend_raytracer.models import scenes
    from weekend_raytracer.utils.metrics import (
        NoGpuError,
        device_stamp,
        profiler_trace,
        require_gpu,
    )

    try:
        require_gpu()
    except NoGpuError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1

    width, height = 1920, 1080
    # 96 total keeps divisibility; seconds_per_100spp_frame below
    # normalizes to the 100-spp workload of BASELINE.md.
    spp_total = 96
    spp_frame = 32
    bounces = 8

    params = RenderParams(
        camera=scenes.rtiow_final_camera(),
        viewport_size=(width, height),
        sampling=SamplingParams(
            max_samples_per_pixel=spp_total,
            num_samples_per_pixel=spp_frame,
            num_bounces=bounces,
        ),
    )
    desc = scenes.rtiow_final()
    renderer = Renderer(desc, params,
                        backend=os.environ.get("WRT_BENCH_BACKEND", "auto"))

    # Warmup: compile + one frame.
    t0 = time.perf_counter()
    renderer.render_frame()
    renderer.sync()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    frames = 0
    with profiler_trace(os.environ.get("WRT_PROFILE_DIR")):
        while renderer.render_frame():
            frames += 1
        renderer.sync()
    dt = time.perf_counter() - t0

    spp_timed = frames * spp_frame
    segments = width * height * spp_timed * bounces
    result = {
        "metric": "path segments/sec (RTiOW final scene, 1080p, 8 bounces)",
        "value": segments / dt,
        "unit": "segments/s",
        **device_stamp(renderer.backend),
        # which sky actually rendered (exact HW dataset vs built-in fit)
        "sky": renderer.sky_model(),
        "first_frame_seconds": compile_s,
        "seconds_per_100spp_frame": dt * (100 / spp_timed),
        "spheres": desc.num_spheres,
        "spp_timed": spp_timed,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
