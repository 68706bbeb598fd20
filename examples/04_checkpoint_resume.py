"""Interrupt a render, checkpoint it, resume in a fresh process-equivalent
Renderer, and verify the result is bit-identical to an uninterrupted run.

The checkpoint (.npz) carries the accumulator, the sample count, and a
fingerprint of everything that shaped it (scene, camera, sky, estimator,
texture budget); loading into a mismatched renderer is refused
(renderer.py:save_checkpoint/load_checkpoint).
"""

import numpy as np

from _common import parse_args


def main():
    parse_args("checkpoint/resume demo")
    from weekend_raytracer import (RenderParams, Renderer, SamplingParams,
                                       SCENES)

    build, camera = SCENES["demo"]
    scene = build()
    params = RenderParams(
        camera=camera(),
        viewport_size=(320, 240),
        sampling=SamplingParams(max_samples_per_pixel=16,
                                num_samples_per_pixel=4),
    )

    # Straight-through run (the control).
    control = Renderer(scene, params)
    control.render()

    # Interrupted run: stop halfway, checkpoint, resume elsewhere.
    first = Renderer(scene, params)
    while first.accumulated_samples() < 8:
        first.render_frame()
    first.sync()
    first.save_checkpoint("/tmp/example_ckpt.npz")
    print(f"checkpointed at {first.accumulated_samples()} spp")

    resumed = Renderer(scene, params)
    resumed.load_checkpoint("/tmp/example_ckpt.npz")
    resumed.render()
    print(f"resumed to {resumed.accumulated_samples()} spp")

    same = np.array_equal(control.image(), resumed.image())
    print("bit-identical to the uninterrupted render:", same)
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
