"""Headless renderer CLI.

The reference has no CLI (all configuration is hardcoded or interactive,
SURVEY.md §5); this is the rebuild's declarative front door:

    python -m weekend_raytracer.cli --scene rtiow --size 1920x1080 \
        --spp 100 --bounces 8 -o out.png

Scenes: demo | single | three | rtiow | textured | random10k.
"""
from __future__ import annotations

import argparse
import json
import sys


def parse_size(s: str):
    w, h = s.lower().split("x")
    return int(w), int(h)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="demo", help="scene name or 'list'")
    p.add_argument("--size", type=parse_size, default=(800, 600),
                   help="WIDTHxHEIGHT (default 800x600, the reference window)")
    p.add_argument("--spp", type=int, default=128, help="total samples/pixel")
    p.add_argument("--spp-per-frame", type=int, default=None,
                   help="samples per progressive frame (default: min(4, spp))")
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "triton"],
                   help="auto: triton on a GPU, xla on a CPU")
    p.add_argument("--assets", default=None, help="dir with earthmap/moon images")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--hdr", default=None, metavar="PATH.npz",
                   help="also dump linear mean radiance (pre-tonemap) as .npz")
    p.add_argument("--checkpoint", default=None, metavar="PATH.npz",
                   help="resume from / save to a progressive render checkpoint")
    p.add_argument("--tile-shards", type=int, default=None, metavar="N",
                   help="shard image rows over N devices (default: no mesh; "
                        "0 = all devices after --spp-shards)")
    p.add_argument("--spp-shards", type=int, default=1, metavar="N",
                   help="shard each frame's samples over N devices, merged "
                        "with one psum")
    p.add_argument("--hw-dataset", default=None, metavar="PATH",
                   help="path to the published Hosek-Wilkie 2012 RGB "
                        "dataset (ArHosekSkyModelData_RGB.h or .npz): "
                        "cook sky coefficients exactly like the "
                        "reference's hw_skymodel crate instead of the "
                        "built-in Preetham fit (also: WRT_HW_DATASET)")
    p.add_argument("--validate-hw-dataset", action="store_true",
                   help="load --hw-dataset (or WRT_HW_DATASET), render "
                        "the scene with the exact Hosek-Wilkie sky AND "
                        "the built-in Preetham fit, and print one JSON "
                        "line with the image RMSE between them — a "
                        "one-command check that a user-supplied dataset "
                        "parsed, cooked, and actually changed the sky")
    p.add_argument("--stats-json", action="store_true",
                   help="print render stats as one JSON line")
    args = p.parse_args(argv)

    from .models import scenes as scene_lib

    if args.scene == "list":
        print("\n".join(scene_lib.SCENES))
        return 0
    if args.scene not in scene_lib.SCENES:
        print(f"unknown scene {args.scene!r}; use --scene list", file=sys.stderr)
        return 2

    from . import RenderParams, Renderer, SamplingParams
    from .utils.image import save_png

    build, cam_fn = scene_lib.SCENES[args.scene]
    try:
        desc = build(assets_dir=args.assets)
    except TypeError:
        desc = build()
    scene = desc.build()

    # default spp/frame: the largest of {4, 2, 1} that divides total spp
    # (max_samples_per_pixel must be a multiple of samples-per-frame)
    spp_frame = args.spp_per_frame or next(
        d for d in (4, 2, 1) if args.spp % d == 0
    )
    params = RenderParams(
        camera=cam_fn(),
        viewport_size=args.size,
        sampling=SamplingParams(
            max_samples_per_pixel=args.spp,
            num_samples_per_pixel=spp_frame,
            num_bounces=args.bounces,
        ),
    )

    if args.validate_hw_dataset:
        import os

        import numpy as np

        from .ops import tonemap

        path = args.hw_dataset or os.environ.get("WRT_HW_DATASET")
        if not path:
            print("--validate-hw-dataset needs --hw-dataset PATH (or "
                  "WRT_HW_DATASET)", file=sys.stderr)
            return 2
        # parse + cook up front so format errors surface as themselves,
        # not as a renderer fallback to the builtin fit
        from .models.hw_dataset import load_dataset  # noqa: F401

        load_dataset(path)
        imgs = {}
        for tag, ds in (("hw2012", path), ("builtin", None)):
            r = Renderer(scene, params, backend=args.backend,
                         hw_dataset=ds)
            r.render()
            if tag == "hw2012" and r.sky_model() != "hosek-wilkie-2012-exact":
                print(f"dataset at {path} did not activate the exact sky "
                      f"(got {r.sky_model()!r})", file=sys.stderr)
                return 1
            imgs[tag] = (np.asarray(r.mean_radiance()),
                         np.asarray(tonemap.to_srgb_u8(
                             r.mean_radiance())).astype(np.float64))
        lin_h, tm_h = imgs["hw2012"]
        lin_b, tm_b = imgs["builtin"]
        print(json.dumps({
            "dataset": path,
            "scene": args.scene,
            "size": list(args.size),
            "spp": args.spp,
            "tonemapped_rmse_u8": round(
                float(np.sqrt(np.mean((tm_h - tm_b) ** 2))), 4),
            "linear_mean_hw": [round(float(v), 6)
                               for v in lin_h.reshape(-1, 3).mean(0)],
            "linear_mean_builtin": [round(float(v), 6)
                                    for v in lin_b.reshape(-1, 3).mean(0)],
            "sky_hw": "hosek-wilkie-2012-exact",
            "sky_builtin": "preetham-fit-builtin",
        }))
        return 0

    backend = args.backend
    mesh = None
    if args.tile_shards is not None or args.spp_shards > 1:
        from .parallel.sharding import make_mesh

        mesh = make_mesh(
            tile_shards=args.tile_shards or None,
            spp_shards=args.spp_shards,
        )
    renderer = Renderer(scene, params, backend=backend, mesh=mesh,
                        hw_dataset=args.hw_dataset)
    backend = renderer.backend
    import os

    if args.checkpoint and os.path.exists(args.checkpoint):
        renderer.load_checkpoint(args.checkpoint)
    stats = renderer.render()
    save_png(args.output, renderer.image())
    if args.hdr:
        import numpy as np

        np.savez_compressed(args.hdr,
                            mean_radiance=np.asarray(renderer.mean_radiance()),
                            samples=renderer.accumulated_samples())
    if args.checkpoint:
        renderer.save_checkpoint(args.checkpoint)

    line = {
        "scene": args.scene,
        "backend": backend,
        "size": list(args.size),
        "spp": stats.samples_per_pixel,
        "seconds": round(stats.seconds, 3),
        "warmup_seconds": round(stats.warmup_seconds, 3),
        "rays_per_sec": round(stats.rays_per_sec, 1),
        "devices": mesh.devices.size if mesh is not None else 1,
        "sky": renderer.sky_model(),
        "output": args.output,
    }
    if args.stats_json:
        print(json.dumps(line))
    else:
        print(
            f"{args.scene} [{backend}] {args.size[0]}x{args.size[1]} "
            f"{stats.samples_per_pixel}spp in {stats.seconds:.2f}s "
            f"(warm {stats.rays_per_sec / 1e6:.1f}M rays/s; first frame "
            f"incl. compile {stats.warmup_seconds:.2f}s) -> {args.output}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
