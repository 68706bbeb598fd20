"""Shard one progressive render over a (tiles x spp) device mesh.

Pixels are embarrassingly parallel: each device owns a horizontal band of
the accumulator for the whole render (zero steady-state communication);
an optional spp axis renders decorrelated sample batches that merge with
one psum (parallel/sharding.py).

Run anywhere with virtual devices:
    python examples/03_multichip.py --cpu --cpu-devices 8
"""

from _common import parse_args


def main():
    args = parse_args(
        "sharded render over a device mesh",
        **{
            "--tile-shards": dict(type=int, default=None,
                                  help="devices on the tile axis "
                                       "(default: all // spp_shards)"),
            "--spp-shards": dict(type=int, default=2),
        },
    )
    import jax

    from weekend_raytracer import (RenderParams, Renderer, SamplingParams,
                                       SCENES)
    from weekend_raytracer.parallel.sharding import make_mesh

    n = len(jax.devices())
    spp_shards = args.spp_shards if n % args.spp_shards == 0 else 1
    mesh = make_mesh(tile_shards=args.tile_shards, spp_shards=spp_shards)
    print(f"mesh: {dict(mesh.shape)} over {n} {jax.devices()[0].platform} device(s)")

    build, camera = SCENES["three"]
    params = RenderParams(
        camera=camera(),
        viewport_size=(320, 180),
        sampling=SamplingParams(max_samples_per_pixel=16,
                                num_samples_per_pixel=4),
    )
    # Same API as single-device; heights not divisible by the tile axis
    # are padded internally, images stay bit-identical band-for-band.
    r = Renderer(build(), params, mesh=mesh)
    stats = r.render()
    img = r.image()  # gathered to host: uint8 [H, W, 3]
    print(f"backend={r.backend} frames={stats.frames} "
          f"image={img.shape[1]}x{img.shape[0]} "
          f"accumulator sharding={r.mean_radiance().sharding}")


if __name__ == "__main__":
    main()
