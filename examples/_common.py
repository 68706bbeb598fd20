"""Shared argument handling for the examples (not part of the library)."""

import argparse
import os
import sys

# Make the repo checkout importable no matter where the example is run
# from (the package also works pip-installed; then this is a no-op).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(description: str, **extra):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cpu", action="store_true",
                   help="run on XLA:CPU instead of the GPU")
    p.add_argument("--cpu-devices", type=int, default=1, metavar="N",
                   help="with --cpu: number of virtual CPU devices "
                        "(for the mesh examples)")
    for name, (kw) in extra.items():
        p.add_argument(name, **kw)
    args = p.parse_args()
    if args.cpu:
        # Must happen before any JAX backend initialization.
        import jax

        jax.config.update("jax_platforms", "cpu")
        if args.cpu_devices > 1:
            jax.config.update("jax_num_cpu_devices", args.cpu_devices)
    return args
