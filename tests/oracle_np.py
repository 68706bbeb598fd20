"""Test shim: the NumPy oracle lives in the package (reference.py)."""
from weekend_raytracer.reference import (  # noqa: F401
    OracleTracer,
    init_state,
    jenkins,
    next_float,
    normalize,
    pcg_next,
    pixar_onb,
    reflect,
)
