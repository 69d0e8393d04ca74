"""Split-complex helpers.

The physics kernels keep complex quantities as (re, im) pairs of real
arrays instead of complex dtypes: real matmuls map directly onto the
accelerator's matrix units, complex support on accelerators is spotty, and
a single code path can
then run in float32 (throughput mode) or float64 (parity mode).
"""

import jax
import jax.numpy as jnp


def cmul(ar, ai, br, bi):
    """(ar+j·ai)·(br+j·bi)."""
    return ar * br - ai * bi, ar * bi + ai * br


def cdiv(ar, ai, br, bi):
    """(ar+j·ai)/(br+j·bi)."""
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def cabs(ar, ai):
    return jnp.sqrt(ar * ar + ai * ai)


def cmatvec(Mre, Mim, vr, vi, precision=None):
    """Complex matrix-vector product with split storage.

    Shapes: M [..., N, N], v [..., N].  Uses real matmuls.

    Pass ``precision=jax.lax.Precision.HIGHEST`` when the result feeds a
    convergence test: accelerator f32 matmuls otherwise may multiply in
    TF32 or bfloat16, whose ~3-digit mantissa puts a residual floor far
    above any useful xtol.
    """
    dot = lambda a, b: jnp.matmul(a, b[..., None], precision=precision)[..., 0]
    re = dot(Mre, vr) - dot(Mim, vi)
    im = dot(Mre, vi) + dot(Mim, vr)
    return re, im
