"""A/B of the two batched dense solvers for the f32 exact-NR fallback.

Times unpivoted Gauss-Jordan written as plain XLA ops (``solve_gauss_jordan``
below, the fallback's solver until the library LU measured faster) against
``jnp.linalg.solve`` (pivoted batched LU from the backend's library, the
fallback's solver now) on a [B, n, n] float32 batch shaped like the fallback's
Newton systems (IEEE33: n = 2·32 = 64), diagonally dominant like power-flow
Jacobians.  Each program is compiled and warmed up first; every timed call
ends in ``jax.block_until_ready``.  Prints the device, the card's name and
power limit, and per solver the wall time per batched call and per system,
and the largest difference between the two solutions.

Usage: python scripts/linsolve_ab.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import bench

BATCH, N = 8192, 64  # the fallback's systems on IEEE33, at the bench batch
REPS = 50            # timed calls per measurement


def solve_gauss_jordan(A, b):
    """Solve A x = b by unpivoted Gauss-Jordan elimination, vectorized over
    leading batch axes.

    It runs as n rank-1 updates — elementwise work that vectorizes over the
    batch, with no pivot search between sweeps (safe for the diagonally
    dominant power-flow Jacobians)."""
    n = A.shape[-1]
    M = jnp.concatenate([A, b[..., :, None]], axis=-1)  # [..., n, n+1]
    rows = jnp.arange(n)

    def eliminate(k, M):
        pivot_row = jnp.take(M, k, axis=-2)                    # [..., n+1]
        pivot = jnp.take(pivot_row, k, axis=-1)                # [...]
        factor = jnp.take(M, k, axis=-1) / pivot[..., None]    # [..., n]
        mask = (rows != k).astype(M.dtype)                     # zero own row
        update = (factor * mask)[..., :, None] * pivot_row[..., None, :]
        return M - update

    M = jax.lax.fori_loop(0, n, eliminate, M, unroll=8)
    diag = jnp.diagonal(M[..., :, :n], axis1=-2, axis2=-1)
    return M[..., -1] / diag


def systems(batch, n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1.0, 1.0, (batch, n, n)) + n * np.eye(n)
    b = rng.uniform(-1.0, 1.0, (batch, n))
    return jnp.asarray(A, jnp.float32), jnp.asarray(b, jnp.float32)


def time_solver(fn, A, b):
    jax.block_until_ready(fn(A, b))  # compile + warm up
    jax.block_until_ready(fn(A, b))
    t0 = time.perf_counter()
    for _ in range(REPS):
        x = fn(A, b)
    jax.block_until_ready(x)
    return (time.perf_counter() - t0) / REPS


def main():
    device = bench.require_gpu()
    print(f"device: {json.dumps(device)}")
    print(f"card: {bench.gpu_name_and_power_limit()}")
    A, b = systems(BATCH, N)
    solvers = {"gauss_jordan": jax.jit(solve_gauss_jordan),
               # b as [B, n, 1]: a [B, n] right-hand side is a matrix to
               # jnp.linalg.solve, not a batch of vectors.
               "linalg_solve": jax.jit(lambda A, b: jnp.linalg.solve(A, b[..., None])[..., 0])}
    xs = {name: np.asarray(fn(A, b)) for name, fn in solvers.items()}
    # Two rounds in alternating order, so drift in clocks shows as a spread.
    for order in (list(solvers), list(solvers)[::-1]):
        for name in order:
            t = time_solver(solvers[name], A, b)
            print(json.dumps({"solver": name, "shape": [BATCH, N, N],
                              "dtype": "float32", "s_per_call": t,
                              "us_per_system": 1e6 * t / BATCH}))
    diff = float(np.abs(xs["gauss_jordan"] - xs["linalg_solve"]).max())
    print(f"max |x_gj - x_lu| = {diff:.3e}")


if __name__ == "__main__":
    main()
