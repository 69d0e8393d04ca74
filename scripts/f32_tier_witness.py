"""How far two correct runs of one program can differ per lane: the
float32 tier against the float64 tier on the CPU, for the programs
``chip_smoke.py`` compares card-vs-CPU, at its size (B=512, 16 steps)
and with its keys and actions.

- ieee33: |ΔV| stays near 1e-6 p.u., yet a few lanes' rewards differ by
  more than 2e-4 + 1e-3|r|: the branch-flow penalty multiplies a voltage
  gap by up to λ·Σ|y| (``chip_smoke.tolerances_for``).  Printed with
  chip_smoke's own comparison.
- MPC farm (ANM6Easy): the largest action and |ΔV| gap per step.  The
  ADMM stops after a fixed number of sweeps and warm-starts from the
  previous step, so rounding differences carry over and grow along the
  closed loop.

Usage: JAX_PLATFORMS=cpu python scripts/f32_tier_witness.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from gym_anm_tpu.vec import VecEnv, make_anm6easy_task, make_ieee33_task

BATCH, N_STEPS = 512, 16  # chip_smoke phase c


def ieee33_f32_vs_f64():
    """``(ok, detail)`` of chip_smoke's comparison, f32 tier vs f64 tier."""
    cpu = jax.devices("cpu")[0]
    env32 = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    out = [chip_smoke.run_on(cpu, *chip_smoke._random_farm_trajectory(
               VecEnv(make_ieee33_task(), dtype=dt), False, BATCH, N_STEPS))
           for dt in (jnp.float32, jnp.float64)]
    return chip_smoke.compare_trajectories(*out, chip_smoke.tolerances_for(env32))


def mpc_f32_vs_f64():
    """Per step: the largest |Δaction| (MW, MVAr) and |ΔV| (p.u.)."""
    cpu = jax.devices("cpu")[0]
    f32, f64 = (chip_smoke.run_on(cpu, *chip_smoke._mpc_trajectory(BATCH, N_STEPS, dt))
                for dt in (jnp.float32, jnp.float64))
    da = np.abs(np.asarray(f32["action"], np.float64) - f64["action"]).max(axis=(1, 2))
    dv = np.abs(chip_smoke._voltages(f32["v"]) - chip_smoke._voltages(f64["v"])).max(axis=(1, 2))
    return da, dv


def main():
    ok, detail = ieee33_f32_vs_f64()
    print(f"ieee33 B={BATCH} x {N_STEPS}, f32 vs f64 (within chip_smoke's bounds: {ok}): {detail}")
    da, dv = mpc_f32_vs_f64()
    print(f"mpc farm B={BATCH} x {N_STEPS}, f32 vs f64, per step:")
    for t, (a, v) in enumerate(zip(da, dv)):
        print(f"  step {t:2d}: action max|d|={a:.3e}  |dV| max={v:.3e}")


if __name__ == "__main__":
    main()
