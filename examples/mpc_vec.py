"""Batched MPC-in-the-loop rollouts on the vec tier.

The host agents (``examples/mpc_constant.py`` / ``mpc_perfect.py``) solve
one LP per step on the CPU; here the SAME DC-OPF runs as a batched ADMM
inside the compiled step (``gym_anm_tpu.vec.mpc``), so a whole farm of
ANM6Easy lanes rolls out under MPC control with no host round-trips —
the regime used for MPC-expert offline dataset generation.

Sweeps the planning horizon to show what foresight buys: the
constant-forecast policy (reference ``MPCAgentConstant``) vs the
perfect-forecast policy (``MPCAgentPerfect``) at several N.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gym_anm_tpu.offline_vec import evaluate_controller_vec  # noqa: E402
from gym_anm_tpu.vec import (  # noqa: E402
    VecEnv,
    make_anm6easy_task,
    make_vec_mpc,
    make_vec_mpc_perfect,
)


def run(batch=16, steps=96, horizons=(2, 4, 8), seed=0):
    # Horizons up to N=8: the float32 ADMM tier is validated there.  At
    # N=16 the f32 iterate drifts slightly INFEASIBLE (objective ~3e-3
    # below the LP optimum at 40k iterations; flagged feasible=False and
    # replaced by the idle fallback) — use dtype=float64 for
    # longer horizons (f64 converges in ~2.5k iterations there).
    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    key = jax.random.PRNGKey(seed)

    def show(name, ctrl):
        t0 = time.perf_counter()
        m = evaluate_controller_vec(env, ctrl, key, batch=batch, steps=steps)
        print(f"{name:>18}: mean reward/step {float(m):+.4f} "
              f"({time.perf_counter() - t0:.1f}s incl. compile)")
        return float(m)

    print(f"ANM6Easy farm, B={batch}, {steps} steps (one day), seed {seed}")
    show("constant N=1", make_vec_mpc(env, gamma=0.995, safety_margin=0.96,
                                      planning_steps=1))
    for n in horizons:
        show(f"perfect N={n}", make_vec_mpc_perfect(
            env, gamma=0.995, safety_margin=0.96, planning_steps=n))


if __name__ == "__main__":
    # --cpu: force the CPU backend BEFORE first jax use.
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    run()
