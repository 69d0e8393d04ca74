"""Reproduce the reference's headline L0-L5 controller-quality table.

Runs the six "ready-to-use" hierarchy controllers
(``ready_to_use_l5_implementation.py:440-466`` protocol: fresh
``IEEE33ProperEnvironment(load_scale=0.9)``, fixed seed, constant loads)
for ``--steps`` steps each, on BOTH stacks:

* ours: ``gym_anm_tpu.compat.IEEE33ProperEnvironment`` +
  ``gym_anm_tpu.agents.ready_hierarchy``
* reference (live, if available at /root/reference): the upstream classes
  imported directly, with the conftest cvxpy stub installed.

Prints the per-step average reward table that docs/controllers.md cites
(the reference README's expected hierarchy is
L5 ~ -1.05 > L3 ~ -1.56 > L1 ~ -3.40 > L2 ~ -4.83 > L4 ~ -70 > L0 ~ -6000;
README.md:70-78).

Usage: python scripts/l0l5_quality_table.py [--steps 300] [--seed 0] [--skip-reference]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Compat tier (float64 single-env) runs on CPU by default; --gpu opts in.
if "--gpu" not in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

ORDER = ["L5", "L3", "L1", "L2", "L4", "L0"]  # best -> worst (README.md:70-78)


def run_controller(env, agent, steps, seed):
    np.random.seed(seed)
    env.reset(seed=seed)
    total, n = 0.0, 0
    for _ in range(steps):
        a = agent.act(env)
        a = np.clip(a, env.action_space.low, env.action_space.high)
        _, r, terminated, _, _ = env.step(a)
        total += r
        n += 1
        if terminated:
            env.reset()
    return total / n


def ours_table(steps, seed):
    from gym_anm_tpu.agents import ready_hierarchy as rh
    from gym_anm_tpu.compat import IEEE33ProperEnvironment

    classes = {
        "L0": rh.L0_Random, "L1": rh.L1_BangBang, "L2": rh.L2_Proportional,
        "L3": rh.L3_Coordinated, "L4": rh.L4_Predictive,
        "L5": rh.L5_MathematicalOptimization,
    }
    out = {}
    for name, cls in classes.items():
        env = IEEE33ProperEnvironment(load_scale=0.9)
        out[name] = run_controller(env, cls(env), steps, seed)
    return out


def reference_table(steps, seed):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tests.conftest import REFERENCE_PATH, _install_reference_stubs, reference_available

    if not reference_available():
        return None
    _install_reference_stubs()
    if REFERENCE_PATH not in sys.path:
        sys.path.insert(0, REFERENCE_PATH)
    import ready_to_use_l5_implementation as ref

    classes = {
        "L0": ref.L0_Random, "L1": ref.L1_BangBang, "L2": ref.L2_Proportional,
        "L3": ref.L3_Coordinated, "L4": ref.L4_Predictive,
        "L5": ref.L5_MathematicalOptimization,
    }
    out = {}
    for name, cls in classes.items():
        env = ref.IEEE33ProperEnvironment(load_scale=0.9)
        out[name] = run_controller(env, cls(env), steps, seed)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-reference", action="store_true")
    args = ap.parse_args()

    ours = ours_table(args.steps, args.seed)
    ref = None if args.skip_reference else reference_table(args.steps, args.seed)

    print(f"\nAvg reward/step over {args.steps} steps, seed {args.seed} "
          f"(IEEE33ProperEnvironment, load_scale=0.9):\n")
    print(f"{'level':<6}{'ours':>14}" + (f"{'reference':>14}" if ref else ""))
    for name in ORDER:
        row = f"{name:<6}{ours[name]:>14.4f}"
        if ref:
            row += f"{ref[name]:>14.4f}"
        print(row)
    ranked = sorted(ours, key=lambda k: ours[k], reverse=True)
    print(f"\nours ranking   : {' > '.join(ranked)}")
    print(f"README expected: {' > '.join(ORDER)}")


if __name__ == "__main__":
    main()
