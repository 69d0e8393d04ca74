"""Benchmark the algorithmically-diverse L0-L5 controllers across scenarios.

Equivalent of the reference's repo-root ``create_algorithmic_diversity.py``
benchmark harness (:494-597): run each controller of the diversity set
(:mod:`gym_anm_tpu.agents.diversity_hierarchy`) on a set of load scenarios,
report per-controller average rewards and the best-to-worst performance
gap.  The controllers themselves live in the package (unlike the reference,
which defines them in this script).

Usage:  python scripts/create_algorithmic_diversity.py [--steps N]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# The compat tier is float64 single-env — CPU is its natural backend; pass
# --gpu to run it on the GPU anyway.
if "--gpu" not in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

from gym_anm_tpu.agents import diversity_hierarchy as dh  # noqa: E402
from gym_anm_tpu.compat import IEEE33ProperEnvironment  # noqa: E402

CONTROLLERS = [
    ("L0_Random", dh.L0_Random),
    ("L1_BangBang", dh.L1_BangBang),
    ("L2_Proportional", dh.L2_Proportional),
    ("L3_PI", dh.L3_PI_Controller),
    ("L4_RuleBased", dh.L4_RuleBasedExpert),
    ("L5_ScipyOptimal", dh.L5_ScipyOptimal),
]

SCENARIOS = [
    ("light_load", 0.5),
    ("nominal_load", 1.0),
    ("evening_peak", 1.2),
]


def run(controller_cls, load_scale, steps, seed=0):
    np.random.seed(seed)
    env = IEEE33ProperEnvironment(load_scale=load_scale)
    env.reset(seed=seed)
    agent = controller_cls(env)
    total = 0.0
    for _ in range(steps):
        a = np.clip(agent.act(env), env.action_space.low, env.action_space.high)
        _, r, term, trunc, _ = env.step(a)
        total += r
        if term:
            env.reset(seed=seed)
    return total / steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--gpu", action="store_true", help="run on the GPU backend")
    args = ap.parse_args()

    print("=" * 72)
    print("ALGORITHMIC DIVERSITY BENCHMARK")
    print("=" * 72)

    results = {}
    for scen_name, scale in SCENARIOS:
        print(f"\nScenario: {scen_name} (load x{scale})")
        for name, cls in CONTROLLERS:
            avg = run(cls, scale, args.steps)
            results.setdefault(name, []).append(avg)
            print(f"  {name:<16} avg reward {avg:+.4f}")

    print("\n" + "=" * 72)
    print("OVERALL (mean across scenarios, best first)")
    print("=" * 72)
    overall = sorted(((np.mean(v), k) for k, v in results.items()), reverse=True)
    for avg, name in overall:
        print(f"  {name:<16} {avg:+.4f}")
    best, worst = overall[0][0], overall[-1][0]
    if worst != 0:
        print(f"\nBest-to-worst gap: {abs(worst / best):.1f}x" if best != 0 else "")
    return results


if __name__ == "__main__":
    main()
