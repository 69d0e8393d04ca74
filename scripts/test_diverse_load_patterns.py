"""Controller-hierarchy comparison across realistic load patterns.

Equivalent of the reference's repo-root ``test_diverse_load_patterns.py``
(:20-142 + report harness): four time-varying load patterns (workday
double-peak, renewable intermittence, industrial switching, extreme
scenario chain) driving a dynamic-load IEEE33 environment, with all six
diversity controllers ranked per pattern.  Plots are written when
matplotlib is available, otherwise a text report is printed.

Usage:  python scripts/test_diverse_load_patterns.py [--steps N] [--out DIR]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Compat tier (float64 single-env) runs on CPU by default; --gpu opts in.
if "--gpu" not in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

from gym_anm_tpu.agents import diversity_hierarchy as dh  # noqa: E402
from gym_anm_tpu.compat import IEEE33ProperEnvironment  # noqa: E402


class LoadPatternEnvironment(IEEE33ProperEnvironment):
    """IEEE33ProperEnvironment whose load_scale follows a time pattern
    (test_diverse_load_patterns.py:20-38)."""

    def __init__(self, pattern_fn, base_load_scale=1.0):
        super().__init__(load_scale=base_load_scale)
        self.pattern_fn = pattern_fn
        self.base_load_scale = base_load_scale
        self.time_step = 0

    def step(self, action):
        self.load_scale = self.base_load_scale * self.pattern_fn(self.time_step)
        self.time_step += 1
        return super().step(action)

    def reset(self, **kwargs):
        self.time_step = 0
        self.load_scale = self.base_load_scale * self.pattern_fn(0)
        return super().reset(**kwargs)


def create_load_patterns():
    """Four realistic scale(t) profiles at 15-minute resolution
    (test_diverse_load_patterns.py:41-140)."""

    def baseline_workday(t):
        hour = (t / 4) % 24
        if hour < 6:
            return 0.7 + 0.05 * np.sin(hour * np.pi / 6)
        if hour < 9:
            return 0.7 + 0.3 * (hour - 6) / 3
        if hour < 17:
            return 1.0 + 0.05 * np.sin((hour - 9) * np.pi / 4)
        if hour < 21:
            return 1.0 + 0.15 * np.sin((hour - 17) * np.pi / 4)
        return 0.85 - 0.15 * (hour - 21) / 3

    def renewable_intermittence(t):
        base = baseline_workday(t)
        rng = np.random.RandomState(t)
        return base * (1.0 + 0.25 * np.sin(t / 3.0) * rng.uniform(0.5, 1.0))

    def industrial_switching(t):
        base = baseline_workday(t)
        return base * (1.35 if (t // 20) % 3 == 0 else 0.9)

    def extreme_scenarios(t):
        phase = (t // 50) % 4
        return [0.4, 1.5, 0.8, 1.25][phase]

    return {
        "baseline_workday": baseline_workday,
        "high_renewable_intermittence": renewable_intermittence,
        "industrial_load_switching": industrial_switching,
        "extreme_scenarios": extreme_scenarios,
    }


CONTROLLERS = [
    ("L0_Random", dh.L0_Random),
    ("L1_BangBang", dh.L1_BangBang),
    ("L2_Proportional", dh.L2_Proportional),
    ("L3_PI", dh.L3_PI_Controller),
    ("L4_RuleBased", dh.L4_RuleBasedExpert),
    ("L5_ScipyOptimal", dh.L5_ScipyOptimal),
]


def test_load_pattern(pattern_name, pattern_fn, steps):
    print(f"\nTesting {pattern_name}...")
    results = {}
    for name, cls in CONTROLLERS:
        np.random.seed(0)
        env = LoadPatternEnvironment(pattern_fn)
        env.reset(seed=0)
        agent = cls(env)
        rewards = []
        for _ in range(steps):
            a = np.clip(agent.act(env), env.action_space.low, env.action_space.high)
            _, r, term, trunc, _ = env.step(a)
            rewards.append(r)
            if term:
                env.reset(seed=0)
        results[name] = {"avg": float(np.mean(rewards)), "rewards": rewards}
        print(f"  {name:<16} avg {results[name]['avg']:+.4f}")
    return results


def maybe_plot(all_results, out_dir):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("(matplotlib unavailable; skipping plots)")
        return
    os.makedirs(out_dir, exist_ok=True)
    fig, axes = plt.subplots(2, 2, figsize=(14, 8))
    for ax, (pattern, results) in zip(axes.flat, all_results.items()):
        names = list(results)
        ax.bar(range(len(names)), [results[n]["avg"] for n in names])
        ax.set_xticks(range(len(names)))
        ax.set_xticklabels(names, rotation=45, ha="right", fontsize=7)
        ax.set_title(pattern.replace("_", " "))
        ax.set_ylabel("avg reward")
    fig.tight_layout()
    path = os.path.join(out_dir, "performance_across_patterns.png")
    fig.savefig(path, dpi=150)
    print(f"Plot written to {path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out", default="load_pattern_report")
    ap.add_argument("--gpu", action="store_true", help="run on the GPU backend")
    args = ap.parse_args()

    all_results = {}
    for pattern_name, fn in create_load_patterns().items():
        all_results[pattern_name] = test_load_pattern(pattern_name, fn, args.steps)

    print("\n" + "=" * 72)
    print("RANKING PER PATTERN (best first)")
    print("=" * 72)
    for pattern, results in all_results.items():
        ranked = sorted(results.items(), key=lambda kv: kv[1]["avg"], reverse=True)
        print(f"{pattern}: " + " > ".join(n for n, _ in ranked))

    maybe_plot(all_results, args.out)
    return all_results


if __name__ == "__main__":
    main()
