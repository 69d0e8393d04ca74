"""Quick smoke test of the offline dataset pipeline (2 controllers, tiny).

Equivalent of the reference's repo-root ``quick_dataset_test.py:1-28``.

Usage:  python scripts/quick_dataset_test.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Compat tier (float64 single-env) runs on CPU by default; --gpu opts in.
if "--gpu" not in sys.argv:
    import jax

    jax.config.update("jax_platforms", "cpu")

from generate_final_offline_datasets import (  # noqa: E402
    SimpleL0_Random,
    SimpleL5_Optimal,
    collect_episode_data,
)


def quick_test():
    from gym_anm_tpu.compat import IEEE33ProperEnvironment

    print("QUICK DATASET GENERATION TEST")
    print("=" * 50)
    env = IEEE33ProperEnvironment()
    for controller in (SimpleL0_Random(), SimpleL5_Optimal()):
        print(f"\nTesting {controller.name}...")
        data = collect_episode_data(env, controller, num_episodes=2, steps=20)
        print(f"  Transitions: {len(data['rewards'])}")
        print(f"  Avg return: {np.mean(data['episode_returns']):.4f}")
        print(f"  Reward range: [{data['rewards'].min():.4f}, {data['rewards'].max():.4f}]")
    print("\nQuick test complete.")


if __name__ == "__main__":
    quick_test()
