"""End-to-end offline RL: generate a dataset on-device, train CQL, evaluate.

The full offline pipeline over the on-device stack (BASELINE configs 4-5):

1. collect transitions from the on-device L0-L5 controller suite on the
   batched IEEE33 multi-capacitor env (one jitted scan per controller);
2. train a Conservative Q-Learning policy on the mixed dataset;
3. evaluate the learned policy against the random and expert baselines by
   on-device rollouts.

Usage:  python scripts/train_cql_offline.py [--lanes B] [--steps N]
        [--train-steps K] [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if "--cpu" in sys.argv:
    # Must win before JAX initializes.
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gym_anm_tpu.offline_vec import generate_dataset_vec  # noqa: E402
from gym_anm_tpu.parallel import CQLConfig, train_cql  # noqa: E402
from gym_anm_tpu.vec import VecEnv, make_ieee33_multicap_task  # noqa: E402
from gym_anm_tpu.vec.controllers import make_suite  # noqa: E402


def evaluate(env, policy, key, lanes=256, steps=50):
    """Mean per-step reward of a host policy obs->action over on-device
    rollouts."""
    keys = jax.random.split(key, lanes)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    step = jax.jit(jax.vmap(env.step))
    total = 0.0
    for _ in range(steps):
        acts = jnp.clip(jnp.asarray(policy(obs)), env.action_low, env.action_high)
        state, obs, r, d, _ = step(state, acts.astype(env.dtype))
        total += float(r.mean())
    return total / steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=512)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--train-steps", type=int, default=2000)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (handled pre-import)")
    args = ap.parse_args()
    print(f"backend: {jax.default_backend()}")

    env = VecEnv(make_ieee33_multicap_task(), dtype=jnp.float32)
    suite = make_suite(env)

    # 1. Mixed dataset from the whole controller hierarchy.
    print("Collecting mixed dataset...")
    t0 = time.perf_counter()
    parts = []
    for i, ctrl in enumerate(suite):
        obs, acts, rews, next_obs, dones = generate_dataset_vec(
            env, ctrl, jax.random.PRNGKey(i), args.lanes, args.steps
        )
        parts.append((obs, acts, rews, next_obs, dones))
    flat = lambda idx: np.concatenate(
        [np.asarray(p[idx]).reshape(-1, *p[idx].shape[2:]) for p in parts]
    )
    dataset = {
        "states": flat(0), "actions": flat(1), "rewards": flat(2),
        "next_states": flat(3), "dones": flat(4).astype(np.float32),
    }
    print(f"  {len(dataset['rewards']):,} transitions in {time.perf_counter()-t0:.1f}s")

    # 2. Train CQL.
    print(f"Training CQL for {args.train_steps} steps...")
    t0 = time.perf_counter()
    cfg = CQLConfig(hidden=128, cql_weight=2.0)
    _, metrics, policy = train_cql(
        jax.random.PRNGKey(42), dataset,
        np.asarray(env.action_low), np.asarray(env.action_high),
        cfg, steps=args.train_steps, batch_size=512,
    )
    print(f"  done in {time.perf_counter()-t0:.1f}s; final loss "
          f"{float(metrics['loss']):.3f}, bellman {float(metrics['bellman']):.3f}")

    # 3. Evaluate vs the random (L0) and expert (L5) baselines.
    print("Evaluating...")
    r_cql = evaluate(env, policy, jax.random.PRNGKey(100))
    rand = env.random_policy()

    def random_policy(obs):
        return rand(jax.random.PRNGKey(0), obs, 0)

    r_rand = evaluate(env, random_policy, jax.random.PRNGKey(100))
    print(f"  CQL policy   : {r_cql:+.4f} avg reward/step")
    print(f"  random policy: {r_rand:+.4f} avg reward/step")
    print("CQL beats random." if r_cql > r_rand else "WARNING: CQL below random.")


if __name__ == "__main__":
    main()
