"""Offline-RL dataset generation across the L0-L5 controller spectrum.

Equivalent of the reference's repo-root ``generate_final_offline_datasets.py``
(:13-337): collect (s, a, r, s', done) transitions from six increasingly
capable controllers on the IEEE33 multi-capacitor grid, cycling load
profiles [1.0, 0.5, 1.2, 0.8, 1.1] across episodes, and write per-controller
pickles + a combined dataset + a performance summary.

Two modes:

* default: the on-device vectorized pipeline — the whole
  collection (all episodes of a controller) runs as ONE jitted
  ``lax.scan`` over thousands of parallel env lanes, then transfers once.
  Generates in seconds what the step-at-a-time reference needs hours for.
* ``--compat``: the reference-faithful single-env path (same Simple L0-L5
  decision rules, same episode structure, same pickle schema) for
  apples-to-apples dataset comparison.

Usage:
    python scripts/generate_final_offline_datasets.py [--compat]
        [--episodes N] [--lanes B] [--out DIR]
"""

import argparse
import os
import pickle
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


# ---------------------------------------------------------------------------
# The "Simple" L0-L5 controllers (generate_final_offline_datasets.py:13-198).
# Host-tier: act(env) reading env.unwrapped.simulator.
# ---------------------------------------------------------------------------
class SimpleL0_Random:
    name = "L0_Random"

    def act(self, env):
        return env.action_space.sample()


class SimpleL1_Reactive:
    name = "L1_Reactive"

    def act(self, env):
        a = np.zeros(env.action_space.shape[0])
        a[0:3], a[3:5] = 0.02, 0.04  # conservative 40% renewables
        a[16] = 1.0
        return a


def _volts(env):
    sim = env.unwrapped.simulator
    return np.array([np.abs(b.v) for b in sim.buses.values()])


class SimpleL2_Proportional:
    name = "L2_Proportional"

    def act(self, env):
        v = _volts(env)
        a = np.zeros(env.action_space.shape[0])
        factor = np.clip(2.0 * (1.0 - v.mean()), 0.3, 0.8)
        a[0:3], a[3:5] = 0.05 * factor, 0.1 * factor
        if v.min() < 0.96:
            a[10] = 1.0
        a[16] = 1.0
        return a


class SimpleL3_Coordinated:
    name = "L3_Coordinated"

    def act(self, env):
        v = _volts(env)
        v_min, v_avg = v.min(), v.mean()
        a = np.zeros(env.action_space.shape[0])
        factor = 0.8 if v_avg < 0.98 else (0.3 if v_avg > 1.02 else 0.6)
        a[0:3], a[3:5] = 0.05 * factor, 0.1 * factor
        if v_min < 0.95:
            a[10:12] = 1.0
        elif v_min < 0.96:
            a[10] = 1.0
        a[16] = 0.98 if v_avg < 0.97 else (1.02 if v_avg > 1.03 else 1.0)
        return a


class SimpleL4_Advanced:
    name = "L4_Advanced"

    def __init__(self):
        self.v_history = []

    def act(self, env):
        v = _volts(env)
        v_min, v_avg = v.min(), v.mean()
        a = np.zeros(env.action_space.shape[0])
        self.v_history = (self.v_history + [v_avg])[-5:]
        trend = self.v_history[-1] - self.v_history[-3] if len(self.v_history) >= 3 else 0.0
        if v_avg < 0.98 or trend < -0.001:
            factor = 0.85
        elif v_avg > 1.02 or trend > 0.001:
            factor = 0.2
        else:
            factor = 0.65
        a[0:3], a[3:5] = 0.05 * factor, 0.1 * factor
        if v_min < 0.94 or (v_min < 0.96 and trend < -0.001):
            a[10:12] = 1.0
            if v_min < 0.93:
                a[12] = 0.15
        elif v_min < 0.96:
            a[10] = 1.0
        if v_avg < 0.97 and trend <= 0:
            a[16] = 0.96
        elif v_avg > 1.03 and trend >= 0:
            a[16] = 1.04
        else:
            a[16] = 1.0
        return a


class SimpleL5_Optimal:
    name = "L5_Optimal"

    def act(self, env):
        v = _volts(env)
        v_min, v_avg = v.min(), v.mean()
        a = np.zeros(env.action_space.shape[0])
        if v_min < 0.95:  # emergency
            a[0:3], a[3:5] = 0.05, 0.1
            a[10:12], a[12], a[16] = 1.0, 0.15, 0.94
        elif v_avg < 0.98:
            a[0:3], a[3:5], a[10], a[16] = 0.04, 0.08, 1.0, 0.97
        elif v_avg > 1.02:
            a[0:3], a[3:5], a[16] = 0.01, 0.02, 1.03
        else:
            a[0:3], a[3:5], a[16] = 0.035, 0.07, 1.0
        return a


CONTROLLERS = [SimpleL0_Random, SimpleL1_Reactive, SimpleL2_Proportional,
               SimpleL3_Coordinated, SimpleL4_Advanced, SimpleL5_Optimal]
LOAD_PROFILES = [1.0, 0.5, 1.2, 0.8, 1.1]


# ---------------------------------------------------------------------------
# Compat path: single env, step at a time (reference-faithful).
# ---------------------------------------------------------------------------
def collect_episode_data(env, controller, num_episodes=10, steps=100):
    """(s, a, r, s', done) tuples with load-profile cycling
    (generate_final_offline_datasets.py:200-249)."""
    S, A, R, S2, D, returns = [], [], [], [], [], []
    for ep in range(num_episodes):
        out = env.reset()
        obs = out[0] if isinstance(out, tuple) else out
        env.load_scale = LOAD_PROFILES[ep % len(LOAD_PROFILES)]
        ep_ret = 0.0
        for _ in range(steps):
            a = np.clip(controller.act(env), env.action_space.low, env.action_space.high)
            obs2, r, done, *_ = env.step(a)
            S.append(obs); A.append(a); R.append(r); S2.append(obs2); D.append(done)
            ep_ret += r
            obs = obs2
            if done:
                break
        returns.append(ep_ret)
    return {
        "states": np.array(S), "actions": np.array(A), "rewards": np.array(R),
        "next_states": np.array(S2), "dones": np.array(D),
        "episode_returns": returns,
    }


def run_compat(episodes, out_dir):
    from gym_anm_tpu.compat import IEEE33ProperEnvironment

    env = IEEE33ProperEnvironment()
    all_data, summary = [], []
    for i, cls in enumerate(CONTROLLERS):
        ctrl = cls()
        n_ep = episodes + 5 if i == 0 else episodes  # extra random exploration
        data = collect_episode_data(env, ctrl, n_ep)
        data["controller_id"], data["controller_name"] = i, ctrl.name
        with open(os.path.join(out_dir, f"{ctrl.name}_data.pkl"), "wb") as f:
            pickle.dump(data, f)
        all_data.append(data)
        summary.append({"controller": ctrl.name,
                        "avg_return": float(np.mean(data["episode_returns"])),
                        "transitions": len(data["rewards"])})
        print(f"  {ctrl.name}: {len(data['rewards'])} transitions, "
              f"avg return {summary[-1]['avg_return']:.4f}")
    return all_data, summary


# ---------------------------------------------------------------------------
# Device path: the vec tier's on-device controller suite at batch scale.
# ---------------------------------------------------------------------------
def run_vec(episodes, lanes, out_dir):
    import jax
    import jax.numpy as jnp

    from gym_anm_tpu.vec import VecEnv, make_ieee33_multicap_task
    from gym_anm_tpu.vec.controllers import make_suite
    from gym_anm_tpu.offline_vec import generate_mixed_dataset_vec

    env = VecEnv(make_ieee33_multicap_task(), dtype=jnp.float32)
    suite = make_suite(env)
    n = len(suite)
    steps = 100
    # All six controllers in ONE jitted program: each gets its own block of
    # `lanes` lanes via a fixed assignment (one compile instead of six).
    t0 = time.perf_counter()
    assignment = jnp.repeat(jnp.arange(n), lanes)
    (obs, acts, rews, next_obs, dones), _ = generate_mixed_dataset_vec(
        env, suite, jax.random.PRNGKey(0), batch=n * lanes, steps=steps,
        assignment=assignment,
    )
    jax.block_until_ready(rews)
    dt = time.perf_counter() - t0
    total_rate = n * lanes * steps / dt
    print(f"  collected all {n} controllers in {dt:.1f}s "
          f"({total_rate:,.0f} transitions/s, one compiled program)")

    all_data, summary = [], []
    for i in range(n):
        sl = slice(i * lanes, (i + 1) * lanes)
        name = f"L{i}"
        data = {
            "states": np.asarray(obs[:, sl]).reshape(-1, obs.shape[-1]),
            "actions": np.asarray(acts[:, sl]).reshape(-1, acts.shape[-1]),
            "rewards": np.asarray(rews[:, sl]).reshape(-1),
            "next_states": np.asarray(next_obs[:, sl]).reshape(-1, next_obs.shape[-1]),
            "dones": np.asarray(dones[:, sl]).reshape(-1),
            "episode_returns": np.asarray(rews[:, sl].sum(0)).tolist(),
            "controller_id": i, "controller_name": name,
        }
        with open(os.path.join(out_dir, f"{name}_data.pkl"), "wb") as f:
            pickle.dump(data, f)
        all_data.append(data)
        summary.append({"controller": name,
                        "avg_return": float(np.mean(data["episode_returns"])),
                        "transitions": len(data["rewards"])})
        print(f"  {name}: {len(data['rewards'])} transitions, "
              f"avg return {summary[-1]['avg_return']:.2f}")
    return all_data, summary


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--compat", action="store_true",
                    help="reference-faithful single-env path")
    ap.add_argument("--episodes", type=int, default=15)
    ap.add_argument("--lanes", type=int, default=1024,
                    help="parallel env lanes (vec mode)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--gpu", action="store_true",
                    help="run --compat mode on the GPU backend (vec mode "
                         "always uses the default backend)")
    args = ap.parse_args()

    if args.compat and not args.gpu:
        # Compat tier (float64 single-env) runs on CPU by default.
        import jax

        jax.config.update("jax_platforms", "cpu")

    out_dir = args.out or f"offline_rl_data_{int(time.time())}"
    os.makedirs(out_dir, exist_ok=True)
    print(f"Generating offline RL datasets -> {out_dir}/")

    if args.compat:
        all_data, summary = run_compat(args.episodes, out_dir)
    else:
        all_data, summary = run_vec(args.episodes, args.lanes, out_dir)

    combined = {
        "states": np.vstack([d["states"] for d in all_data]),
        "actions": np.vstack([d["actions"] for d in all_data]),
        "rewards": np.hstack([d["rewards"] for d in all_data]),
        "next_states": np.vstack([d["next_states"] for d in all_data]),
        "dones": np.hstack([d["dones"] for d in all_data]),
        "controller_ids": np.hstack(
            [np.full(len(d["rewards"]), d["controller_id"]) for d in all_data]
        ),
    }
    with open(os.path.join(out_dir, "combined_dataset.pkl"), "wb") as f:
        pickle.dump(combined, f)
    with open(os.path.join(out_dir, "summary.pkl"), "wb") as f:
        pickle.dump(summary, f)

    print(f"Total transitions: {len(combined['rewards'])}")
    for i, s in enumerate(sorted(summary, key=lambda x: x["avg_return"])):
        print(f"{i + 1}. {s['controller']}: {s['avg_return']:.4f} avg return")
    return out_dir


if __name__ == "__main__":
    main()
