"""Drive the batched on-device environment farm with standard Gymnasium tooling.

The vec tier's native interface is pure JAX (jit/vmap/scan); this example
shows the OTHER door: ``vec.GymVectorEnv`` exposes the same farm as a
``gymnasium.vector.VectorEnv``, so an off-the-shelf training loop — the
shape CleanRL / SB3-style scripts expect — runs against it unchanged,
including Gymnasium's stateful vector wrappers (which require the
``NextStep`` autoreset convention).

No reference counterpart (the reference is single-env Gymnasium only);
the adapter maps the reference MDP (anm_env.py:333-469 semantics) onto the
vector API.
"""

import numpy as np


def run(num_envs=32, steps=60, seed=0):
    from gymnasium.wrappers.vector import (
        ClipAction,
        NormalizeObservation,
        RecordEpisodeStatistics,
    )

    from gym_anm_tpu.vec import GymVectorEnv, make_ieee33_multicap_task

    # A 17-dim flagship-task farm behind the standard vector API.  (Pass
    # mesh=parallel.make_env_mesh(jax.devices()) to spread the lanes over
    # every chip with the same code.)
    farm = GymVectorEnv(
        make_ieee33_multicap_task(), num_envs=num_envs, autoreset_mode="NextStep"
    )
    envs = RecordEpisodeStatistics(NormalizeObservation(ClipAction(farm)))

    obs, _ = envs.reset(seed=seed)
    rng = np.random.default_rng(seed)
    # ClipAction widens the visible action space to (-inf, inf); read the
    # true MDP box from the underlying farm.
    lo = farm.single_action_space.low
    hi = farm.single_action_space.high

    total_reward, episodes = 0.0, 0
    for _ in range(steps):
        # Any policy that emits a [num_envs, act_dim] array works here; a
        # mildly noisy mid-box policy stands in for a learner.
        frac = 0.35 + 0.3 * rng.random((num_envs, lo.shape[0]))
        actions = (lo + frac * (hi - lo)).astype(np.float32)
        obs, rewards, terminations, truncations, infos = envs.step(actions)
        total_reward += float(rewards.sum())
        if "episode" in infos:
            episodes += int(infos["_episode"].sum())

    print(f"{num_envs} lanes x {steps} steps: total reward {total_reward:+.2f}, "
          f"{episodes} completed episodes, obs normalized to "
          f"mean {obs.mean():+.3f} / std {obs.std():.3f}")
    return total_reward, episodes


if __name__ == "__main__":
    run()
