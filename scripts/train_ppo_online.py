"""Online RL: data-parallel PPO over a sharded IEEE33 env farm.

The BASELINE "config 5" entry point: the environment batch shards over the
device mesh's ``env`` axis, parameters replicate, and the whole training
step (on-device rollout -> GAE -> clipped-surrogate update) is one jitted
function whose mean-gradient reductions lower to psum collectives.

Usage:  python scripts/train_ppo_online.py [--lanes-per-device 512]
        [--iters 50] [--rollout 16] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if "--cpu" in sys.argv:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from gym_anm_tpu.parallel import (  # noqa: E402
    PPOConfig,
    init_train_state,
    make_env_mesh,
    make_train_step,
)
from gym_anm_tpu.vec import VecEnv, make_ieee33_task  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes-per-device", type=int, default=512)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--rollout", type=int, default=16)
    ap.add_argument("--task", choices=("ieee33", "multicap"), default="ieee33",
                    help="ieee33 = static base task; multicap = the 17-dim "
                         "flagship with diurnal loads")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--minibatches", type=int, default=1,
                    help="time-axis minibatches per epoch")
    ap.add_argument("--lane-minibatches", type=int, default=1,
                    help="contiguous lane-axis minibatches per epoch")
    ap.add_argument("--cpu", action="store_true",
                    help="8 virtual CPU devices (mechanism check)")
    ap.add_argument("--refresh-interval", type=int, default=0,
                    help="rotating lane refresh: each train step, re-reset "
                         "lanes with (lane+step) %% N == 0 so the policy "
                         "keeps seeing fresh-reset states (0 = off)")
    ap.add_argument("--save", metavar="DIR", default=None,
                    help="save the final TrainState (params + Adam "
                         "moments) as an orbax checkpoint under DIR; "
                         "restore with utils.restore_checkpoint")
    ap.add_argument("--eval", action="store_true",
                    help="after training, evaluate the DETERMINISTIC "
                         "policy (a = mu) under the offline-eval protocol "
                         "(fresh lanes, no autoreset, absorb-at-0 after "
                         "collapse) and print it next to the random "
                         "baseline — comparable to docs/distributed.md's "
                         "CQL/informed-controller table")
    args = ap.parse_args()
    if args.lanes_per_device < 1 or args.iters < 1:
        ap.error("--lanes-per-device and --iters must be >= 1")

    devices = jax.devices()
    mesh = make_env_mesh(devices)
    env_sh = NamedSharding(mesh, P("env"))
    rep_sh = NamedSharding(mesh, P())
    B = args.lanes_per_device * len(devices)
    print(f"{len(devices)} device(s) ({devices[0].platform}), batch {B}")

    from gym_anm_tpu.vec import make_ieee33_multicap_task

    factory = make_ieee33_task if args.task == "ieee33" else make_ieee33_multicap_task
    env = VecEnv(factory(), dtype=jnp.float32)
    cfg = PPOConfig(rollout_len=args.rollout, n_epochs=args.epochs,
                    n_minibatches=args.minibatches,
                    n_lane_minibatches=args.lane_minibatches,
                    refresh_interval=args.refresh_interval)

    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, obs = jax.jit(jax.vmap(env.reset), out_shardings=(env_sh, env_sh))(keys)
    ts = init_train_state(jax.random.PRNGKey(1), env.n_state, env.n_action, cfg)
    ts = jax.device_put(ts, rep_sh)

    train_step = jax.jit(
        make_train_step(env, cfg),
        in_shardings=(rep_sh, env_sh, env_sh),
        out_shardings=(rep_sh, env_sh, env_sh, rep_sh),
        donate_argnums=(1, 2),
    )

    t0 = time.perf_counter()
    first_rew = None
    for it in range(args.iters):
        ts, state, obs, metrics = train_step(ts, state, obs)
        if it == 0:
            jax.block_until_ready(metrics)
            print(f"compile+first step: {time.perf_counter() - t0:.1f}s")
            t0 = time.perf_counter()
        if it % max(1, args.iters // 10) == 0 or it == args.iters - 1:
            m = jax.device_get(metrics)
            if first_rew is None:
                first_rew = float(m["mean_reward"]) if "mean_reward" in m else None
            line = f"iter {it:4d}  loss {float(m['loss']):+.4f}"
            if "mean_reward" in m:
                line += f"  reward {float(m['mean_reward']):+.4f}"
            print(line)
    jax.block_until_ready(metrics)
    dt = time.perf_counter() - t0
    steps = (args.iters - 1) * B * args.rollout
    print(f"throughput: {steps / dt:,.0f} env-steps/s (train loop, "
          f"{len(devices)} device(s))")

    if args.save:
        from gym_anm_tpu.utils import save_checkpoint

        save_checkpoint(os.path.abspath(args.save),
                        jax.device_get(ts), step=args.iters)
        print(f"checkpoint saved: {os.path.abspath(args.save)}/step_{args.iters}")

    if args.eval:
        from gym_anm_tpu.parallel.ppo import make_io_norm, policy_dist

        if cfg.normalize_io:
            norm_obs, act_mid, act_half = make_io_norm(env)
        else:
            norm_obs = lambda o: o  # noqa: E731
            act_mid = jnp.zeros_like(env.action_low)
            act_half = jnp.ones_like(env.action_low)

        def ppo_policy(obs):
            mu, _ = policy_dist(ts.params, norm_obs(obs))
            if cfg.normalize_io:
                mu = jnp.clip(mu, -1.0, 1.0)
            return act_mid + mu * act_half

        def random_policy(obs):
            k = jax.random.fold_in(jax.random.PRNGKey(9), int(obs.sum() * 0) + 1)
            u = jax.random.uniform(k, (obs.shape[0], env.n_action), dtype=env.dtype)
            return env.action_low + u * (env.action_high - env.action_low)

        def evaluate(policy, lanes=256, steps=50):
            # The offline-eval protocol (scripts/train_cql_offline.py:40):
            # fresh lanes, NO autoreset — collapsed lanes absorb at 0
            # after the terminal hit, so crashing scores catastrophically.
            keys = jax.random.split(jax.random.PRNGKey(100), lanes)
            state, obs = jax.jit(jax.vmap(env.reset))(keys)
            step = jax.jit(jax.vmap(env.step))
            total = 0.0
            for _ in range(steps):
                acts = jnp.clip(jnp.asarray(policy(obs)),
                                env.action_low, env.action_high)
                state, obs, r, d, _ = step(state, acts.astype(env.dtype))
                total += float(r.mean())
            return total / steps

        r_ppo = evaluate(ppo_policy)
        r_rand = evaluate(random_policy)
        print(f"eval (deterministic, no-autoreset absorb protocol): "
              f"PPO {r_ppo:+.4f}  random {r_rand:+.4f}  per step")


if __name__ == "__main__":
    main()
