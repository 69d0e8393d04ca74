"""RTI budget sweep: throughput AND closed-loop quality vs `max_iter`.

VERDICT-r4 item 8: the MPC-farm bench is capped by the real-time-
iteration budget (make_vec_mpc max_iter).  Round 4 measured full-day
quality FLAT down to budget 48 at N=1 but left the throughput curve and
the minimum safe default unpinned.  This script measures, on the GPU,
for each budget:

  * workload-4 throughput (B=8192 ANM6Easy farm, autoreset, 64-step
    scans x 3 reps after a warm-up — the bench protocol);
  * full-day closed-loop quality (B=256 x 96 steps = one complete
    profile day, mean reward/step), same seed across budgets.

Usage: python scripts/exp_rti_budget.py [--budgets 48,96,200]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from gym_anm_tpu.vec import VecEnv, make_anm6easy_task, make_vec_mpc


def build_rollout(env, ctrl, batch, n_steps):
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    carry0 = jax.vmap(ctrl.init_carry)(keys)

    def run(state, obs, carry, seed):
        def body(sc, t):
            st, obs, carry = sc
            k = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), t), batch)
            a, carry = jax.vmap(ctrl.act)(k, st, obs, carry)
            st, obs, r, d, _ = env.step_autoreset_batch(st, a)
            return (st, obs, carry), r.mean()

        (state, obs, carry), rs = jax.lax.scan(body, (state, obs, carry), jnp.arange(n_steps))
        return state, obs, carry, rs

    return jax.jit(run, donate_argnums=(0, 2)), state, obs, carry0


def throughput(env, ctrl, batch=8192, n_steps=64, n_reps=3):
    # differenced protocol (bench._time_reps): the marginal rate cancels
    # the per-region dispatch and ramp costs
    run, state, obs, carry = build_rollout(env, ctrl, batch, n_steps)
    state, obs, carry, rs = run(state, obs, carry, 0)
    jax.block_until_ready(rs)
    t0 = time.perf_counter()
    state, obs, carry, rs = run(state, obs, carry, 1)
    jax.block_until_ready(rs)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    for rep in range(n_reps):
        state, obs, carry, rs = run(state, obs, carry, rep + 2)
    jax.block_until_ready(rs)
    tn = time.perf_counter() - t0
    if n_reps > 1 and tn > t1 > 0:
        return batch * n_steps * (n_reps - 1) / (tn - t1)
    return batch * n_steps * n_reps / tn


def quality(env, ctrl, batch=256, n_steps=96):
    run, state, obs, carry = build_rollout(env, ctrl, batch, n_steps)
    _, _, _, rs = run(state, obs, carry, 0)
    return float(jnp.mean(rs))


def main():
    budgets = [48, 96, 200]
    for a in sys.argv[1:]:
        if a.startswith("--budgets"):
            budgets = [int(x) for x in a.split("=", 1)[1].split(",")]
    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    print(f"{'budget':>8} {'steps/s':>12} {'reward/step (full day)':>24}")
    for b in budgets:
        ctrl = make_vec_mpc(env, gamma=0.995, safety_margin=0.96,
                            planning_steps=1, max_iter=b)
        q = quality(env, ctrl)
        tp = throughput(env, ctrl)
        print(f"{b:>8} {tp:>12.0f} {q:>24.4f}", flush=True)


if __name__ == "__main__":
    main()
