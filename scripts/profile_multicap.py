"""Component-ablation profile of the flagship multicap17 step on the GPU.

Times the full benchmark step and a series of ablated variants (projection
stubbed out, solver stubbed out, next_vars frozen) to attribute the per-step
budget — the numbers feeding docs/performance.md's flagship-budget table.
Ablations monkeypatch pure functions at trace time; they change semantics,
not shapes, so the timing deltas isolate each component's cost.

Usage:  python scripts/profile_multicap.py [batch] [--task ieee33|multicap]
"""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from gym_anm_tpu.vec import VecEnv, make_ieee33_multicap_task, make_ieee33_task


def time_scan(env, batch, n_steps=32, n_reps=3, autoreset=True):
    lo, hi = env.action_low, env.action_high
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    step = env.step_autoreset_batch if autoreset else (
        lambda st, a: jax.vmap(env.step)(st, a))

    def run(state, obs, seed):
        def body(carry, t):
            st, obs = carry
            k = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            acts = lo + jax.random.uniform(k, (batch, env.n_action), dtype=env.dtype) * (hi - lo)
            st, obs, r, d, _ = step(st, acts)
            return (st, obs), r.sum()

        (state, obs), rs = jax.lax.scan(body, (state, obs), jnp.arange(n_steps))
        return state, obs, rs.sum()

    run_jit = jax.jit(run, donate_argnums=(0,))
    state, obs, total = run_jit(state, obs, 0)
    jax.block_until_ready(total)
    t0 = time.perf_counter()
    for rep in range(n_reps):
        state, obs, total = run_jit(state, obs, rep + 1)
    jax.block_until_ready(total)
    elapsed = time.perf_counter() - t0
    return batch * n_steps * n_reps / elapsed


def fake_chord(p, q, w_a, w_b, dtf_re, dtf_im, const, xtol=1e-5, lim_iter=48,
               stall_tol_factor=10.0, x0=None):
    """Accept the warm start immediately: removes the entire solve."""
    n = const.Y0re.shape[-1] - 1
    flat = jnp.concatenate([jnp.zeros(n, p.dtype), jnp.ones(n, p.dtype)])
    x = flat if x0 is None else jnp.where(jnp.all(jnp.isfinite(x0)), x0.astype(p.dtype), flat)
    F = jnp.zeros(2 * n, p.dtype)
    return x, F, jnp.zeros((), p.dtype), jnp.zeros((), jnp.int32), jnp.ones((), bool)


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    batch = int(args[0]) if args else 8192
    which = "ieee33" if "--task=ieee33" in sys.argv else "multicap"

    import importlib
    tr = importlib.import_module("gym_anm_tpu.physics.transition")

    make_task = make_ieee33_task if which == "ieee33" else make_ieee33_multicap_task
    task = make_task()
    auto = which != "ieee33"

    results = {}

    env = VecEnv(task, dtype=jnp.float32)
    results["full (bench workload)"] = time_scan(env, batch, autoreset=auto)
    if auto:
        results["plain step (no autoreset)"] = time_scan(env, batch, autoreset=False)

    # --- no projection: gen/des projectors return the set-point unchanged.
    env2 = VecEnv(task, dtype=jnp.float32)
    ident = lambda pt, p_lo, p_hi: pt
    env2.tables = env2.tables._replace(gen_project=ident, des_project=ident)
    results["no projection"] = time_scan(env2, batch, autoreset=False)

    # --- no solve: chord accepts its warm start instantly, NR loop skipped.
    orig = tr.chord_solve
    tr.chord_solve = fake_chord
    try:
        env3 = VecEnv(task, dtype=jnp.float32)
        results["no solve"] = time_scan(env3, batch, autoreset=False)
        env4 = VecEnv(task, dtype=jnp.float32)
        env4.tables = env4.tables._replace(gen_project=ident, des_project=ident)
        results["no solve + no projection"] = time_scan(env4, batch, autoreset=False)
    finally:
        tr.chord_solve = orig

    # --- frozen next_vars: constant loads, no per-step RNG for vars.
    # CONFOUNDED for solve attribution: constant loads at the linearization
    # point make the warm-started solve near-trivial, so the delta mixes
    # RNG savings with solve savings.  Use the deterministic-diurnal
    # ablation below for the RNG-only cost.
    spec = env.spec
    n_vars = spec.n_load + spec.n_gen + task.K
    nominal = jnp.asarray(abs(spec.p_min[spec.load_pos]) * spec.baseMVA, jnp.float32)
    const_vars = jnp.zeros(n_vars, jnp.float32).at[: spec.n_load].set(-nominal * 0.8)

    def frozen_vars(key, s_t, carry, t):
        return const_vars.astype(s_t.dtype), carry

    task5 = dataclasses.replace(task, next_vars_fn=frozen_vars)
    env5 = VecEnv(task5, dtype=jnp.float32)
    results["frozen next_vars"] = time_scan(env5, batch, autoreset=False)

    # --- deterministic diurnal next_vars: same time_factor load shape and
    # task carry, noise fixed at 1.0 — solve difficulty comparable to the
    # full task, so the delta vs "plain step" isolates the per-lane
    # jax.random.normal draw (threefry bits + erf_inv).  Multicap-family
    # only: it mirrors that family's hour-of-day task carry (the base
    # ieee33 task has no carry and no diurnal process).
    if which == "multicap":
        def det_diurnal_vars(key, s_t, hour, t):
            hour = (hour + task.delta_t / 3600.0) % 24.0
            time_factor = 0.8 + 0.3 * jnp.sin((hour - 3.0) * jnp.pi / 12.0)
            loads = (-nominal * time_factor).astype(s_t.dtype)
            tail = jnp.zeros(n_vars - spec.n_load, dtype=s_t.dtype)
            return jnp.concatenate([loads, tail]), hour

        task6 = dataclasses.replace(task, next_vars_fn=det_diurnal_vars)
        env6 = VecEnv(task6, dtype=jnp.float32)
        results["diurnal, no noise RNG"] = time_scan(env6, batch, autoreset=False)

    # --- no obs assembly: the per-step observation (state-vector pack or
    # obs-plan gathers + unit scaling) replaced by zeros — isolates the
    # obs-extraction share of the non-solve floor.
    env7 = VecEnv(task, dtype=jnp.float32)
    zeros_obs = jnp.zeros(env7.n_obs, jnp.float32)
    env7._obs_from_out = lambda out, soc_pu, aux: zeros_obs
    results["no obs assembly"] = time_scan(env7, batch, autoreset=False)

    base = results.get("plain step (no autoreset)", results["full (bench workload)"])
    print(f"\n=== {which} B={batch} ===")
    for name, v in results.items():
        ms = batch / v * 1000.0
        delta = batch / base * 1000.0 - ms
        print(f"{name:32s} {v/1e6:8.2f} M steps/s   {ms:6.3f} ms/step   saves {delta:+6.3f} ms")


if __name__ == "__main__":
    main()
