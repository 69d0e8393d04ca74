"""Headline benchmark: batched env-steps/s on one GPU.

Measures five workloads, lightest to heaviest:

1. ``ieee33`` (headline) — the base 33-bus task (3-dim action: 2 caps +
   OLTC), full step: device projections, Y-bus, Newton-Raphson AC load
   flow (xtol 1e-5), branch flows, reward.  Uniform-random actions, no
   autoreset (random actions never diverge this task — verified in
   tests/test_vec_env.py — and the reset program out of the scan body
   halves compile time).  Run at B=8192 and at B=32768.
2. ``multicap17`` (flagship) — the 17-dim IEEE33MultiCapacitorEnv config
   from BASELINE.json (5 renewable P + 5 Q with polytope projections,
   6 capacitor banks, OLTC, diurnal loads with per-step noise,
   reference action layout ieee33_multi_capacitor.py:75-88), random
   actions WITH autoreset — the honest dataset-generation step.
3. ``l0l5_dataset`` — L0-L5 controller-in-the-loop mixed dataset
   generation on the 17-dim task: all six vectorized controllers run
   in ONE compiled program (static lane assignment), trajectories
   (obs, action, reward, next_obs, done) stacked on device — the
   offline-RL collection workload of the reference's
   generate_final_offline_datasets.py.
4. ``mpc_rollout`` — the ANM6Easy MPC farm: every lane's N=1 DC-OPF
   solved by the batched ADMM inside the compiled step.

Baseline: the reference (halduaij/gym-anm) IEEE33Env.step() runs at
~122 steps/s on one CPU core (scipy spsolve NR, 50-step rollout) — see
BASELINE.md.

Prints the device (platform, kind, count) and the card's name and power
limit, then ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", "extra_metrics": [...]}; the headline fields describe workload
1, the others ride in "extra_metrics" (same schema each).  Exits non-zero
when JAX finds no GPU or when any workload failed.

Usage: python bench.py [BATCH] [--quick] [--rng=rbg]
"""

import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

REFERENCE_STEPS_PER_S = 122.0  # reference IEEE33Env.step, 1 CPU core


def gpu_name_and_power_limit():
    """``name, power.limit`` of the card as nvidia-smi reports it (a plain
    subprocess that never touches JAX or the device's memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    """The device dict {platform, kind, count} of JAX's GPU backend.

    Raises SystemExit (non-zero) when JAX finds no GPU: a measurement on
    another backend is never reported under a GPU's name."""
    try:
        devices = jax.devices()
    except RuntimeError as e:
        raise SystemExit(f"no GPU: JAX could not initialize a backend ({e})")
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default platform is {devices[0].platform!r}; "
            "this program measures the GPU and does not fall back")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def _time_reps(run_rep, n_reps, steps_per_rep):
    """Compile + settle, then measure the SUSTAINED device rate.

    ``run_rep(rep)`` dispatches one repetition and returns its outputs.
    Protocol: time 1 rep and ``n_reps`` reps, each ended by
    ``jax.block_until_ready``, and report the marginal rate
    ``(n_reps − 1)·W / (t_n − t_1)``, which cancels the constant
    per-region costs (dispatch of the first call, pipeline ramp)."""
    jax.block_until_ready(run_rep(0))  # compile + settle
    t0 = time.perf_counter()
    jax.block_until_ready(run_rep(1))
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    for rep in range(n_reps):
        out = run_rep(rep + 2)
    jax.block_until_ready(out)
    tn = time.perf_counter() - t0
    if n_reps > 1 and tn > t1 > 0:
        return steps_per_rep * (n_reps - 1) / (tn - t1)
    return steps_per_rep * n_reps / tn


def _chained(run_jit, *carry):
    """A ``run_rep`` over a jitted ``run(*carry, seed) -> (*carry, total)``
    whose carry is donated and threaded from one repetition to the next."""
    carry = list(carry)

    def run_rep(rep):
        out = run_jit(*carry, rep)
        carry[:] = out[:-1]
        return out[-1]

    return run_rep


def make_random_run(env, batch, n_steps, autoreset, rng_impl=None):
    """Build the random-action scan program + initial state (workloads 1
    and 2; also compiled and checked by chip_smoke.py)."""
    from gym_anm_tpu.vec import farm_keys

    lo, hi = env.action_low, env.action_high
    keys = farm_keys(0, batch, impl=rng_impl)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    # Batch-level autoreset: the reset program is skipped at runtime on
    # steps where no lane terminated (env.step_autoreset_batch).
    step = env.step_autoreset_batch if autoreset else (
        lambda st, a: jax.vmap(env.step)(st, a))

    def run(state, obs, seed):
        seed_key = (jax.random.key(seed, impl=rng_impl) if rng_impl
                    else jax.random.PRNGKey(seed))

        def body(carry, t):
            st, obs = carry
            k = jax.random.fold_in(seed_key, t)
            acts = lo + jax.random.uniform(k, (batch, env.n_action), dtype=env.dtype) * (hi - lo)
            st, obs, r, d, _ = step(st, acts)
            return (st, obs), r.sum()

        (state, obs), rs = jax.lax.scan(body, (state, obs), jnp.arange(n_steps))
        return state, obs, rs.sum()

    return jax.jit(run, donate_argnums=(0,)), state, obs


def bench_random(env, batch, n_steps, n_reps, autoreset, rng_impl=None):
    """Random-action throughput for one VecEnv (workloads 1 and 2)."""
    run_jit, state, obs = make_random_run(env, batch, n_steps, autoreset, rng_impl)
    return _time_reps(_chained(run_jit, state, obs), n_reps, batch * n_steps)


def bench_l0l5_dataset(env, batch, n_steps, n_reps):
    """Mixed L0-L5 controller-in-the-loop dataset generation (workload 3).

    Uses the block-assignment collector: each controller drives its own
    contiguous lane block via static slicing, so its ``act`` runs on B/6
    lanes instead of all six controllers running masked on every lane
    (semantics pinned against make_mixed_collector in tests)."""
    from gym_anm_tpu.offline_vec import make_block_collector
    from gym_anm_tpu.vec.controllers import make_suite

    collect, _assignment = make_block_collector(env, make_suite(env), batch, n_steps)
    return _time_reps(lambda rep: collect(jax.random.PRNGKey(rep)), n_reps,
                      batch * n_steps)


def make_mpc_run(batch, n_steps, dtype=jnp.float32):
    """The MPC farm scan program + initial carry (workload 4): every lane's
    N=1 DC-OPF solved by the batched ADMM inside the compiled step
    (vec/mpc.py) — the regime of MPC-expert offline dataset generation.
    ANM6Easy (the reference MPC's own task); warm starts carry across
    steps.  ``dtype`` float64 builds the f64 tier of the same farm.

    Returns ``(run_jit, step, state, obs, carry)``:
    ``run_jit(state, obs, carry, seed) -> (state, obs, carry, reward_sum)``
    scans ``n_steps`` of ``step(state, obs, carry, key) -> (state, obs,
    carry, action, reward, done, info)``, one batched MPC + env step."""
    from gym_anm_tpu.vec import VecEnv, make_anm6easy_task, make_vec_mpc

    env = VecEnv(make_anm6easy_task(), dtype=dtype)
    ctrl = make_vec_mpc(env, gamma=0.995, safety_margin=0.96, planning_steps=1)
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    carry0 = jax.vmap(ctrl.init_carry)(keys)

    def step(st, obs, carry, key):
        a, carry = jax.vmap(ctrl.act)(jax.random.split(key, batch), st, obs, carry)
        st, obs, r, d, info = env.step_autoreset_batch(st, a)
        return st, obs, carry, a, r, d, info

    def run(state, obs, carry, seed):
        def body(sc, t):
            st, obs, carry = sc
            st, obs, carry, _, r, _, _ = step(
                st, obs, carry, jax.random.fold_in(jax.random.PRNGKey(seed), t))
            return (st, obs, carry), r.sum()

        (state, obs, carry), rs = jax.lax.scan(body, (state, obs, carry), jnp.arange(n_steps))
        return state, obs, carry, rs.sum()

    return jax.jit(run, donate_argnums=(0, 2)), step, state, obs, carry0


def bench_mpc_rollout(batch, n_steps, n_reps):
    """MPC-in-the-loop farm rollout throughput (workload 4)."""
    run_jit, _step, state, obs, carry = make_mpc_run(batch, n_steps)
    return _time_reps(_chained(run_jit, state, obs, carry), n_reps, batch * n_steps)


def _metric(name, steps_per_s):
    return {
        "metric": name,
        "value": round(steps_per_s, 1),
        "unit": "env-steps/s",
        "vs_baseline": round(steps_per_s / REFERENCE_STEPS_PER_S, 1),
    }


def _run_workload(name, fn, sink, errors):
    """Fault isolation: one workload's failure (compile error, device
    fault) must not hide the others' metrics — survivors still report,
    the failure rides in the JSON and the exit code."""
    import traceback

    try:
        sink.append(_metric(name, fn()))
        return True
    except Exception as e:  # noqa: BLE001 — deliberately broad: report, don't die
        tb = traceback.format_exc(limit=3)
        print(f"workload {name} FAILED: {e}\n{tb}", file=sys.stderr)
        errors.append({"metric": name, "error": f"{type(e).__name__}: {e}"})
        return False


def main(batch=8192, quick=False, rng_impl=None):
    device = require_gpu()
    print(f"device: {json.dumps(device)}")
    print(f"card: {gpu_name_and_power_limit()}")
    from gym_anm_tpu.vec import VecEnv, make_ieee33_multicap_task, make_ieee33_task

    # 128 steps per dispatch: lax.scan compiles its body once, so the
    # longer trip count costs no compile time and amortizes the per-call
    # dispatch.
    env = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    head_sink, extras, errors = [], [], []

    # 1. Headline: base IEEE33, 3-dim action, plain step.
    _run_workload(
        f"ieee33_env_steps_per_s_b{batch}_1chip",
        lambda: bench_random(env, batch, n_steps=128, n_reps=3,
                             autoreset=False, rng_impl=rng_impl),
        head_sink, errors)

    if not quick:
        # 1b. Base task at B=32768: the larger batch amortizes the
        # per-kernel launch cost over four times the lanes.
        _run_workload(
            "ieee33_env_steps_per_s_b32768_1chip",
            lambda: bench_random(env, 32768, n_steps=128, n_reps=3,
                                 autoreset=False, rng_impl=rng_impl),
            extras, errors)

        # 2. Flagship: 17-dim multicap, random actions + autoreset.
        env_mc = VecEnv(make_ieee33_multicap_task(), dtype=jnp.float32)
        _run_workload(
            f"ieee33_multicap17_env_steps_per_s_b{batch}_1chip",
            lambda: bench_random(env_mc, batch, n_steps=128, n_reps=3,
                                 autoreset=True, rng_impl=rng_impl),
            extras, errors)

        # 3. L0-L5 controller-in-the-loop dataset generation on the 17-dim task.
        _run_workload(
            f"ieee33_multicap17_l0l5_dataset_steps_per_s_b{batch}_1chip",
            lambda: bench_l0l5_dataset(env_mc, batch, n_steps=64, n_reps=3),
            extras, errors)

        # 4. MPC-in-the-loop rollout: batched ADMM DC-OPF per lane per step.
        _run_workload(
            f"anm6easy_mpc_rollout_steps_per_s_b{batch}_1chip",
            lambda: bench_mpc_rollout(batch, n_steps=64, n_reps=3),
            extras, errors)

    if head_sink:
        headline = head_sink[0]
    elif extras:
        # headline failed but others survived: promote the first survivor
        # so the run still records a parseable metric
        headline = extras.pop(0)
    else:
        headline = {"metric": "bench_failed", "value": 0.0,
                    "unit": "env-steps/s", "vs_baseline": 0.0}
    headline["device"] = device
    headline["extra_metrics"] = extras
    if errors:
        headline["errors"] = errors
    print(json.dumps(headline))
    return 1 if errors else 0


if __name__ == "__main__":
    rng_impl = None
    for a in sys.argv[1:]:
        if a.startswith("--rng="):
            rng_impl = a.split("=", 1)[1]
            if rng_impl in ("threefry", "default"):
                rng_impl = None
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    sys.exit(main(
        batch=int(args[0]) if args else 8192,
        quick="--quick" in sys.argv,
        rng_impl=rng_impl,
    ))
