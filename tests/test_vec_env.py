"""Vectorized environment tier: batching, rollouts, f32 viability, and
statistical agreement with the compat tier."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_anm_tpu.vec import (
    VecEnv,
    make_anm6easy_task,
    make_ieee33_multicap_task,
    make_ieee33_renewable_task,
    make_ieee33_task,
    make_two_bus_task,
)


@pytest.mark.parametrize(
    "factory",
    [make_two_bus_task, make_ieee33_task, make_ieee33_renewable_task,
     make_ieee33_multicap_task, make_anm6easy_task],
)
def test_reset_step_shapes(factory):
    env = VecEnv(factory(), dtype=jnp.float64)
    key = jax.random.PRNGKey(0)
    state, obs = env.reset(key)
    assert obs.shape == (env.n_state,)
    assert not bool(state.terminated)
    action = env.random_policy()(jax.random.PRNGKey(1), obs, 0)
    assert action.shape == (env.n_action,)
    state2, obs2, r, done, info = env.step(state, action)
    assert np.isfinite(float(r))
    assert obs2.shape == obs.shape


def test_vmap_batched_rollout_f64():
    env = VecEnv(make_ieee33_task(), dtype=jnp.float64)
    B, T = 32, 20
    keys = jax.random.split(jax.random.PRNGKey(42), B)
    state, obs = jax.vmap(env.reset)(keys)
    assert obs.shape == (B, env.n_state)

    policy = env.random_policy()
    rollout = jax.jit(lambda s: jax.vmap(lambda st: env.rollout(st, policy, T))(s))
    final, (obs_t, act_t, rew_t, done_t) = rollout(state)
    assert rew_t.shape == (B, T)
    assert np.isfinite(np.asarray(rew_t)).all()


def test_f32_nr_converges_on_ieee33():
    """float32 must reach the 1e-5 NR tolerance on the IEEE33 task — the
    precondition for the f32 throughput path."""
    env = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    B, T = 64, 30
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, obs = jax.vmap(env.reset)(keys)
    policy = env.random_policy()

    lo, hi = env.action_low, env.action_high

    def body(carry, t):
        st, obs = carry
        k = jax.random.fold_in(jax.random.PRNGKey(17), t)
        acts = lo + jax.random.uniform(k, (B, env.n_action), dtype=env.dtype) * (hi - lo)
        st, obs, r, d, info = jax.vmap(env.step_autoreset)(st, acts)
        return (st, obs), (d, info["n_iter"], info["diff"])

    (state, _), (dones, n_iter, diff) = jax.lax.scan(body, (state, obs), jnp.arange(T))
    dones = np.asarray(dones)
    # No lane should diverge on this task in f32.
    assert dones.sum() == 0, f"{dones.sum()} terminations in f32"
    # Residuals reach xtol, except rare lanes that plateau at the f32
    # rounding floor (accepted within 10x of xtol by the stagnation exit).
    assert np.asarray(diff).max() <= 1e-4


def test_vec_vs_compat_reward_statistics():
    """The vec IEEE33 task is deterministic given actions — cross-check a
    full trajectory against the compat env under identical actions."""
    from gym_anm_tpu.compat import IEEE33Env

    env_c = IEEE33Env()
    obs_c, _ = env_c.reset(seed=0)
    env_v = VecEnv(make_ieee33_task(), dtype=jnp.float64)
    state_v, obs_v = env_v.reset(jax.random.PRNGKey(0))
    np.testing.assert_allclose(np.asarray(obs_v), obs_c, atol=1e-9)

    rng = np.random.default_rng(5)
    lo, hi = np.asarray(env_v.action_low), np.asarray(env_v.action_high)
    for _ in range(20):
        a = rng.uniform(lo, hi)
        obs_c, r_c, term_c, _, _ = env_c.step(a)
        state_v, obs_v, r_v, done_v, _ = env_v.step(state_v, jnp.asarray(a))
        assert not term_c and not bool(done_v)
        np.testing.assert_allclose(float(r_v), r_c, atol=1e-9)
        np.testing.assert_allclose(np.asarray(obs_v), obs_c, atol=1e-9)


def test_autoreset_resumes():
    env = VecEnv(make_two_bus_task(), dtype=jnp.float64)
    state, obs = env.reset(jax.random.PRNGKey(0))
    policy = env.random_policy()
    state, traj = env.rollout(state, policy, 50, autoreset=True)
    obs_t, act_t, rew_t, done_t = traj
    assert np.isfinite(np.asarray(rew_t)).all()


def test_step_autoreset_batch_matches_per_lane():
    """step_autoreset_batch must be numerically identical to
    vmap(step_autoreset) — including on batches where SOME lanes are
    terminated (reset branch taken) and batches where none are (reset
    branch skipped at runtime)."""
    from gym_anm_tpu.vec import make_ieee33_task

    env = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    B = 16
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    acts = env.action_low + jax.random.uniform(
        jax.random.PRNGKey(5), (B, env.n_action), jnp.float32
    ) * (env.action_high - env.action_low)

    per_lane = jax.jit(jax.vmap(env.step_autoreset))
    batched = jax.jit(env.step_autoreset_batch)

    def compare(st):
        s1, o1, r1, d1, _ = per_lane(st, acts)
        s2, o2, r2, d2, _ = batched(st, acts)
        np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
        np.testing.assert_array_equal(np.asarray(r1), np.asarray(r2))
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
        for a, b in zip(jax.tree_util.tree_leaves(s1), jax.tree_util.tree_leaves(s2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return s2, d2

    # No-done batch: reset branch skipped at runtime in the batched path.
    s_after, d = compare(state)
    assert not bool(np.asarray(d).any())

    # Mixed batch: force some lanes terminated, so the reset branch runs
    # and lane selection (reset vs stepped) must match per-lane exactly.
    term = jnp.zeros(B, bool).at[jnp.array([1, 5, 11])].set(True)
    compare(s_after._replace(terminated=term))


# ---------------------------------------------------------------------------
# Deterministic cross-tier trajectory tests for the STOCHASTIC tasks: inject
# one identical load/potential sequence into both tiers (overriding
# init_state/next_vars on each) and require ≥20-step agreement of rewards
# and solved bus voltages at f32 tolerance.  Matches the reference's diurnal
# processes (ieee33_renewable_complete.py:188-243) without their RNG.
# ---------------------------------------------------------------------------
import dataclasses


def _injected_compat(base_cls, s0, table, **kw):
    """A compat env whose init_state/next_vars replay fixed sequences."""

    class _Injected(base_cls):
        def __init__(self):
            self._k = 0
            super().__init__(**kw)

        def init_state(self):
            self._k = 0
            return np.array(s0, float).copy()

        def next_vars(self, s_t):
            v = table[min(self._k, len(table) - 1)]
            self._k += 1
            return np.array(v, float).copy()

    return _Injected()


def _injected_vec(task, s0, table):
    tbl = jnp.asarray(np.asarray(table))
    s0j = jnp.asarray(np.asarray(s0))

    def init_state_fn(key, carry):
        return s0j

    def next_vars_fn(key, s_t, carry, t):
        idx = jnp.minimum(t, tbl.shape[0] - 1)
        return tbl[idx].astype(s_t.dtype), carry

    return dataclasses.replace(task, init_state_fn=init_state_fn,
                               next_vars_fn=next_vars_fn,
                               init_task_fn=lambda key: ())


def _compat_bus_vm(env):
    vm = env.simulator.state["bus_v_magn"]["pu"]
    return np.array([vm[k] for k in sorted(vm)])


def _run_cross_tier(env_c, env_v, n_steps, r_atol=2e-4, v_atol=2e-4, r_rtol=1e-3):
    # r_rtol: on violation-heavy steps the penalty is lambda=100 times a sum
    # of voltage-band excesses, so the f32 solver's plateau-accept residual
    # (1e-4) can move the reward by ~1e-3 relative — still 3+ orders below
    # any plumbing bug.
    env_c.reset(seed=0)
    state_v, _ = env_v.reset(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    lo, hi = np.asarray(env_v.action_low, float), np.asarray(env_v.action_high, float)
    step_v = jax.jit(env_v.step)
    for t in range(n_steps):
        a = rng.uniform(lo, hi)
        _, r_c, term_c, _, _ = env_c.step(a)
        state_v, _, r_v, done_v, _ = step_v(state_v, jnp.asarray(a, env_v.dtype))
        assert term_c == bool(done_v), f"step {t}: termination mismatch"
        assert not term_c, f"step {t}: unexpected divergence"
        # On violation steps the reward is O(-100) (lambda=100 on f32
        # voltages), so the f32-vs-f64 gap scales with |r| — rtol governs.
        np.testing.assert_allclose(float(r_v), r_c, atol=r_atol, rtol=r_rtol,
                                   err_msg=f"step {t} reward")
        np.testing.assert_allclose(np.asarray(state_v.bus_vm, float),
                                   _compat_bus_vm(env_c), atol=v_atol,
                                   err_msg=f"step {t} bus |V|")


def _diurnal_table(spec, n_steps, k_gen_extra=0):
    """A deterministic diurnal-ish load sequence in MW (potentials zero —
    the renewable-family quirk) with reproducible pseudo-noise."""
    nominal = np.abs(spec.p_min[spec.load_pos]) * spec.baseMVA
    n_vars = spec.n_load + spec.n_gen + k_gen_extra
    rng = np.random.default_rng(123)
    rows = []
    for t in range(n_steps):
        factor = 0.8 + 0.3 * np.sin((t / 7.0 - 3.0) * np.pi / 12.0)
        noise = 1.0 + 0.02 * rng.standard_normal(nominal.shape)
        row = np.zeros(n_vars)
        row[: spec.n_load] = -nominal * factor * noise
        rows.append(row)
    return np.stack(rows)


def test_cross_tier_trajectory_renewable():
    from gym_anm_tpu.compat import IEEE33RenewableEnv

    task = make_ieee33_renewable_task()
    env_v = VecEnv(_injected_vec(task, *_zero_s0_and_table(task)), dtype=jnp.float32)
    s0, table = _zero_s0_and_table(task)
    env_c = _injected_compat(IEEE33RenewableEnv, s0, table)
    _run_cross_tier(env_c, env_v, 25)


def test_cross_tier_trajectory_multicap():
    from gym_anm_tpu.compat import IEEE33MultiCapacitorEnv

    task = make_ieee33_multicap_task()
    s0, table = _zero_s0_and_table(task)
    env_v = VecEnv(_injected_vec(task, s0, table), dtype=jnp.float32)
    env_c = _injected_compat(IEEE33MultiCapacitorEnv, s0, table)
    _run_cross_tier(env_c, env_v, 25)


def test_cross_tier_trajectory_anm6easy():
    from gym_anm_tpu.compat import ANM6Easy
    from gym_anm_tpu.compat.anm6_easy import _get_gen_time_series, _get_load_time_series
    from gym_anm_tpu.specs.network import load_network
    from gym_anm_tpu.networks import anm6_network

    spec = load_network(anm6_network)
    P_loads, P_maxs = _get_load_time_series(), _get_gen_time_series()
    n_dev, n_des, n_gen = spec.n_dev, spec.n_des, spec.n_gen

    # Fixed start at t0 = 10, gens' Q at 0, storage at mid-SoC (MWh).
    t0 = 10
    s0 = np.zeros(2 * n_dev + n_des + n_gen + 1)
    s0[[1, 3, 5]] = P_loads[:, t0]
    s0[[1 + n_dev, 3 + n_dev, 5 + n_dev]] = P_loads[:, t0] * 0.2
    s0[[2, 4]] = P_maxs[:, t0]
    soc_mid = 0.5 * (spec.soc_min + spec.soc_max)[spec.des_pos] * spec.baseMVA
    s0[2 * n_dev : 2 * n_dev + n_des] = soc_mid
    s0[2 * n_dev + n_des : 2 * n_dev + n_des + n_gen] = P_maxs[:, t0]
    s0[-1] = t0

    # The ANM6Easy vars process is already deterministic given the aux
    # time-of-day: replay it as an explicit table for both tiers.
    n_steps = 25
    table = []
    for t in range(n_steps):
        aux = (t0 + 1 + t) % 96
        table.append(np.concatenate([P_loads[:, aux], P_maxs[:, aux], [aux]]))
    table = np.stack(table)

    task = make_anm6easy_task()
    env_v = VecEnv(_injected_vec(task, s0, table), dtype=jnp.float32)
    env_c = _injected_compat(ANM6Easy, s0, table)
    _run_cross_tier(env_c, env_v, n_steps)


def _zero_s0_and_table(task):
    from gym_anm_tpu.specs.network import load_network

    spec = load_network(task.network)
    s0 = np.zeros(spec.n_state + task.K)
    return s0, _diurnal_table(spec, 30, k_gen_extra=task.K)


def test_cross_tier_trajectory_unequal_switching():
    """Unequal-caps env: rewards INCLUDING the per-step switching costs and
    the three switching info fields must match the compat tier step for
    step (ieee33_unequal_capacitors.py:144-169 semantics, incl. the
    rating-sorted-costs vs action-ordered-switches pairing quirk)."""
    from gym_anm_tpu.compat import IEEE33UnequalCapacitorsEnv
    from gym_anm_tpu.vec import make_ieee33_unequal_task

    task = make_ieee33_unequal_task()
    s0, table = _zero_s0_and_table(task)
    env_v = VecEnv(_injected_vec(task, s0, table), dtype=jnp.float32)
    env_c = _injected_compat(IEEE33UnequalCapacitorsEnv, s0, table)

    env_c.reset(seed=0)
    state_v, _ = env_v.reset(jax.random.PRNGKey(0))
    assert state_v.shaping[0].shape == (6,)
    rng = np.random.default_rng(7)
    lo, hi = np.asarray(env_v.action_low, float), np.asarray(env_v.action_high, float)
    step_v = jax.jit(env_v.step)
    for t in range(20):
        # Quantize cap entries to a 0.04 grid so successive deltas are
        # multiples of 0.04 — never AT the 0.01 switch threshold, where
        # f32 and f64 could disagree on the strict > comparison.
        a = rng.uniform(lo, hi)
        a[10:16] = np.floor(a[10:16] / 0.04) * 0.04  # floor: stays in [0, hi]
        _, r_c, term_c, _, info_c = env_c.step(a)
        state_v, _, r_v, done_v, info_v = step_v(state_v, jnp.asarray(a, env_v.dtype))
        assert not term_c and not bool(done_v), f"step {t}: divergence"
        np.testing.assert_allclose(float(r_v), r_c, atol=2e-4, rtol=1e-3,
                                   err_msg=f"step {t} reward")
        np.testing.assert_allclose(float(info_v["switching_cost"]),
                                   info_c["switching_cost"], atol=1e-6,
                                   err_msg=f"step {t} switching cost")
        assert int(info_v["total_switches"]) == int(info_c["total_switches"])
        np.testing.assert_allclose(float(info_v["cumulative_switching_cost"]),
                                   info_c["cumulative_switching_cost"], atol=1e-5)


def test_rbg_keys_supported():
    """farm_keys(impl='rbg') — the RngBitGenerator key flavor —
    flows through reset, batched autoreset step, and scan rollouts with
    healthy solves."""
    from gym_anm_tpu.vec import farm_keys

    env = VecEnv(make_ieee33_multicap_task(), dtype=jnp.float32)
    keys = farm_keys(0, 16, impl="rbg")
    assert jax.dtypes.issubdtype(keys.dtype, jax.dtypes.prng_key)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    assert np.isfinite(np.asarray(obs)).all()
    acts = jax.vmap(env.random_policy(), in_axes=(0, 0, None))(
        jax.random.split(jax.random.key(1, impl="rbg"), 16), obs, 0)
    state, obs, r, d, info = jax.jit(env.step_autoreset_batch)(state, acts)
    assert np.asarray(info["diff"]).max() <= 1e-4
    assert np.isfinite(np.asarray(r)).all()
    # per-lane streams are independent: two lanes see different loads
    assert not np.allclose(np.asarray(obs)[0], np.asarray(obs)[1])


@pytest.mark.parametrize(
    "factory",
    [make_ieee33_task, make_ieee33_renewable_task, make_ieee33_multicap_task,
     make_anm6easy_task],
)
def test_no_batched_f64_in_f32_step(factory):
    """Under the package's global x64, an unannotated jax.random draw (or
    table gather) silently computes in float64 on the f32 hot path (the
    multicap load-noise draw once did).  Guard: the lowered f32 autoreset
    step contains no batch-dimensioned f64 tensor (per-lane f64 scalars
    like the hour-of-day carry are fine; so are constant-folded tables)."""
    import re

    env = VecEnv(factory(), dtype=jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    acts = jnp.zeros((4, env.n_action), jnp.float32)
    txt = jax.jit(env.step_autoreset_batch).lower(state, acts).as_text()
    leaks = sorted(set(re.findall(r"tensor<4x\d+[x\d]*xf64>", txt)))
    assert not leaks, leaks


def test_no_batched_f64_in_expert_zoo():
    """Same x64 guard for the on-device expert zoo (f64 numpy bound tables
    mixed into lane math promote the whole action expression)."""
    import re

    from gym_anm_tpu.vec.experts import make_expert_zoo

    env = VecEnv(make_ieee33_multicap_task(), dtype=jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    for ctl in make_expert_zoo(env):
        carry = jax.vmap(ctl.init_carry)(keys)
        txt = jax.jit(jax.vmap(ctl.act)).lower(keys, state, obs, carry).as_text()
        leaks = sorted(set(re.findall(r"tensor<4x\d+[x\d]*xf64>", txt)))
        assert not leaks, (ctl.name, leaks)


def test_vec_tier_runs_without_gymnasium():
    """Gymnasium is optional outside the compat tier: with it blocked, the
    vec tier imports and builds the four bench tasks, and the compat tier
    says what it needs."""
    import os
    import subprocess
    import sys

    code = (
        "import sys; sys.modules['gymnasium'] = None\n"
        "import jax.numpy as jnp\n"
        "from gym_anm_tpu.vec import (VecEnv, make_anm6easy_task, make_ieee33_multicap_task,\n"
        "                             make_ieee33_task, make_vec_mpc)\n"
        "import bench, gym_anm_tpu.offline_vec, gym_anm_tpu.parallel\n"
        "for f in (make_ieee33_task, make_ieee33_multicap_task, make_anm6easy_task):\n"
        "    VecEnv(f(), dtype=jnp.float32)\n"
        "try:\n"
        "    import gym_anm_tpu.compat\n"
        "except ImportError as e:\n"
        "    print('COMPAT', e)\n"
        "print('VEC_OK')\n"
    )
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "VEC_OK" in r.stdout
    assert "COMPAT" in r.stdout and "gymnasium" in r.stdout

