"""On-device batched ADMM DC-OPF MPC (gym_anm_tpu.vec.mpc).

Ground truth is scipy HiGHS solving the SAME DCOPFStructure the ADMM
solver consumes (both tiers share one assembly — agents/mpc.py), so any
disagreement is solver error, not formulation drift.  Measured errors on
ANM6Easy: f64 N=1 → 3.9e-4 MW, f32 N=1 → 3.0e-3 MW, f32 N=4 → 8.8e-4 MW
stage-0 action deviation; tolerances below are ~5× those floors.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import linprog

from gym_anm_tpu.agents.mpc import MPCAgentConstant
from gym_anm_tpu.compat import ANM6Easy
from gym_anm_tpu.vec import VecEnv, make_anm6easy_task
from gym_anm_tpu.vec.mpc import (
    init_warm,
    lane_bounds,
    make_vec_dcopf,
    make_vec_mpc,
    make_vec_mpc_perfect,
    solve_dcopf,
)


@pytest.fixture(scope="module")
def host_problem():
    """(agent, P_load, P_gen, init_soc) from a stepped ANM6Easy env."""
    rng_state = np.random.get_state()
    np.random.seed(0)
    env = ANM6Easy()
    env.reset(seed=0)
    # Deterministic mid-range actions (space.sample() carries its own
    # OS-entropy RNG — a different LP instance every run).
    a_mid = (env.action_space.low + env.action_space.high) / 2.0
    for _ in range(3):
        env.step(a_mid)
    np.random.set_state(rng_state)

    def build(N):
        agent = MPCAgentConstant(
            env.simulator, env.action_space, gamma=0.995,
            safety_margin=0.96, planning_steps=N,
        )
        P_load, P_gen = agent.forecast(env)
        init_soc = np.array(
            [env.simulator.state["des_soc"]["pu"][i] for i in agent.des_ids]
        )
        return agent, P_load, P_gen, init_soc

    return build


def _highs_action(st, P_load, P_gen, init_soc):
    lb, ub, b_eq = st.lb.copy(), st.ub.copy(), st.b_eq.copy()
    lb[st.load_pin_idx] = P_load
    ub[st.load_pin_idx] = P_load
    ub[st.gen_cap_idx] = np.minimum(st.gen_pmax[:, None], P_gen)
    b_eq[st.soc_rows] = init_soc
    res = linprog(
        st.c, A_eq=st.A_eq, b_eq=b_eq, A_ub=st.A_ub, b_ub=st.b_ub,
        bounds=np.stack([lb, ub], axis=1), method="highs",
    )
    assert res.success
    return res.x[st.act_idx] * st.baseMVA, res.fun


@pytest.mark.parametrize(
    "N,dtype,tol_mw",
    [(1, jnp.float64, 5e-3), (1, jnp.float32, 2e-2), (4, jnp.float32, 2e-2)],
)
def test_admm_matches_highs(host_problem, N, dtype, tol_mw):
    """Stage-0 action parity vs HiGHS on the live ANM6Easy DC-OPF."""
    agent, P_load, P_gen, init_soc = host_problem(N)
    st = agent.structure
    a_ref, obj_ref = _highs_action(st, P_load, P_gen, init_soc)

    dc = make_vec_dcopf(st, dtype=dtype, max_iter=10000)
    l, u = lane_bounds(dc, jnp.asarray(P_load), jnp.asarray(P_gen),
                       jnp.asarray(init_soc))
    sol = jax.jit(lambda l, u: solve_dcopf(dc, l, u))(l, u)
    assert bool(sol.converged)
    a = np.asarray(sol.x)[st.act_idx] * st.baseMVA
    assert np.max(np.abs(a - a_ref)) <= tol_mw
    # Objective agreement (the LP optimum, not just a feasible point).
    obj = float(st.c @ np.asarray(sol.x, dtype=np.float64))
    assert abs(obj - obj_ref) <= 1e-3 * max(1.0, abs(obj_ref))


def test_vmap_batch_matches_per_lane_highs(host_problem):
    """3 lanes with different pinned loads, one vmapped solve; each lane
    matches its own HiGHS solution."""
    agent, P_load, P_gen, init_soc = host_problem(1)
    st = agent.structure
    dc = make_vec_dcopf(st, dtype=jnp.float32)

    scales = [0.8, 1.0, 1.2]
    ls, us, refs = [], [], []
    for s in scales:
        l, u = lane_bounds(dc, jnp.asarray(P_load * s), jnp.asarray(P_gen),
                           jnp.asarray(init_soc))
        ls.append(l)
        us.append(u)
        refs.append(_highs_action(st, P_load * s, P_gen, init_soc)[0])

    sols = jax.jit(jax.vmap(lambda l, u: solve_dcopf(dc, l, u)))(
        jnp.stack(ls), jnp.stack(us)
    )
    assert bool(jnp.all(sols.converged))
    acts = np.asarray(sols.x)[:, st.act_idx] * st.baseMVA
    for a, a_ref in zip(acts, refs):
        assert np.max(np.abs(a - a_ref)) <= 2e-2


def test_warm_start_cuts_iterations(host_problem):
    """Re-solving the same lane from its own warm tuple is much cheaper
    than the cold solve (the controller's step-to-step regime)."""
    agent, P_load, P_gen, init_soc = host_problem(4)
    dc = make_vec_dcopf(agent.structure, dtype=jnp.float32)
    l, u = lane_bounds(dc, jnp.asarray(P_load), jnp.asarray(P_gen),
                       jnp.asarray(init_soc))
    cold = jax.jit(lambda l, u: solve_dcopf(dc, l, u))(l, u)
    warm = jax.jit(lambda l, u, w: solve_dcopf(dc, l, u, warm=w))(l, u, cold.warm)
    assert bool(warm.converged)
    assert int(warm.iterations) < int(cold.iterations) // 2


def test_lane_bounds_slot_mapping(host_problem):
    """lane_bounds writes exactly the host _solve slots: pinned loads
    (l == u), capped gens (u = min(pmax, pot)), SoC equality rows."""
    agent, P_load, P_gen, init_soc = host_problem(2)
    st = agent.structure
    dc = make_vec_dcopf(st, dtype=jnp.float64)
    l, u = map(np.asarray, lane_bounds(
        dc, jnp.asarray(P_load), jnp.asarray(P_gen), jnp.asarray(init_soc)
    ))
    n_eq = st.A_eq.shape[0]
    n_ub = st.A_ub.shape[0] if st.A_ub is not None else 0
    bound0 = n_eq + n_ub
    np.testing.assert_allclose(l[bound0 + st.load_pin_idx], P_load, atol=1e-12)
    np.testing.assert_allclose(u[bound0 + st.load_pin_idx], P_load, atol=1e-12)
    np.testing.assert_allclose(
        u[bound0 + st.gen_cap_idx], np.minimum(st.gen_pmax[:, None], P_gen),
        atol=1e-12,
    )
    np.testing.assert_allclose(l[st.soc_rows], init_soc, atol=1e-12)
    np.testing.assert_allclose(u[st.soc_rows], init_soc, atol=1e-12)
    # Untouched rows keep the (finite-clamped) template.
    touched = np.zeros(dc.m, dtype=bool)
    touched[bound0 + st.load_pin_idx.ravel()] = True
    touched[bound0 + st.gen_cap_idx.ravel()] = True
    touched[st.soc_rows] = True
    np.testing.assert_array_equal(l[~touched], np.asarray(dc.l_tmpl)[~touched])
    np.testing.assert_array_equal(u[~touched], np.asarray(dc.u_tmpl)[~touched])


def test_vec_mpc_controller_rollout():
    """make_vec_mpc rolls out inside the compiled vec step at informed-
    controller reward levels (random ANM6 actions collapse to ~-100s)."""
    from gym_anm_tpu.offline_vec import evaluate_controller_vec

    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    ctrl = make_vec_mpc(env, gamma=0.995, safety_margin=0.96, planning_steps=1)
    m = evaluate_controller_vec(env, ctrl, jax.random.PRNGKey(0), batch=4, steps=6)
    assert np.isfinite(m)
    assert m > -5.0


def test_act_program_is_f64_free():
    """The controller's compiled act program must not drag f64 chains
    onto the f32 hot path (tests/test_no_f64_hotpath.py rationale)."""
    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    ctrl = make_vec_mpc(env, gamma=0.995, planning_steps=1)
    state, _ = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(0), 4)
    )
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    carry = jax.vmap(ctrl.init_carry)(jax.random.split(jax.random.PRNGKey(1), 4))
    hlo = (
        jax.jit(jax.vmap(ctrl.act))
        .lower(keys, state, jnp.zeros((4, env.n_obs), jnp.float32), carry)
        .compile()
        .as_text()
    )
    leaks = re.findall(r"f64\[[0-9,]*\][^ ]* (\w+)", hlo)
    assert not leaks, f"vec MPC act leaks f64 ops: {leaks[:10]}"


def test_rollout_objective_parity_vs_highs():
    """Along a live warm-started rollout the LP is frequently DEGENERATE
    (zero-cost DES/renewable trades): ADMM then returns a different point
    of the optimal face than HiGHS' vertex, so the invariant to pin is
    objective parity + feasibility, not action parity (module docstring;
    measured action gaps reach 2.2 MW at equal objective)."""
    from gym_anm_tpu.agents.mpc import MPCAgent
    from gym_anm_tpu.env.simulator import Simulator

    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    sim = Simulator(env.task.network, env.task.delta_t, env.task.lamb)
    agent = MPCAgent(sim, action_space=None, gamma=0.995,
                     safety_margin=0.9, planning_steps=1)
    st = agent.structure
    dc = make_vec_dcopf(st, dtype=jnp.float32, max_iter=10000)
    load_pos = np.asarray(env.spec.load_pos)
    sl = env._action_slices
    n_g = len(agent.non_slack_gen_ids)
    n_eq = st.A_eq.shape[0]
    n_ub = st.A_ub.shape[0] if st.A_ub is not None else 0
    bound0 = n_eq + n_ub

    solve = jax.jit(lambda l, u, w: solve_dcopf(dc, l, u, warm=w))
    step = jax.jit(env.step)
    state, _ = jax.jit(env.reset)(jax.random.PRNGKey(0))
    warm = init_warm(dc)
    for t in range(8):
        l, u = lane_bounds(dc, state.dev_p[load_pos], state.p_pot, state.soc)
        sol = solve(l, u, warm)
        warm = sol.warm
        x = np.asarray(sol.x, dtype=np.float64)
        ln, un = np.asarray(l, np.float64), np.asarray(u, np.float64)

        res = linprog(
            st.c, A_eq=st.A_eq, b_eq=ln[:n_eq], A_ub=st.A_ub,
            b_ub=un[n_eq:bound0],
            bounds=np.stack([ln[bound0:], un[bound0:]], axis=1),
            method="highs",
        )
        assert res.success
        obj = st.c @ x
        assert obj <= res.fun + 1e-3 * max(1.0, abs(res.fun)), t
        # Feasibility at solver tolerance.
        assert np.max(np.abs(st.A_eq @ x - ln[:n_eq])) <= 1e-3, t
        if st.A_ub is not None:
            assert np.max(st.A_ub @ x - un[n_eq:bound0]) <= 1e-3, t
        assert np.max(ln[bound0:] - x) <= 1e-3 and np.max(x - un[bound0:]) <= 1e-3, t

        P = sol.x[dc.act_idx] * dc.baseMVA
        a = jnp.zeros(env.n_action, dtype=env.dtype)
        a = a.at[sl["P_gen"]].set(P[:n_g].astype(env.dtype))
        a = a.at[sl["P_des"]].set(P[n_g:].astype(env.dtype))
        a = a.at[sl["tap"]].set(1.0)
        a = jnp.clip(a, env.action_low, env.action_high)
        state, _, r, d, _ = step(state, a)
        assert np.isfinite(float(r)) and not bool(d)


def test_profile_forecast_matches_reference_agent():
    """profile_forecast_fn reproduces MPCAgentPerfect.forecast exactly,
    including the day-boundary wraparound (mpc_perfect.py:7-40 does it by
    table concatenation; the vec hook by mod-96 gather)."""
    from types import SimpleNamespace

    from gym_anm_tpu.agents.mpc import MPCAgentPerfect
    from gym_anm_tpu.compat.anm6_easy import (
        _get_gen_time_series,
        _get_load_time_series,
    )
    from gym_anm_tpu.vec.mpc import profile_forecast_fn

    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    N = 5
    fc = profile_forecast_fn(env, N)

    # MPCAgentPerfect.forecast reads only planning_steps/baseMVA off self
    # and state[-1]/P_loads/P_maxs off the env.
    agent = MPCAgentPerfect.__new__(MPCAgentPerfect)
    agent.planning_steps, agent.baseMVA = N, float(env.spec.baseMVA)
    state, _ = jax.jit(env.reset)(jax.random.PRNGKey(3))
    for t0 in (0, 40, 93, 95):  # 93/95 wrap the 96-column day
        ld, gn = jax.jit(fc)(state._replace(aux=jnp.array([float(t0)], jnp.float32)))
        fake = SimpleNamespace(
            state=np.array([t0], dtype=float),
            P_loads=_get_load_time_series(),
            P_maxs=_get_gen_time_series(),
        )
        ld_ref, gn_ref = agent.forecast(fake)
        np.testing.assert_allclose(np.asarray(ld), ld_ref, atol=1e-6)
        np.testing.assert_allclose(np.asarray(gn), gn_ref, atol=1e-6)


def test_admm_perfect_forecast_matches_highs(host_problem):
    """The N=4 perfect-forecast LP (time-varying pinned loads/caps) solved
    by ADMM matches HiGHS stage-0 actions and objective."""
    from gym_anm_tpu.agents.mpc import MPCAgentPerfect
    from gym_anm_tpu.compat.anm6_easy import (
        _get_gen_time_series,
        _get_load_time_series,
    )
    from types import SimpleNamespace

    agent, _, _, init_soc = host_problem(4)
    st = agent.structure
    # MPCAgentPerfect.forecast reads only planning_steps and baseMVA.
    pa = MPCAgentPerfect.__new__(MPCAgentPerfect)
    pa.planning_steps, pa.baseMVA = 4, st.baseMVA
    fake = SimpleNamespace(
        state=np.array([17.0]), P_loads=_get_load_time_series(),
        P_maxs=_get_gen_time_series(),
    )
    P_load, P_gen = pa.forecast(fake)
    a_ref, obj_ref = _highs_action(st, P_load, P_gen, init_soc)

    dc = make_vec_dcopf(st, dtype=jnp.float32, max_iter=10000)
    l, u = lane_bounds(dc, jnp.asarray(P_load), jnp.asarray(P_gen),
                       jnp.asarray(init_soc))
    sol = jax.jit(lambda l, u: solve_dcopf(dc, l, u))(l, u)
    assert bool(sol.converged)
    a = np.asarray(sol.x)[st.act_idx] * st.baseMVA
    assert np.max(np.abs(a - a_ref)) <= 2e-2
    obj = float(st.c @ np.asarray(sol.x, dtype=np.float64))
    assert abs(obj - obj_ref) <= 1e-3 * max(1.0, abs(obj_ref))


def test_vec_mpc_perfect_rollout():
    """make_vec_mpc_perfect rolls out on the vec farm at informed-
    controller reward (same bar as the constant variant)."""
    from gym_anm_tpu.offline_vec import evaluate_controller_vec

    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    ctrl = make_vec_mpc_perfect(env, gamma=0.995, safety_margin=0.96,
                                planning_steps=4)
    assert ctrl.name == "MPC4_perfect"
    m = evaluate_controller_vec(env, ctrl, jax.random.PRNGKey(0), batch=4, steps=6)
    assert np.isfinite(m)
    assert m > -5.0


def test_perfect_act_program_is_f64_free():
    """The perfect-forecast act program (table gathers + solve) must also
    stay f64-free on the hot path."""
    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    ctrl = make_vec_mpc_perfect(env, gamma=0.995, planning_steps=4)
    state, _ = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(0), 4)
    )
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    carry = jax.vmap(ctrl.init_carry)(jax.random.split(jax.random.PRNGKey(1), 4))
    hlo = (
        jax.jit(jax.vmap(ctrl.act))
        .lower(keys, state, jnp.zeros((4, env.n_obs), jnp.float32), carry)
        .compile()
        .as_text()
    )
    leaks = re.findall(r"f64\[[0-9,]*\][^ ]* (\w+)", hlo)
    assert not leaks, f"vec perfect MPC act leaks f64 ops: {leaks[:10]}"


def test_mpc_in_the_loop_dataset_generation():
    """The MPC controllers compose with the on-device dataset collector
    (the warm-start tuple rides the collector's carry threading), so
    MPC-expert offline datasets generate entirely on device."""
    from gym_anm_tpu.offline_vec import generate_dataset_vec

    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    ctrl = make_vec_mpc_perfect(env, gamma=0.995, safety_margin=0.96,
                                planning_steps=2)
    batch, steps = 3, 4
    obs, act, rew, obs2, done = generate_dataset_vec(
        env, ctrl, jax.random.PRNGKey(0), batch=batch, steps=steps
    )
    assert obs.shape == (steps, batch, env.n_obs)
    assert act.shape == (steps, batch, env.n_action)
    for arr in (obs, act, rew, obs2):
        assert np.all(np.isfinite(np.asarray(arr)))
    lo, hi = np.asarray(env.action_low), np.asarray(env.action_high)
    assert np.all(act >= lo - 1e-6) and np.all(act <= hi + 1e-6)
    # MPC actions are informed, not degenerate: rewards at controller level.
    assert float(np.mean(rew)) > -5.0


def test_infeasible_lane_skips_loop_and_reports_unconverged(host_problem):
    """A structurally infeasible lane (crossed bound row) must exit with
    converged=False after ZERO iterations — not burn max_iter — and must
    not stall the rest of a vmapped batch."""
    agent, P_load, P_gen, init_soc = host_problem(1)
    dc = make_vec_dcopf(agent.structure, dtype=jnp.float32)
    l, u = lane_bounds(dc, jnp.asarray(P_load), jnp.asarray(P_gen),
                       jnp.asarray(init_soc))
    bound0 = dc.m - dc.n
    l_bad = l.at[bound0 + 3].set(u[bound0 + 3] + 1.0)

    sols = jax.jit(jax.vmap(lambda l, u: solve_dcopf(dc, l, u)))(
        jnp.stack([l_bad, l]), jnp.stack([u, u])
    )
    assert not bool(sols.converged[0])
    assert not bool(sols.feasible[0])
    assert int(sols.iterations[0]) == 0
    assert bool(sols.converged[1])
    assert bool(sols.feasible[1])
    assert int(sols.iterations[1]) < dc.max_iter


def test_structurally_unsolvable_lane_gets_idle_action():
    """make_vec_mpc idles ONLY the lanes whose LP data is unsolvable
    (crossed bound rows — the condition that makes the host tier's HiGHS
    call fail into its zero-action branch).  A merely unconverged or
    band-borderline iterate is still applied: a near-optimal dispatch
    beats a zero dispatch, and the env projects actions anyway."""
    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    ctrl = make_vec_mpc(env, gamma=0.995, planning_steps=1)
    state, obs = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(0), 2)
    )
    # Lane 0: a NEGATIVE renewable potential folds into a gen-cap upper
    # bound below the box lower bound -> crossed row -> unsolvable.
    state = state._replace(
        p_pot=state.p_pot.at[0].set(jnp.full_like(state.p_pot[0], -1.0))
    )
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    carry = jax.vmap(ctrl.init_carry)(keys)
    a, _ = jax.jit(jax.vmap(ctrl.act))(keys, state, obs, carry)
    a = np.asarray(a)
    sl = env._action_slices
    assert np.all(a[0, sl["P_gen"]] == 0.0)
    assert np.all(a[0, sl["P_des"]] == 0.0)
    # The healthy lane dispatches normally (some nonzero P).
    assert np.any(a[1, sl["P_gen"]] != 0.0)


def test_unconverged_iterate_is_still_applied():
    """max_iter=1 leaves the solve unconverged and outside the residual
    band, but the action must still be the iterate, not idle — only
    structural unsolvability idles (see the measured 30-step regression
    in docs/controllers.md)."""
    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    ctrl = make_vec_mpc(env, gamma=0.995, planning_steps=1, max_iter=1)
    state, obs = jax.jit(jax.vmap(env.reset))(
        jax.random.split(jax.random.PRNGKey(0), 2)
    )
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    carry = jax.vmap(ctrl.init_carry)(keys)
    a, _ = jax.jit(jax.vmap(ctrl.act))(keys, state, obs, carry)
    sl = env._action_slices
    assert np.any(np.asarray(a)[:, sl["P_gen"]] != 0.0)


def test_profile_forecast_rejects_period_mismatch():
    """Mismatched table periods must raise, not silently clamp gathers."""
    from gym_anm_tpu.vec.mpc import profile_forecast_fn

    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    with pytest.raises(ValueError, match="periods differ"):
        profile_forecast_fn(env, 4, tables_mw=(np.zeros((3, 96)),
                                               np.zeros((2, 48))))


def test_vec_mpc_generalizes_to_ieee33_renewable():
    """The DC-OPF assembly is network-generic (only the Perfect forecast is
    ANM6-specific): on the IEEE33 renewable task the vec MPC lands at the
    informed-controller reward plateau (~-0.007/step measured; random
    actions average ~-51.7 — docs/distributed.md CQL table)."""
    from gym_anm_tpu.offline_vec import evaluate_controller_vec
    from gym_anm_tpu.vec import make_ieee33_renewable_task

    env = VecEnv(make_ieee33_renewable_task(), dtype=jnp.float32)
    ctrl = make_vec_mpc(env, gamma=0.99, safety_margin=0.9, planning_steps=1)
    m = evaluate_controller_vec(env, ctrl, jax.random.PRNGKey(0), batch=3, steps=6)
    assert np.isfinite(m)
    assert m > -0.5


def test_stiff_multistage_f32_is_feasible_at_optimum(host_problem):
    """N=8 f32: BOTH residual measurements floor above the strict
    tolerances (r_prim ~1e-4, r_dual ~0.3·d_ref) while the iterate sits AT
    the HiGHS objective — the solver must report feasible=True (usable
    dispatch) even where converged stays False, and the objective must
    match.  Regression for the horizon sweep collapse (a converged-gated
    fallback discarded optimal actions and N=8 rollouts scored -1.8/step
    instead of beating N=1)."""
    agent, _, _, init_soc = host_problem(8)
    st = agent.structure
    from gym_anm_tpu.agents.mpc import MPCAgentPerfect
    from gym_anm_tpu.compat.anm6_easy import (
        _get_gen_time_series,
        _get_load_time_series,
    )
    from types import SimpleNamespace

    pa = MPCAgentPerfect.__new__(MPCAgentPerfect)
    pa.planning_steps, pa.baseMVA = 8, st.baseMVA
    fake = SimpleNamespace(state=np.array([17.0]),
                           P_loads=_get_load_time_series(),
                           P_maxs=_get_gen_time_series())
    P_load, P_gen = pa.forecast(fake)
    a_ref, obj_ref = _highs_action(st, P_load, P_gen, init_soc)

    dc = make_vec_dcopf(st, dtype=jnp.float32, max_iter=4000)
    l, u = lane_bounds(dc, jnp.asarray(P_load), jnp.asarray(P_gen),
                       jnp.asarray(init_soc))
    sol = jax.jit(lambda l, u: solve_dcopf(dc, l, u))(l, u)
    assert bool(sol.feasible)
    obj = float(st.c @ np.asarray(sol.x, dtype=np.float64))
    assert abs(obj - obj_ref) <= 1e-3 * max(1.0, abs(obj_ref))


def test_cold_warm_tuple_shapes(host_problem):
    agent, *_ = host_problem(1)
    dc = make_vec_dcopf(agent.structure, dtype=jnp.float32)
    x, y, z, Ax = init_warm(dc)
    assert x.shape == (dc.n,) and y.shape == (dc.m,)
    assert z.shape == (dc.m,) and Ax.shape == (dc.m,)


def test_n16_f32_converges_feasibly(host_problem):
    """Cold N=16 f32 — the round-3 capability cliff, now pinned FIXED.

    At the round-3 equality-row rho spread (1e3) this exact problem
    exited max_iter=40000 structurally INFEASIBLE (objective 2.7e-3
    below the LP optimum, i.e. constraint violation); the round-4
    default (rho_eq_factor=1e2) conditioning converges it feasibly in
    ~3k iterations.  Pins: converged, feasible, objective gap <= 1e-3,
    and true constraint violation <= 5e-5 measured against the raw
    f64 problem data (not the solver's own scaled residual)."""
    agent, _, _, init_soc = host_problem(16)
    st = agent.structure
    from types import SimpleNamespace

    from gym_anm_tpu.agents.mpc import MPCAgentPerfect
    from gym_anm_tpu.compat.anm6_easy import (
        _get_gen_time_series,
        _get_load_time_series,
    )

    pa = MPCAgentPerfect.__new__(MPCAgentPerfect)
    pa.planning_steps, pa.baseMVA = 16, st.baseMVA
    fake = SimpleNamespace(state=np.array([17.0]),
                           P_loads=_get_load_time_series(),
                           P_maxs=_get_gen_time_series())
    P_load, P_gen = pa.forecast(fake)
    a_ref, obj_ref = _highs_action(st, P_load, P_gen, init_soc)

    dc = make_vec_dcopf(st, dtype=jnp.float32, max_iter=40000)
    l, u = lane_bounds(dc, jnp.asarray(P_load), jnp.asarray(P_gen),
                       jnp.asarray(init_soc))
    sol = jax.jit(lambda l, u: solve_dcopf(dc, l, u))(l, u)
    assert bool(sol.converged), (int(sol.iterations), float(sol.r_prim))
    assert bool(sol.feasible)
    x = np.asarray(sol.x, dtype=np.float64)
    obj = float(st.c @ x)
    assert abs(obj - obj_ref) <= 1e-3 * max(1.0, abs(obj_ref))
    # True violation against unscaled f64 data.
    lb, ub, b_eq = st.lb.copy(), st.ub.copy(), st.b_eq.copy()
    lb[st.load_pin_idx] = P_load
    ub[st.load_pin_idx] = P_load
    ub[st.gen_cap_idx] = np.minimum(st.gen_pmax[:, None], P_gen)
    b_eq[st.soc_rows] = init_soc
    vio = max(
        float(np.max(np.abs(st.A_eq @ x - b_eq))),
        float(np.max(np.maximum(st.A_ub @ x - st.b_ub, 0.0)))
        if st.A_ub is not None else 0.0,
        float(np.max(np.maximum(lb - x, 0.0))),
        float(np.max(np.maximum(x - ub, 0.0))),
    )
    assert vio <= 5e-5, vio


def test_shift_warm_is_exact_stage_shift(host_problem):
    """make_shift_warm permutes the UNSCALED iterates by exactly one
    stage block (variables and constraint rows), duplicating the last
    stage — checked algebraically against the scale vectors, and the
    shifted Ax equals A_bar @ shifted x.  N=1 is the identity."""
    from gym_anm_tpu.vec.mpc import make_shift_warm

    N = 4
    agent, *_ = host_problem(N)
    st = agent.structure
    dc = make_vec_dcopf(st, dtype=jnp.float64)
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(dc.n))
    y = jnp.asarray(rng.randn(dc.m))
    z = jnp.asarray(rng.randn(dc.m))
    Ax = jnp.asarray(rng.randn(dc.m))
    shift = make_shift_warm(dc, st, N)
    x2, y2, z2, Ax2 = shift((x, y, z, Ax))

    stage_n = st.n_var // N
    n_eq = st.A_eq.shape[0]
    n_ub = 0 if st.A_ub is None else st.A_ub.shape[0]
    D = np.asarray(dc.D)
    E = np.asarray(dc.E)

    def src(count, ps):
        i = np.arange(count)
        return np.where(i < count - ps, i + ps, i)

    vsrc = src(dc.n, stage_n)
    rsrc = np.concatenate([src(n_eq, n_eq // N),
                           n_eq + src(n_ub, n_ub // N),
                           n_eq + n_ub + vsrc])
    # Unscaled quantities are exact permutations of the originals.
    np.testing.assert_allclose(D * np.asarray(x2), (D * np.asarray(x))[vsrc],
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(z2) / E, (np.asarray(z) / E)[rsrc],
                               rtol=1e-12)
    np.testing.assert_allclose(E * np.asarray(y2), (E * np.asarray(y))[rsrc],
                               rtol=1e-12)
    # Ax is recomputed for the shifted x, not permuted.
    np.testing.assert_allclose(np.asarray(Ax2),
                               np.asarray(dc.A_bar) @ np.asarray(x2),
                               atol=1e-12)

    # N=1: identity.
    agent1, *_ = host_problem(1)
    dc1 = make_vec_dcopf(agent1.structure, dtype=jnp.float32)
    w = init_warm(dc1)
    assert make_shift_warm(dc1, agent1.structure, 1)(w) is w


def test_rti_budget_default_quality_floor():
    """The default real-time-iteration budget (max_iter=48) must stay at
    solve-to-convergence closed-loop quality.  The budget sweep
    (scripts/exp_rti_budget.py) measured full-day reward FLAT from
    budget 16 up with a CLIFF at 8 (-0.648 vs -0.593); this pins the
    shipped default well clear of that cliff on a full profile day so a
    budget/solver change that quietly degrades the closed loop fails
    here instead of in a user's farm."""
    env = VecEnv(make_anm6easy_task(), dtype=jnp.float32)
    B, steps = 8, 96  # one full profile day

    def rollout(ctrl):
        keys = jax.random.split(jax.random.PRNGKey(0), B)
        state, obs = jax.jit(jax.vmap(env.reset))(keys)
        carry = jax.vmap(ctrl.init_carry)(keys)

        def run(state, obs, carry):
            def body(sc, t):
                st, obs, carry = sc
                k = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(7), t), B)
                a, carry = jax.vmap(ctrl.act)(k, st, obs, carry)
                st, obs, r, d, _ = env.step_autoreset_batch(st, a)
                return (st, obs, carry), r.mean()

            (_, _, _), rs = jax.lax.scan(body, (state, obs, carry), jnp.arange(steps))
            return rs

        return float(jnp.mean(jax.jit(run)(state, obs, carry)))

    kw = dict(gamma=0.995, safety_margin=0.96, planning_steps=1)
    r_default = rollout(make_vec_mpc(env, **kw))  # max_iter default (48)
    r_converged = rollout(make_vec_mpc(env, max_iter=800, **kw))
    # full-day budget sweep noise band measured at ~±0.005; 0.05 margin
    assert r_default >= r_converged - 0.05, (r_default, r_converged)
    # and the absolute level is the informed-controller plateau, not the
    # idle/random collapse regime
    assert r_default > -1.0, r_default
