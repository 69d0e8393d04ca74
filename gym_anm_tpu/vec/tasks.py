"""Vectorized task definitions (pure-JAX init_state / next_vars hooks).

Each factory returns a :class:`~gym_anm_tpu.vec.core.VecTask` describing one
of the shipped tasks.  The MDP constants and stochastic processes mirror the
compat environments; randomness comes from ``jax.random`` (the compat tier
keeps numpy-RNG bit parity with the reference — these are the
at-scale equivalents).
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..networks import (
    anm6_network,
    create_multi_capacitor_network,
    create_renewable_network,
    create_unequal_capacitor_network,
    ieee33_network,
    two_bus_network,
)
from ..specs.network import load_network
from .core import VecTask

__all__ = [
    "make_two_bus_task",
    "make_ieee33_task",
    "make_ieee33_renewable_task",
    "make_ieee33_multicap_task",
    "make_ieee33_unequal_task",
    "make_anm6easy_task",
]


def make_two_bus_task():
    """The 2-bus example env (examples/simple_env.py): random s0 in [0,1],
    random load in [-10, 0], one useless aux variable in [0, 10)."""
    spec = load_network(two_bus_network)
    K = 1
    n_s0 = spec.n_state + K
    n_vars = spec.n_load + spec.n_gen + K

    def init_state_fn(key, carry):
        return jax.random.uniform(key, (n_s0,))

    def next_vars_fn(key, s_t, carry, t):
        k1, k2 = jax.random.split(key)
        p_load = -10.0 * jax.random.uniform(k1, ())
        aux = jax.random.randint(k2, (), 0, 10).astype(s_t.dtype)
        return jnp.stack([p_load, aux]), carry

    return VecTask(
        network=two_bus_network, K=K, delta_t=0.25, gamma=0.9, lamb=100,
        costs_clipping=(1, 100), init_state_fn=init_state_fn,
        next_vars_fn=next_vars_fn, name="two_bus",
    )


def _ieee33_quirk_s0(spec, K):
    """The base IEEE33 init state: per-unit p_min written into MW slots
    (the reference quirk, ieee33.py:25-37)."""
    n_dev = spec.n_dev
    s0 = np.zeros(spec.n_state + K)
    for k in range(n_dev):
        if spec.dev_type[k] == 0:
            continue
        p = spec.p_min[k]
        qp = spec.qp_ratio[k]
        q = p * qp if not np.isnan(qp) else 0.0
        s0[int(spec.dev_ids[k])] = p
        s0[n_dev + int(spec.dev_ids[k])] = q
    return s0


def make_ieee33_task():
    """Base IEEE33 voltage control: static grid, 3-dim action
    [Q_cap8, Q_cap25, tap]."""
    spec = load_network(ieee33_network)
    K = 0
    # Kept as NUMPY: the reset path does `init_state_fn(...).astype(dtype)`
    # host-side on a numpy return, so the s0 table enters the trace as a
    # constant of the env dtype.  A jnp.asarray here would pin an f64
    # constant (global x64) that XLA hoists — unfolded — into the
    # while-loop carry of any scan-embedded step program
    # (tests/test_no_f64_hotpath.py::test_scan_embedded_step_is_f64_free).
    s0 = _ieee33_quirk_s0(spec, K)
    n_vars = spec.n_load + spec.n_gen + K

    def init_state_fn(key, carry):
        return s0

    def next_vars_fn(key, s_t, carry, t):
        return jnp.zeros(n_vars, dtype=s_t.dtype), carry

    return VecTask(
        network=ieee33_network, K=K, delta_t=1.0, gamma=0.99, lamb=100,
        costs_clipping=None, init_state_fn=init_state_fn,
        next_vars_fn=next_vars_fn, name="ieee33",
    )


def _tiered_rates(n_branch):
    """The per-reset branch-rate fix of the renewable envs
    (ieee33_renewable_complete.py:245-262) — constant across resets, so a
    static table here."""
    idx = np.arange(n_branch)
    return np.select(
        [idx < 5, idx < 15, idx < 25], [1.2, 0.5, 0.3], default=0.2
    ).astype(np.float64)


def _nominal_x_star(spec, load_factor):
    """Chord linearization point for near-nominal-load tasks: the solved
    float64 operating state at ``load_factor`` × nominal loads (renewable
    potentials at the family's quirk value of zero, caps off, nominal
    taps).  Pure-numpy host computation (physics/power_flow.numpy_nr_solve)
    — nothing touches the accelerator at task-build time.  Iteration-count tuning
    only: the flat-start Jacobian is a poor chord matrix at |V| ≈ 0.95,
    and linearizing here cuts the per-step iteration count for the whole
    family.  Falls back to the flat start if the nominal case diverges."""
    from ..physics.power_flow import numpy_nr_solve

    N = spec.n_bus
    # Nominal-tap complex Y-bus (numpy mirror of physics/ybus.build_ybus).
    series = 1.0 / (spec.br_r + 1j * spec.br_x)
    tap = spec.br_tap0 * np.exp(1j * spec.br_shift)
    sh = 1j * spec.br_b / 2.0
    Y = np.zeros((N, N), complex)
    for k in range(spec.n_branch):
        fb, tb = int(spec.br_f[k]), int(spec.br_t[k])
        Y[fb, tb] += -series[k] / np.conj(tap[k])
        Y[tb, fb] += -series[k] / tap[k]
        Y[fb, fb] += (series[k] + sh[k]) / np.abs(tap[k]) ** 2
        Y[tb, tb] += series[k] + sh[k]

    p_bus = np.zeros(N)
    q_bus = np.zeros(N)
    for i, d in enumerate(spec.load_pos):
        bus = int(spec.dev_bus[d])
        p = spec.p_min[d] * load_factor          # p.u., negative
        p_bus[bus] += p
        q_bus[bus] += p * spec.qp_ratio[d]
    return numpy_nr_solve(Y, p_bus[1:], q_bus[1:])


def _make_renewable_family_task(network, name, load_scale=1.0, scenario="default"):
    spec = load_network(network)
    K = 0
    n_s0 = spec.n_state + K
    n_vars = spec.n_load + spec.n_gen + K
    nominal_mw = jnp.asarray(np.abs(spec.p_min[spec.load_pos]) * spec.baseMVA)
    delta_t = 1.0
    # Diurnal load factor averages 0.8 (0.8 + 0.3·sin); linearize the chord
    # solver at that operating point.
    x_star = _nominal_x_star(spec, 0.8 * load_scale)

    scen_solar, scen_wind = {"high_renewable": (1.2, 1.2),
                             "low_renewable": (0.5, 0.5)}.get(scenario, (1.0, 1.0))

    def init_task_fn(key):
        # task carry = hour of day.  Drawn at f32: under the global x64
        # flag an unannotated scalar draw is f64, and the f64 carry drags
        # its whole downstream chain (clock advance, diurnal sine, the
        # reset-retry loop) into f64 ops — the same trap as the load
        # noise below.  A f32 hour is
        # exact to ~1e-7 relative, far below the 2%-noise process it
        # modulates; weak-typed Python-float arithmetic below stays f32.
        return jax.random.uniform(key, (), dtype=jnp.float32) * 24.0

    def init_state_fn(key, carry):
        # f32 draw for the same x64 reason as the load noise below; the
        # reset path casts to the env dtype afterwards.
        return jax.random.normal(key, (n_s0,), dtype=jnp.float32) * 0.001

    def next_vars_fn(key, s_t, hour, t):
        # The reference advances the clock by delta_t/3600 h per step before
        # sampling; renewable potentials stay at ZERO (the quirk the
        # controller hierarchy was tuned against).
        hour = (hour + delta_t / 3600.0) % 24.0
        time_factor = (0.8 + 0.3 * jnp.sin((hour - 3.0) * jnp.pi / 12.0)).astype(s_t.dtype)
        # Draw the noise AT the state dtype.  Under the package's global
        # jax_enable_x64, an unannotated normal() is float64, which puts
        # f64 erf_inv/threefry work on the f32 hot path
        # (tests/test_no_f64_hotpath.py guards it).
        noise = 1.0 + 0.02 * jax.random.normal(key, nominal_mw.shape, dtype=s_t.dtype)
        loads = -nominal_mw.astype(s_t.dtype) * (load_scale * time_factor * noise)
        zeros_tail = jnp.zeros(n_vars - spec.n_load, dtype=s_t.dtype)
        return jnp.concatenate([loads, zeros_tail]), hour

    return VecTask(
        network=network, K=K, delta_t=delta_t, gamma=0.99, lamb=100,
        costs_clipping=None, init_state_fn=init_state_fn,
        next_vars_fn=next_vars_fn, init_task_fn=init_task_fn,
        rates=_tiered_rates(spec.n_branch), chord_x_star=x_star, name=name,
    )


def make_ieee33_renewable_task(load_scale=1.0, scenario="default"):
    """IEEE33 + 5 renewables, 13-dim actions, diurnal loads."""
    return _make_renewable_family_task(
        create_renewable_network(), "ieee33_renewable", load_scale, scenario
    )


def make_ieee33_multicap_task(load_scale=1.0, scenario="default"):
    """IEEE33 + renewables + 6 capacitors, 17-dim actions."""
    return _make_renewable_family_task(
        create_multi_capacitor_network(), "ieee33_multicap", load_scale, scenario
    )


def make_ieee33_unequal_task(load_scale=1.0, scenario="default",
                             switching_cost_multiplier=1.0):
    """IEEE33 + renewables + 6 unequal capacitors, 17-dim actions, with the
    per-step capacitor switching-cost accounting of the compat env
    (ieee33_unequal_capacitors.py:144-169) as a reward-shaping hook.

    Semantics mirrored exactly, including the reference's pairing quirk:
    the per-capacitor base costs are sorted by rating LARGEST-FIRST while
    the switch detections are in action order, and the two are multiplied
    index-wise (reference ieee33_unequal_capacitors.py:118-125,146-149).
    The previous-set-point tracker persists across resets, like the
    reference's (initialized in __init__, never cleared)."""
    import dataclasses

    task = _make_renewable_family_task(
        create_unequal_capacitor_network(), "ieee33_unequal", load_scale, scenario
    )
    spec = load_network(task.network)
    ratings = np.sort(spec.q_max[spec.cap_pos] * spec.baseMVA)[::-1]
    base_costs = 0.01 * ratings * switching_cost_multiplier
    n_cap = spec.n_cap
    cap_lo = 2 * spec.n_gen + 2 * spec.n_des  # caps in [P_gen,Q_gen,P_des,Q_des,Q_cap,tap]

    def init_shape_fn(dtype):
        return (
            jnp.zeros(n_cap, dtype),        # previous cap set-points (MVAr)
            jnp.zeros((), jnp.int32),       # total switches
            jnp.zeros((), dtype),           # cumulative switching cost
        )

    def shape_reward_fn(carry, action, reward):
        prev, n_switches, cum_cost = carry
        cap_a = action[cap_lo : cap_lo + n_cap].astype(prev.dtype)
        switches = jnp.abs(cap_a - prev) > 0.01
        costs = jnp.asarray(base_costs, reward.dtype)
        step_cost = jnp.sum(jnp.where(switches, costs, 0.0))
        n_switches = n_switches + switches.sum().astype(jnp.int32)
        cum_cost = cum_cost + step_cost.astype(cum_cost.dtype)
        extras = {
            "switching_cost": step_cost,
            "total_switches": n_switches,
            "cumulative_switching_cost": cum_cost,
        }
        return (cap_a, n_switches, cum_cost), reward - step_cost, extras

    return dataclasses.replace(
        task, shape_reward_fn=shape_reward_fn, init_shape_fn=init_shape_fn
    )


def make_anm6easy_task():
    """The ANM6Easy task: fixed 96-step daily profiles, K=1 time-of-day aux,
    Δt = 15 min (anm6_easy.py:11-65)."""
    from ..networks.anm6 import _get_gen_time_series, _get_load_time_series

    spec = load_network(anm6_network)
    K = 1
    # Host-side numpy: the tables must materialize as constants of the
    # TRACE dtype.  A jnp.asarray here would pin them as f64 constants
    # under the global x64 flag, and XLA then keeps the f64 tables +
    # runtime f64→f32 converts alive inside the autoreset while-body
    # carry (seen in the bench MPC scan HLO) instead of folding the cast.
    P_loads = np.asarray(_get_load_time_series())  # [3, 96]
    P_maxs = np.asarray(_get_gen_time_series())    # [2, 96]
    n_steps_day = 96
    n_dev, n_des, n_gen = spec.n_dev, spec.n_des, spec.n_gen

    f32 = jnp.float32
    q_min_gen = jnp.asarray(spec.q_min[spec.gen_nonslack_pos] * spec.baseMVA, f32)
    q_max_gen = jnp.asarray(spec.q_max[spec.gen_nonslack_pos] * spec.baseMVA, f32)
    soc_min = jnp.asarray(spec.soc_min[spec.des_pos] * spec.baseMVA, f32)
    soc_max = jnp.asarray(spec.soc_max[spec.des_pos] * spec.baseMVA, f32)

    def init_state_fn(key, carry):
        # Built in f32 (the reset branch is hot for ANM6 farms — lanes
        # genuinely collapse under aggressive actions — and batched f64
        # would put f64 work on it); the reset path casts to the env dtype
        # after.
        k_t, k_q, k_soc = jax.random.split(key, 3)
        t0 = jax.random.randint(k_t, (), 0, n_steps_day)
        s = jnp.zeros(2 * n_dev + n_des + n_gen + K, f32)
        # loads at devices 1,3,5; gens at 2,4; DES at 6 (ANM6 layout)
        loads = jnp.asarray(P_loads, f32)[:, t0]
        s = s.at[jnp.array([1, 3, 5])].set(loads)
        s = s.at[jnp.array([1 + n_dev, 3 + n_dev, 5 + n_dev])].set(loads * 0.2)
        gens = jnp.asarray(P_maxs, f32)[:, t0]
        s = s.at[jnp.array([2, 4])].set(gens)
        q = q_min_gen + jax.random.uniform(k_q, (n_gen,), f32) * (q_max_gen - q_min_gen)
        s = s.at[jnp.array([2 + n_dev, 4 + n_dev])].set(q)
        soc = soc_min + jax.random.uniform(k_soc, (n_des,), f32) * (soc_max - soc_min)
        s = s.at[2 * n_dev : 2 * n_dev + n_des].set(soc)
        s = s.at[2 * n_dev + n_des : 2 * n_dev + n_des + n_gen].set(gens)
        s = s.at[-1].set(t0.astype(s.dtype))
        return s

    def next_vars_fn(key, s_t, carry, t):
        aux = jnp.mod(s_t[-1] + 1, n_steps_day).astype(jnp.int32)
        # Materialize the numpy tables AT the state dtype: the constants
        # enter the program already f32 on the f32 tier, so no f64 tables
        # or batched f64 gathers reach the hot step (see
        # the renewable family's noise draw for the same x64 trap).
        loads_t = jnp.asarray(P_loads, s_t.dtype)
        maxs_t = jnp.asarray(P_maxs, s_t.dtype)
        vars = jnp.concatenate(
            [loads_t[:, aux], maxs_t[:, aux], aux[None].astype(s_t.dtype)]
        )
        return vars, carry

    return VecTask(
        network=anm6_network, K=K, delta_t=0.25, gamma=0.995, lamb=100,
        costs_clipping=(1, 100), init_state_fn=init_state_fn,
        next_vars_fn=next_vars_fn, name="anm6easy",
    )
