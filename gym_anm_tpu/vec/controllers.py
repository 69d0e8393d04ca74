"""Vectorized L0-L5 controllers: pure functions for on-device rollouts.

The at-scale counterparts of :mod:`gym_anm_tpu.agents.ieee33_controllers`:
each controller is an ``(init_carry, act)`` pair where

    init_carry(key) -> carry pytree
    act(key, env_state, obs, carry) -> (action, carry')

so whole controller-driven rollouts (and offline-dataset generation) run
under ``jax.lax.scan``/``jax.vmap``/``shard_map`` with no host round-trips.
Decision rules mirror the host classes (same thresholds, lockout timers and
the hand-fitted linear voltage model of the L5 search), expressed with
``jnp.where``/``lax`` so they compile; the L5 exhaustive search is evaluated
as one fused argmin over the static 135-point configuration grid.

The controllers target the 13-dim renewable IEEE33 action layout
[5 renewable P, 5 renewable Q, 2 cap Q, 1 tap]; ``n_action`` padding makes
them usable on the 17-dim variants (extra capacitors left at 0).
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

TAP_POSITIONS = np.array([0.9, 0.95, 1.0, 1.05, 1.1])


class Controller(NamedTuple):
    name: str
    init_carry: Callable
    act: Callable


def _blank(env, dtype):
    return jnp.zeros(env.n_action, dtype=dtype)


def _gen_q_slice(env):
    n_gen = env.spec.n_gen
    return slice(n_gen, 2 * n_gen)


def _renewable_action(env, state, fraction):
    """action[0:n_gen] = p_pot · fraction (p.u., like the host classes)."""
    return state.p_pot * fraction


def make_l0(env):
    """L0: uniform random actions."""
    lo, hi = env.action_low, env.action_high

    def init_carry(key):
        return ()

    def act(key, state, obs, carry):
        u = jax.random.uniform(key, (env.n_action,), dtype=env.dtype)
        return lo + u * (hi - lo), carry

    return Controller("L0_random", init_carry, act)


def make_l1(env):
    """L1: 20% renewables, caps off, nominal tap."""
    cap_sl = env._action_slices["Q_cap"]
    tap_sl = env._action_slices["tap"]

    def init_carry(key):
        return ()

    def act(key, state, obs, carry):
        a = _blank(env, env.dtype)
        a = a.at[: env.spec.n_gen].set(_renewable_action(env, state, 0.2))
        a = a.at[tap_sl].set(1.0)
        return a, carry

    return Controller("L1_basic", init_carry, act)


def _tap_from_idx(idx, dtype=None):
    taps = jnp.asarray(TAP_POSITIONS, dtype) if dtype is not None else jnp.asarray(TAP_POSITIONS)
    return taps[idx]


def _wf(pred, a, b, dt):
    """``jnp.where`` with float-literal branches pinned AT ``dt``: under
    the global x64 flag a where() of two weak Python floats selects in
    f64 (guarded by tests/test_no_f64_hotpath.py)."""
    return jnp.where(pred, jnp.asarray(a, dt), jnp.asarray(b, dt))


def make_l2(env):
    """L2: voltage-threshold switching with per-capacitor hysteresis."""
    cap_sl = env._action_slices["Q_cap"]
    tap_sl = env._action_slices["tap"]
    n_gen = env.spec.n_gen
    cap_on = 0.2

    def init_carry(key):
        return jnp.zeros(2, dtype=bool)  # [cap1_on, cap2_on]

    def act(key, state, obs, carry):
        v_min = jnp.min(state.bus_vm)
        v_max = jnp.max(state.bus_vm)

        dt = env.dtype
        frac = _wf(v_max > 1.04, 0.15, _wf(v_min < 0.96, 0.25, 0.22, dt), dt)
        a = _blank(env, env.dtype)
        a = a.at[:n_gen].set(_renewable_action(env, state, frac))

        q_support = _wf(v_min < 0.97, 0.01, _wf(v_max > 1.03, -0.01, 0.0, dt), dt)
        a = a.at[_gen_q_slice(env)].set(q_support)

        on1, on2 = carry[0], carry[1]
        new_on1 = jnp.where(
            on1,
            jnp.logical_not(jnp.logical_or(v_min > 0.98, v_max > 1.04)),
            jnp.logical_and(v_min < 0.96, v_max < 1.02),
        )
        new_on2 = jnp.where(
            on2,
            jnp.logical_not(jnp.logical_or(v_min > 0.975, v_max > 1.03)),
            jnp.logical_and(v_min < 0.955, v_max < 1.01),
        )
        cap_vals = jnp.zeros(cap_sl.stop - cap_sl.start, env.dtype)
        cap_vals = cap_vals.at[0].set(_wf(new_on1, cap_on, 0.0, dt))
        cap_vals = cap_vals.at[1].set(_wf(new_on2, cap_on * 0.5, 0.0, dt))
        a = a.at[cap_sl].set(cap_vals)

        caps_active = jnp.logical_or(new_on1, new_on2)
        tap_idx_active = jnp.where(v_min < 0.94, 1, jnp.where(v_max > 1.06, 3, 2))
        tap_idx_idle = jnp.where(
            v_min < 0.93, 0,
            jnp.where(v_min < 0.96, 1,
                      jnp.where(v_max > 1.07, 4, jnp.where(v_max > 1.04, 3, 2))),
        )
        tap_idx = jnp.where(caps_active, tap_idx_active, tap_idx_idle)
        a = a.at[tap_sl].set(_tap_from_idx(tap_idx, env.dtype))

        return a, jnp.stack([new_on1, new_on2])

    return Controller("L2_threshold", init_carry, act)


class _L3Carry(NamedTuple):
    cap_state: jax.Array   # [2] bool
    last_tap_idx: jax.Array
    timer: jax.Array


def make_l3(env):
    """L3: coordinated control with 5/10-step lockout timers."""
    cap_sl = env._action_slices["Q_cap"]
    tap_sl = env._action_slices["tap"]
    n_gen = env.spec.n_gen
    cap_on = 0.15
    gen_bus = env.spec.dev_bus[env.spec.gen_nonslack_pos]
    q_limits = jnp.asarray(np.resize(np.array([0.02, 0.02, 0.02, 0.04, 0.04]), n_gen), env.dtype)

    def init_carry(key):
        return _L3Carry(jnp.zeros(2, bool), jnp.asarray(2, jnp.int32), jnp.asarray(0, jnp.int32))

    def act(key, state, obs, carry):
        vm = state.bus_vm
        v_min, v_max, v_mean = jnp.min(vm), jnp.max(vm), jnp.mean(vm)

        # Explicit dtype on where-of-weak-scalars (see make_l4: under x64
        # these resolve to f64 and promote the action math).
        dt = env.dtype
        margin = jnp.minimum(v_min - 0.95, 1.05 - v_max)
        base = jnp.where(margin < 0.01, jnp.asarray(0.15, dt),
                         jnp.where(margin < 0.02, jnp.asarray(0.20, dt),
                                   jnp.asarray(0.24, dt)))

        v_local = vm[gen_bus]
        local = jnp.where(v_local > 1.035, jnp.asarray(0.7, dt),
                          jnp.where(v_local < 0.965, jnp.asarray(1.2, dt),
                                    jnp.asarray(1.0, dt)))
        a = _blank(env, env.dtype)
        ren = jnp.minimum(state.p_pot * base * local, state.p_pot)
        a = a.at[:n_gen].set(ren)

        q = jnp.where(v_local < 0.97, q_limits * 0.5,
                      jnp.where(v_local > 1.03, -q_limits * 0.5, 0.0))
        a = a.at[_gen_q_slice(env)].set(q.astype(env.dtype))

        timer = jnp.maximum(carry.timer - 1, 0)
        free = timer == 0

        want_both = jnp.logical_and(v_min < 0.95, v_max < 1.01)
        want_one = jnp.logical_and(v_min < 0.96, v_max < 1.02)
        want_off = jnp.logical_or(v_max > 1.04, jnp.logical_and(v_max > 1.03, v_mean > 1.01))
        desired = jnp.where(
            want_both, jnp.array([True, True]),
            jnp.where(want_one, jnp.array([True, False]),
                      jnp.where(want_off, jnp.array([False, False]), carry.cap_state)),
        )
        changed = jnp.any(desired != carry.cap_state)
        cap_state = jnp.where(jnp.logical_and(free, changed), desired, carry.cap_state)
        timer = jnp.where(jnp.logical_and(free, changed), 5, timer)

        cap_vals = jnp.zeros(cap_sl.stop - cap_sl.start, env.dtype)
        cap_vals = cap_vals.at[0].set(_wf(cap_state[0], cap_on, 0.0, dt))
        cap_vals = cap_vals.at[1].set(_wf(cap_state[1], cap_on * 0.5, 0.0, dt))
        a = a.at[cap_sl].set(cap_vals)

        any_cap = jnp.any(cap_state)
        desired_tap = jnp.where(
            v_min < 0.94, 0,
            jnp.where(jnp.logical_and(v_min < 0.95, ~any_cap), 1,
                      jnp.where(v_max > 1.06, 4,
                                jnp.where(jnp.logical_and(v_max > 1.05, ~any_cap), 3, 2))),
        )
        free2 = timer == 0
        tap_changed = desired_tap != carry.last_tap_idx
        last_tap = jnp.where(jnp.logical_and(free2, tap_changed), desired_tap, carry.last_tap_idx)
        timer = jnp.where(jnp.logical_and(free2, tap_changed), 10, timer)

        a = a.at[tap_sl].set(_tap_from_idx(last_tap, env.dtype))
        return a, _L3Carry(cap_state, last_tap, timer)

    return Controller("L3_coordinated", init_carry, act)


class _L4Carry(NamedTuple):
    prev_mean: jax.Array
    have_prev: jax.Array
    last_caps: jax.Array      # [2]
    last_tap_idx: jax.Array
    cap_timers: jax.Array     # [2]
    tap_timer: jax.Array


def make_l4(env):
    """L4: trend-predictive control with switching-rate limits."""
    cap_sl = env._action_slices["Q_cap"]
    tap_sl = env._action_slices["tap"]
    n_gen = env.spec.n_gen
    cap_on = 0.4
    gen_bus = env.spec.dev_bus[env.spec.gen_nonslack_pos]
    q_limits = jnp.asarray(np.resize(np.array([0.02, 0.02, 0.02, 0.04, 0.04]), n_gen), env.dtype)

    def init_carry(key):
        return _L4Carry(
            jnp.zeros((), env.dtype), jnp.zeros((), bool),
            jnp.zeros(2, env.dtype), jnp.asarray(2, jnp.int32),
            jnp.zeros(2, jnp.int32), jnp.asarray(0, jnp.int32),
        )

    def act(key, state, obs, carry):
        vm = state.bus_vm
        v_min, v_max, v_mean = jnp.min(vm), jnp.max(vm), jnp.mean(vm)
        trend = jnp.where(carry.have_prev, v_mean - carry.prev_mean, 0.0)

        # Explicit dtype on the where-of-scalars: under global x64 a
        # where(pred, 0.6, 1.0) of weak python floats resolves to float64
        # and promotes the downstream action math to f64.
        dt = env.dtype
        base = jnp.where(
            jnp.logical_and(trend > 0.005, v_max > 1.02), jnp.asarray(0.16, dt),
            jnp.where(jnp.logical_and(trend < -0.005, v_min < 0.98),
                      jnp.asarray(0.24, dt), jnp.asarray(0.20, dt)),
        )
        v_local = vm[gen_bus]
        v_pred = v_local + trend * 3
        local = jnp.where(v_pred > 1.04, jnp.asarray(0.6, dt),
                          jnp.where(v_pred < 0.96, jnp.asarray(1.3, dt),
                                    jnp.asarray(1.0, dt)))
        a = _blank(env, env.dtype)
        a = a.at[:n_gen].set(jnp.minimum(state.p_pot * base * local, state.p_pot))

        q = jnp.where(jnp.logical_or(v_pred < 0.96, v_local < 0.965), q_limits * 0.6,
                      jnp.where(jnp.logical_or(v_pred > 1.04, v_local > 1.035),
                                -q_limits * 0.6, 0.0))
        a = a.at[_gen_q_slice(env)].set(q.astype(env.dtype))

        cap_timers = jnp.maximum(carry.cap_timers - 1, 0)
        thresholds_on = jnp.array([0.96, 0.955], dt)
        thresholds_off = jnp.array([0.975, 0.97], dt)
        is_off = carry.last_caps == 0.0
        turn_on = jnp.logical_and(v_min < thresholds_on, is_off)
        turn_off = jnp.logical_and(v_min > thresholds_off, ~is_off)
        can_act = cap_timers == 0
        new_caps = jnp.where(
            jnp.logical_and(can_act, turn_on), cap_on,
            jnp.where(jnp.logical_and(can_act, turn_off), 0.0, carry.last_caps),
        )
        cap_timers = jnp.where(
            jnp.logical_and(can_act, jnp.logical_or(turn_on, turn_off)), 5, cap_timers
        )
        cap_vals = jnp.zeros(cap_sl.stop - cap_sl.start, env.dtype).at[:2].set(new_caps)
        a = a.at[cap_sl].set(cap_vals)

        tap_timer = jnp.maximum(carry.tap_timer - 1, 0)
        desired = jnp.where(
            jnp.logical_or(v_min < 0.94, jnp.logical_and(v_min < 0.95, trend < -0.01)), 0,
            jnp.where(v_min < 0.96, 1,
                      jnp.where(jnp.logical_or(v_max > 1.06,
                                               jnp.logical_and(v_max > 1.05, trend > 0.01)), 4,
                                jnp.where(v_max > 1.04, 3, 2))),
        )
        significant = jnp.logical_or(
            jnp.abs(desired - carry.last_tap_idx) > 1,
            jnp.logical_or(v_min < 0.93, v_max > 1.07),
        )
        do_change = jnp.logical_and(tap_timer == 0, significant)
        last_tap = jnp.where(do_change, desired, carry.last_tap_idx)
        tap_timer = jnp.where(do_change, 10, tap_timer)
        a = a.at[tap_sl].set(_tap_from_idx(last_tap, env.dtype))

        return a, _L4Carry(v_mean, jnp.ones((), bool), new_caps, last_tap, cap_timers, tap_timer)

    return Controller("L4_predictive", init_carry, act)


class _L5Carry(NamedTuple):
    last_cap1: jax.Array
    last_cap2: jax.Array
    last_tap_idx: jax.Array


def _l5_grid():
    """The static 135-point configuration grid of the L5 search."""
    rens = [0.15, 0.20, 0.25]
    caps = [0.0, 0.2, 0.3]
    cfgs = []
    for ren in rens:
        for c1 in caps:
            for c2 in caps:
                if c1 + c2 > 0.5:
                    continue
                for ti in range(5):
                    cfgs.append((ren, c1, c2, ti))
    return np.array(cfgs)  # [M, 4]


def make_l5(env):
    """L5: fused argmin over the discrete configuration grid against the
    hand-fitted linear voltage model (discrete_hierarchy.py:407-593)."""
    cap_sl = env._action_slices["Q_cap"]
    tap_sl = env._action_slices["tap"]
    n_gen = env.spec.n_gen
    # Cast to the env dtype: under global x64 these would otherwise be
    # strong f64 constants that promote the whole search (and the action
    # scatters) to float64 — a FutureWarning today, and f64 work on the
    # f32 hot path.
    grid = jnp.asarray(_l5_grid(), env.dtype)   # [M, 4]
    grid_tap = jnp.asarray(TAP_POSITIONS, env.dtype)[grid[:, 3].astype(jnp.int32)]

    def init_carry(key):
        return _L5Carry(jnp.zeros((), env.dtype), jnp.zeros((), env.dtype),
                        jnp.asarray(2, jnp.int32))

    def act(key, state, obs, carry):
        vm = state.bus_vm
        v_min, v_max = jnp.min(vm), jnp.max(vm)

        dt = env.dtype
        nominal = jnp.logical_and(v_min > 0.99, v_max < 1.01)
        base_min = _wf(nominal, -0.046, 0.0, dt)

        ren, c1, c2 = grid[:, 0], grid[:, 1], grid[:, 2]
        tap = grid_tap
        cap_boost = (c1 + c2) * 0.005
        oltc = jnp.where(
            tap < 1.0,
            jnp.where(tap <= 0.95, 0.046, (1.0 - tap) * 0.92),
            jnp.where(tap >= 1.05, -0.050, (1.0 - tap) * 1.0),
        )
        pv_min = jnp.clip(v_min + base_min + cap_boost + oltc, 0.85, 1.15)
        pv_max = jnp.clip(v_max + cap_boost * 0.9 + oltc * 0.95, pv_min, 1.15)

        # The switching-penalty terms are bool arrays scaled by python
        # floats — under global x64 that promotes to float64 (bools carry
        # no float dtype, so the WEAK scalar resolves to the f64 default)
        # and drags the whole cost/argmin to f64.  Cast
        # the bools to the env dtype first.
        cost = (
            100.0 * jnp.maximum(0.95 - pv_min, 0.0) ** 2
            + 100.0 * jnp.maximum(pv_max - 1.05, 0.0) ** 2
            + 1.0 * jnp.maximum(0.96 - pv_min, 0.0) ** 2
            + 1.0 * jnp.maximum(pv_max - 1.04, 0.0) ** 2
            + 0.05 * ((pv_min + pv_max) / 2 - 1.0) ** 2
            + 0.001 * (c1 != carry.last_cap1).astype(dt)
            + 0.001 * (c2 != carry.last_cap2).astype(dt)
            + 0.005 * (grid[:, 3].astype(jnp.int32) != carry.last_tap_idx).astype(dt)
            + 0.01 * (c1 + c2)
            + 0.001 * jnp.abs(ren - 0.2)
        )
        best = jnp.argmin(cost)
        b_ren, b_c1, b_c2 = ren[best], c1[best], c2[best]
        b_tap_idx = grid[best, 3].astype(jnp.int32)

        a = _blank(env, env.dtype)
        a = a.at[:n_gen].set(jnp.where(state.p_pot > 0, state.p_pot * b_ren, 0.0))
        q_emerg = _wf(v_min < 0.94, 0.01, _wf(v_max > 1.06, -0.01, 0.0, dt), dt)
        a = a.at[_gen_q_slice(env)].set(q_emerg)
        cap_vals = jnp.zeros(cap_sl.stop - cap_sl.start, env.dtype)
        cap_vals = cap_vals.at[0].set(b_c1).at[1].set(b_c2)
        a = a.at[cap_sl].set(cap_vals)
        a = a.at[tap_sl].set(_tap_from_idx(b_tap_idx, env.dtype))

        return a, _L5Carry(b_c1.astype(env.dtype), b_c2.astype(env.dtype), b_tap_idx)

    return Controller("L5_optimal", init_carry, act)


def make_suite(env):
    """The full L0-L5 suite for an environment."""
    return [make_l0(env), make_l1(env), make_l2(env), make_l3(env), make_l4(env), make_l5(env)]
