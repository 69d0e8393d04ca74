"""Vectorized heuristic experts: the on-device counterpart of the expert
zoo (:mod:`gym_anm_tpu.offline`, equivalent of ``gym_anm/offline.py:106-694``).

Same decision rules and thresholds as the host classes, expressed as pure
:class:`~gym_anm_tpu.vec.controllers.Controller` pairs so mixed expert
datasets generate entirely on-device via
:func:`gym_anm_tpu.offline_vec.generate_mixed_dataset_vec` — thousands of
lanes, one jitted scan, no per-step host round trips.

Covered families (the zoo's behaviorally distinct members; the host tier
keeps the full ~25-class surface):

* capacitor banks: threshold (simple/conservative/aggressive), hysteresis;
* OLTC: threshold variants, deadband;
* renewables: threshold curtailment variants, proportional;
* combined, do-nothing, random (= ``controllers.make_l0``).

Actions follow the env layout [P_gen, Q_gen, P_des, Q_des, Q_cap, tap] in
the reference's MW/MVAr/ratio units.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .controllers import Controller


class _Spec:
    """Static per-env indices/bounds the experts need (baked at trace time)."""

    def __init__(self, env):
        spec, tb = env.spec, env.tables
        self.base = float(spec.baseMVA)
        sl = env._action_slices
        self.sl_pgen, self.sl_qcap, self.sl_tap = sl["P_gen"], sl["Q_cap"], sl["tap"]
        npdt = np.dtype(env.dtype)
        # generators (non-slack): bus position + renewable mask.  Bound
        # tables are stored AT the env dtype: f64 numpy constants mixed
        # into f32 lane math promote the whole expression to
        # float64 under the package's global x64.
        gp = spec.gen_nonslack_pos
        self.gen_bus = np.asarray(spec.dev_bus[gp])
        self.gen_is_rer = np.isin(gp, spec.rer_pos)
        self.gen_p_min = np.asarray(spec.p_min[gp], npdt)
        # capacitors: bus position + Q bounds (MVAr)
        cp = spec.cap_pos
        self.cap_bus = np.asarray(spec.dev_bus[cp])
        self.cap_q_max = np.asarray(spec.q_max[cp] * self.base, npdt)
        self.cap_q_min = np.asarray(spec.q_min[cp] * self.base, npdt)
        # OLTC: regulated (to-) bus position + tap bounds
        ob = np.asarray(tb.oltc_branch)
        self.oltc_t_bus = np.asarray(spec.br_t)[ob] if len(ob) else np.zeros(0, int)
        self.tap_min = np.asarray(tb.oltc_tap_min)
        self.tap_max = np.asarray(tb.oltc_tap_max)
        self.n_action = env.n_action
        self.dtype = env.dtype


def _base_action(s: _Spec, state):
    """BaseHeuristic.get_base_action: gens at p_pot·baseMVA MW, DES idle,
    caps 0, taps 1.0 (offline.py:132-139)."""
    a = jnp.zeros(s.n_action, dtype=s.dtype)
    a = a.at[s.sl_pgen].set(state.p_pot * s.base)
    if s.sl_tap.stop > s.sl_tap.start:
        a = a.at[s.sl_tap].set(1.0)
    return a


def _stateless(name, fn):
    return Controller(name=name, init_carry=lambda key: (),
                      act=lambda key, state, obs, carry: (fn(state), carry))


def _cap_q_threshold(s, state, v_min, v_max):
    v = state.bus_vm[s.cap_bus]
    return jnp.where(v < v_min, s.cap_q_max, jnp.where(v > v_max, s.cap_q_min, 0.0))


def make_cap_bank_expert(env, v_min=0.99, v_max=1.01, name="cap_bank"):
    """Per-capacitor local-voltage threshold switching
    (CapBankHeuristic, offline.py:145-161); default thresholds = Simple,
    pass 0.98/1.02 for Conservative, 0.995/1.005 for Aggressive."""
    s = _Spec(env)

    def fn(state):
        a = _base_action(s, state)
        return a.at[s.sl_qcap].set(_cap_q_threshold(s, state, v_min, v_max).astype(s.dtype))

    return _stateless(name, fn)


def make_hysteresis_cap_expert(env, v_on=0.985, v_off=1.015):
    """State changes only when the local voltage exits the wider band
    (HysteresisCapBankHeuristic, offline.py:236-258)."""
    s = _Spec(env)
    n_cap = len(s.cap_bus)

    def init_carry(key):
        return jnp.zeros(n_cap, dtype=s.dtype)

    def act(key, state, obs, carry):
        v = state.bus_vm[s.cap_bus]
        q = jnp.where(v < v_on, s.cap_q_max.astype(s.dtype),
                      jnp.where(v > v_off, s.cap_q_min.astype(s.dtype), carry))
        a = _base_action(s, state).at[s.sl_qcap].set(q)
        return a, q

    return Controller(name="cap_hysteresis", init_carry=init_carry, act=act)


def make_oltc_expert(env, v_min=0.99, v_max=1.01, deadband=0.0, name="oltc"):
    """Tap to max under low regulated-bus voltage, to min under high,
    otherwise hold the current tap (OLTCHeuristic/DeadbandOLTCHeuristic,
    offline.py:261-278,354-374)."""
    s = _Spec(env)

    def init_carry(key):
        return ()

    def act(key, state, obs, carry):
        v = state.bus_vm[s.oltc_t_bus]
        tap = jnp.where(v < v_min - deadband, s.tap_max,
                        jnp.where(v > v_max + deadband, s.tap_min, state.oltc_tap))
        a = _base_action(s, state).at[s.sl_tap].set(tap.astype(s.dtype))
        return a, carry

    return Controller(name=name, init_carry=init_carry, act=act)


def _ren_p(s, state, v_max, proportional):
    v = state.bus_vm[s.gen_bus]
    if proportional:
        curtail = jnp.clip((v - v_max) / 0.02, 0.0, 1.0)
        p = jnp.maximum(s.gen_p_min, state.p_pot * (1 - 0.5 * curtail))
        p = jnp.where(v > v_max, p, state.p_pot)
    else:
        p = jnp.where(v > v_max, jnp.maximum(s.gen_p_min, 0.9 * state.p_pot),
                      state.p_pot)
    return jnp.where(s.gen_is_rer, p, state.p_pot) * s.base


def make_renewable_expert(env, v_min=0.99, v_max=1.01, proportional=False,
                          name="renewable"):
    """Local-overvoltage curtailment (RenewableGenHeuristic /
    ProportionalRenewableHeuristic, offline.py:377-424)."""
    s = _Spec(env)

    def fn(state):
        a = _base_action(s, state)
        return a.at[s.sl_pgen].set(_ren_p(s, state, v_max, proportional).astype(s.dtype))

    return _stateless(name, fn)


def make_combined_expert(env, v_min=0.99, v_max=1.01):
    """Renewable curtailment + cap switching + OLTC together
    (CombinedHeuristic, offline.py:489-512)."""
    s = _Spec(env)

    def init_carry(key):
        return ()

    def act(key, state, obs, carry):
        a = _base_action(s, state)
        a = a.at[s.sl_pgen].set(_ren_p(s, state, v_max, False).astype(s.dtype))
        a = a.at[s.sl_qcap].set(_cap_q_threshold(s, state, v_min, v_max).astype(s.dtype))
        v = state.bus_vm[s.oltc_t_bus]
        tap = jnp.where(v < v_min, s.tap_max, jnp.where(v > v_max, s.tap_min, state.oltc_tap))
        a = a.at[s.sl_tap].set(tap.astype(s.dtype))
        return a, carry

    return Controller(name="combined", init_carry=init_carry, act=act)


def make_do_nothing_expert(env):
    """The base action only (DoNothingHeuristic, offline.py:519-521)."""
    s = _Spec(env)
    return _stateless("do_nothing", lambda state: _base_action(s, state))


def make_expert_zoo(env):
    """A diverse on-device expert set for mixed-dataset generation."""
    return [
        make_cap_bank_expert(env),                                  # simple
        make_cap_bank_expert(env, 0.98, 1.02, name="cap_conservative"),
        make_cap_bank_expert(env, 0.995, 1.005, name="cap_aggressive"),
        make_hysteresis_cap_expert(env),
        make_oltc_expert(env),
        make_oltc_expert(env, deadband=0.005, name="oltc_deadband"),
        make_renewable_expert(env),
        make_renewable_expert(env, proportional=True, name="renewable_prop"),
        make_combined_expert(env),
        make_do_nothing_expert(env),
    ]
