"""Vectorized, pure-functional environment engine.

This is the at-scale tier: where :mod:`gym_anm_tpu.compat` wraps one grid
instance in a Gymnasium object, here the environment is a pair of pure
functions

    reset(key, carry)          -> (EnvState, obs)
    step(EnvState, action)     -> (EnvState, obs, reward, done, info)

over flat array state, so that ``jax.vmap`` runs thousands of independent
grid instances in lockstep, ``jax.lax.scan`` runs whole rollouts on-device,
and ``jax.sharding``/``shard_map`` spreads the batch across device meshes.
The MDP semantics (state layout, reward clipping, terminal handling,
reset-retry) mirror the reference ``ANMEnv`` (anm_env.py:235-469); the
stochastic hooks use ``jax.random`` instead of numpy RNGs (bit-level RNG
parity is the compat tier's job).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..physics.transition import GridTables, make_tables, solution_guess, transition
from ..specs.network import NetworkSpec, load_network


def farm_keys(seed, n, impl=None):
    """``n`` independent per-lane PRNG keys for an environment farm.

    ``impl=None`` gives JAX's default (threefry) keys — fully deterministic
    across backends.  ``impl="rbg"`` selects the ``RngBitGenerator``-backed
    implementation: per-lane *bulk* sampling (the stochastic tasks' load
    noise, policy draws) compiles to XLA's native fast RNG instead of
    threefry's elementwise bit mixing (chosen when threefry dominated the
    stochastic tasks' step time on the previous accelerator; not yet
    measured on the GPU).  Every VecEnv entry point accepts either kind —
    the key chains (split/fold_in) are structured identically; only the
    stream values differ, so rbg trajectories are not bit-reproducible
    across backends/jaxlib versions (fine for throughput/training work,
    use the default for parity work).
    """
    key = jax.random.key(seed, impl=impl) if impl else jax.random.PRNGKey(seed)
    return jax.random.split(key, n)


class EnvState(NamedTuple):
    """Per-lane carried state (a flat pytree — checkpointable with orbax)."""

    key: jax.Array          # PRNG key
    soc: jax.Array          # [n_des] p.u.
    oltc_tap: jax.Array     # [n_oltc] (persists across resets, like the ref)
    dev_p: jax.Array        # [n_dev] p.u. (for state/obs extraction)
    dev_q: jax.Array
    p_pot: jax.Array        # [n_gen] p.u.
    bus_vm: jax.Array       # [n_bus] voltage magnitudes (controllers read these)
    aux: jax.Array          # [K]
    task: Any               # task-specific carry (e.g. hour-of-day)
    terminated: jax.Array   # bool
    t: jax.Array            # int32 timestep
    # Previous solve's [θ₁.., |V|₁..] — warm start for the f32 chord solver
    # (successive grid states are close, halving iteration counts).  The
    # solver falls back to flat start when entries are non-finite.
    v_guess: jax.Array      # [2·(n_bus−1)]
    # Reward-shaping carry (VecTask.shape_reward_fn), e.g. the unequal-caps
    # previous set-points + switching counters.  Persists across autoresets,
    # like the reference tracker (ieee33_unequal_capacitors.py:118-125 —
    # initialized in __init__, never cleared by reset()).
    shaping: Any = ()


@dataclasses.dataclass(frozen=True)
class VecTask:
    """A task definition: a network + MDP constants + pure stochastic hooks.

    init_state_fn(key, task_carry) -> s0 vector with the reference layout
        [dev_p (MW), dev_q (MVAr), des_soc (MWh), gen_p_max (MW), aux].
    next_vars_fn(key, s_t, task_carry, t) -> (vars, new_task_carry) where
        vars = [P_load (MW), P_pot (MW), aux'] (anm_env.py:172-191).
    init_task_fn(key) -> initial task carry (use () when stateless).
    """

    network: dict
    K: int
    delta_t: float
    gamma: float
    lamb: float
    costs_clipping: tuple
    init_state_fn: Callable
    next_vars_fn: Callable
    init_task_fn: Callable = lambda key: ()
    rates: Optional[np.ndarray] = None  # override the spec's branch rates
    # Optional post-step reward shaping with per-lane carried state (the
    # vec equivalent of a compat subclass wrapping step(), e.g. the
    # unequal-capacitor switching costs).  Called AFTER terminal-reward
    # selection and absorbing-lane zeroing, exactly where the reference
    # subclass adjusts the returned reward:
    #   shape_reward_fn(carry, action, reward) -> (new_carry, reward, extras)
    # with ``extras`` merged into the step info dict.  ``init_shape_fn``
    # builds the initial per-lane carry (receives the env compute dtype).
    shape_reward_fn: Optional[Callable] = None
    init_shape_fn: Callable = lambda dtype: ()
    # Optional chord linearization point [2(n_bus-1)] for the f32 solver —
    # the task's typical solved operating state (host-computed).  None =
    # flat start.  Iteration-count tuning only; the stopping rule is
    # unchanged, so results are identical either way.
    chord_x_star: Optional[np.ndarray] = None
    name: str = "task"


class VecEnv:
    """Compiled vectorized environment for one task.

    All methods are pure functions of their inputs; wrap them in
    ``jax.jit``/``jax.vmap``/``shard_map`` freely.  ``dtype`` selects the
    compute precision: float64 for parity work, float32 for
    throughput (the NR tolerance of 1e-5 is comfortably reachable in f32
    for these network scales).

    ``obs`` selects the observation space, in the compat/reference format
    (anm_env.py:516-540): the string ``"state"`` (fully observable — the
    flat MDP state vector, the default and the fast path) or a list of
    ``(variable, ids[, unit])`` triples, compiled once into static gathers
    over the transition output (:mod:`gym_anm_tpu.vec.obs`).
    """

    def __init__(self, task: VecTask, dtype=jnp.float32, obs="state"):
        self.task = task
        self.dtype = jnp.dtype(dtype)
        self.spec: NetworkSpec = load_network(task.network)
        self.tables: GridTables = make_tables(self.spec, task.delta_t, task.lamb, dtype=dtype,
                                      chord_x_star=task.chord_x_star)
        spec = self.spec

        c1 = np.inf if task.costs_clipping is None or task.costs_clipping[0] is None else task.costs_clipping[0]
        c2 = np.inf if task.costs_clipping is None or task.costs_clipping[1] is None else task.costs_clipping[1]
        self.costs_clipping = (float(c1), float(c2))

        lo, hi = spec.action_bounds()
        self.action_low = jnp.asarray(lo, dtype=dtype)
        self.action_high = jnp.asarray(hi, dtype=dtype)
        self.n_action = spec.n_action
        self.n_state = spec.n_state + task.K

        if task.rates is not None:
            self._rates = jnp.asarray(task.rates, dtype=dtype)
        else:
            self._rates = jnp.asarray(spec.br_rate, dtype=dtype)

        # Observation bounds for the fully-observable ("state") case,
        # including the reference's gen_p_max MW-bound quirk
        # (simulator.py:470).
        base = spec.baseMVA
        lows = np.concatenate(
            [
                spec.p_min * base,
                spec.q_min * base,
                spec.soc_min[spec.des_pos] * base,
                spec.p_min[spec.gen_nonslack_pos] * base,
                np.full(task.K, -np.inf),
            ]
        )
        highs = np.concatenate(
            [
                spec.p_max * base,
                spec.q_max * base,
                spec.soc_max[spec.des_pos] * base,
                spec.q_max[spec.gen_nonslack_pos] * base,  # the quirk
                np.full(task.K, np.inf),
            ]
        )
        if isinstance(obs, str) and obs == "state":
            self._obs_plan = None
            self.n_obs = self.n_state
            self.obs_low = jnp.asarray(lows, dtype=dtype)
            self.obs_high = jnp.asarray(highs, dtype=dtype)
        elif isinstance(obs, list):
            from .obs import make_obs_plan

            self._obs_plan = make_obs_plan(spec, task.K, obs)
            self.n_obs = self._obs_plan.n
            self.obs_low = jnp.asarray(self._obs_plan.low, dtype=dtype)
            self.obs_high = jnp.asarray(self._obs_plan.high, dtype=dtype)
        else:
            from ..errors import ObsSpaceError

            raise ObsSpaceError(
                f"obs must be 'state' or a list of (var, ids, unit) triples, got {obs!r}"
            )

        self._action_slices = self._make_action_slices()

    # ------------------------------------------------------------------
    def _make_action_slices(self):
        n_gen, n_des = self.spec.n_gen, self.spec.n_des
        n_cap, n_oltc = self.spec.n_cap, self.spec.n_oltc
        i = 0
        sl = {}
        for name, n in (("P_gen", n_gen), ("Q_gen", n_gen), ("P_des", n_des),
                        ("Q_des", n_des), ("Q_cap", n_cap), ("tap", n_oltc)):
            sl[name] = slice(i, i + n)
            i += n
        return sl

    def split_action(self, action):
        sl = self._action_slices
        return (action[..., sl["P_gen"]], action[..., sl["Q_gen"]],
                action[..., sl["P_des"]], action[..., sl["Q_des"]],
                action[..., sl["Q_cap"]], action[..., sl["tap"]])

    # ------------------------------------------------------------------
    def _state_vector(self, dev_p, dev_q, soc, p_pot, aux):
        """Flat MDP state [dev_p MW, dev_q MVAr, soc MWh, gen_p_max MW, aux]
        (anm_env.py:139-147)."""
        base = self.tables.baseMVA
        return jnp.concatenate([dev_p * base, dev_q * base, soc * base, p_pot * base, aux])

    def observation(self, state_vec):
        return jnp.clip(state_vec, self.obs_low, self.obs_high)

    def _obs_from_out(self, out, soc_pu, aux):
        """Observation from one transition output (obs-plan-aware)."""
        if self._obs_plan is None:
            s_vec = self._state_vector(out.dev_p, out.dev_q, soc_pu, out.gen_p_pot, aux)
            return self.observation(s_vec)
        o = self._obs_plan.extract(out, soc_pu, aux).astype(self.dtype)
        return jnp.clip(o, self.obs_low, self.obs_high)

    # ------------------------------------------------------------------
    def _run_transition(self, P_load, P_pot, P_gen, Q_gen, P_des, Q_des, Q_cap,
                        taps, soc, x_guess=None):
        return transition(
            self.tables,
            P_load.astype(self.dtype), P_pot.astype(self.dtype),
            P_gen.astype(self.dtype), Q_gen.astype(self.dtype),
            P_des.astype(self.dtype), Q_des.astype(self.dtype),
            Q_cap.astype(self.dtype), taps.astype(self.dtype),
            soc.astype(self.dtype), self._rates, x_guess=x_guess,
        )

    def _decode_s0(self, s0):
        """Split an s0 vector into transition inputs (simulator.py:267-301)."""
        spec = self.spec
        n_dev, n_des, n_gen = spec.n_dev, spec.n_des, spec.n_gen
        P_dev = s0[:n_dev]
        Q_dev = s0[n_dev : 2 * n_dev]
        soc_mwh = s0[2 * n_dev : 2 * n_dev + n_des]
        P_max = s0[2 * n_dev + n_des : 2 * n_dev + n_des + n_gen]
        aux = s0[2 * n_dev + n_des + n_gen :]

        P_load = P_dev[spec.load_pos]
        P_gen = P_dev[spec.gen_nonslack_pos]
        Q_gen = Q_dev[spec.gen_nonslack_pos]
        P_des = P_dev[spec.des_pos]
        Q_des = Q_dev[spec.des_pos]
        Q_cap = Q_dev[spec.cap_pos]
        # Seed SoC to empty/full so the requested injection is feasible.
        soc_seed = jnp.where(
            P_des <= 0,
            jnp.asarray(spec.soc_min[spec.des_pos], self.dtype),
            jnp.asarray(spec.soc_max[spec.des_pos], self.dtype),
        )
        return P_load, P_max, P_gen, Q_gen, P_des, Q_des, Q_cap, soc_seed, soc_mwh, aux

    # ------------------------------------------------------------------
    def reset(self, key, oltc_tap=None):
        """Sample initial states until the load flow converges (≤100 tries,
        anm_env.py:266-289).  Returns (EnvState, obs)."""
        if oltc_tap is None:
            oltc_tap = jnp.ones(self.spec.n_oltc, dtype=self.dtype)

        def attempt(key, task_carry):
            k_init, k_next = jax.random.split(key)
            s0 = self.task.init_state_fn(k_init, task_carry).astype(self.dtype)
            (P_load, P_max, P_gen, Q_gen, P_des, Q_des, Q_cap,
             soc_seed, soc_mwh, aux) = self._decode_s0(s0)
            out = self._run_transition(
                P_load, P_max, P_gen, Q_gen, P_des, Q_des, Q_cap, oltc_tap, soc_seed
            )
            soc = jnp.asarray(soc_mwh, self.dtype) / self.tables.baseMVA
            return k_next, out, soc, aux

        k_task, key = jax.random.split(key)
        task_carry = self.task.init_task_fn(k_task)

        key0, out0, soc0, aux0 = attempt(key, task_carry)

        def cond(carry):
            _, out, _, _, tries = carry
            return jnp.logical_and(jnp.logical_not(out.stable), tries < 100)

        def body(carry):
            key, _, _, _, tries = carry
            key2, out, soc, aux = attempt(key, task_carry)
            return key2, out, soc, aux, tries + 1

        key, out, soc, aux, _ = jax.lax.while_loop(
            cond, body, (key0, out0, soc0, aux0, jnp.ones((), jnp.int32))
        )

        state = EnvState(
            key=key,
            soc=soc,
            oltc_tap=out.oltc_tap,
            dev_p=out.dev_p,
            dev_q=out.dev_q,
            p_pot=out.gen_p_pot,
            bus_vm=jnp.sqrt(out.bus_v_re**2 + out.bus_v_im**2),
            aux=aux,
            task=task_carry,
            terminated=jnp.logical_not(out.stable),
            t=jnp.zeros((), jnp.int32),
            v_guess=solution_guess(out),
            shaping=self.task.init_shape_fn(self.dtype),
        )
        return state, self._obs_from_out(out, soc, aux)

    # ------------------------------------------------------------------
    def step(self, state: EnvState, action):
        """One MDP step (anm_env.py:333-469).  Pure; vmap over lanes."""
        spec = self.spec
        key, k_vars = jax.random.split(state.key)

        s_t = self._state_vector(state.dev_p, state.dev_q, state.soc, state.p_pot, state.aux)
        vars, task_carry = self.task.next_vars_fn(k_vars, s_t, state.task, state.t)
        n_load, n_gen = spec.n_load, spec.n_gen
        P_load = vars[:n_load]
        P_pot = vars[n_load : n_load + n_gen]
        aux = vars[n_load + n_gen :]

        P_gen, Q_gen, P_des, Q_des, Q_cap, taps = self.split_action(action)

        out = self._run_transition(P_load, P_pot, P_gen, Q_gen, P_des, Q_des,
                                   Q_cap, taps, state.soc, x_guess=state.v_guess)

        terminated = jnp.logical_not(out.stable)
        c1, c2 = self.costs_clipping
        e_loss = jnp.sign(out.e_loss) * jnp.clip(jnp.abs(out.e_loss), 0.0, c1)
        penalty = jnp.clip(out.penalty, 0.0, c2)
        reward_ok = -(e_loss + penalty)
        reward_terminal = jnp.asarray(-c2 / (1.0 - self.task.gamma), self.dtype)
        reward = jnp.where(terminated, reward_terminal, reward_ok).astype(self.dtype)
        # Lanes already terminated absorb with 0 reward (anm_env.py:363-367).
        reward = jnp.where(state.terminated, 0.0, reward)
        now_terminated = jnp.logical_or(state.terminated, terminated)

        # Post-step reward shaping (e.g. switching costs) — applied after
        # terminal selection, exactly like the compat subclass wrapping
        # step() (ieee33_unequal_capacitors.py:144-169).
        shaping_extras = {}
        if self.task.shape_reward_fn is not None:
            shaping, reward, shaping_extras = self.task.shape_reward_fn(
                state.shaping, action, reward
            )
        else:
            shaping = state.shaping

        new_state = EnvState(
            key=key,
            soc=jnp.where(state.terminated, state.soc, out.des_soc),
            oltc_tap=jnp.where(state.terminated, state.oltc_tap, out.oltc_tap),
            dev_p=out.dev_p,
            dev_q=out.dev_q,
            p_pot=out.gen_p_pot,
            bus_vm=jnp.sqrt(out.bus_v_re**2 + out.bus_v_im**2),
            aux=aux.astype(self.dtype),
            task=task_carry,
            terminated=now_terminated,
            t=state.t + 1,
            # Keep the last STABLE solution as the next warm start: a
            # diverged solve's iterate would poison subsequent solves.
            v_guess=jnp.where(out.stable, solution_guess(out), state.v_guess),
            shaping=shaping,
        )
        obs = jnp.where(
            now_terminated, 0.0,
            self._obs_from_out(out, out.des_soc, aux.astype(self.dtype)),
        )
        info = {"e_loss": e_loss, "penalty": penalty, "n_iter": out.n_iter,
                "diff": out.diff, **shaping_extras}
        return new_state, obs, reward, now_terminated, info

    def step_autoreset(self, state: EnvState, action):
        """Step; a terminated lane is reset in place (for infinite farms).

        Single-lane function like :meth:`step` — ``done`` is a scalar and
        broadcasting selects whole reset leaves.  vmap over lanes.  For
        batched callers prefer :meth:`step_autoreset_batch`, which skips
        the reset program entirely on steps where no lane terminated.
        """
        new_state, obs, reward, done, info = self.step(state, action)
        k_reset, key = jax.random.split(new_state.key)
        reset_state, reset_obs = self.reset(k_reset, oltc_tap=new_state.oltc_tap)
        merged = jax.tree_util.tree_map(
            lambda r, n: jnp.where(done, r, n),
            reset_state,
            new_state._replace(key=key),
        )
        # The shaping carry persists across resets (reference semantics:
        # the tracker lives on the env object, reset() never clears it).
        merged = merged._replace(shaping=new_state.shaping)
        obs = jnp.where(done, reset_obs, obs)
        return merged, obs, reward, done, info

    def step_autoreset_batch(self, states: EnvState, actions):
        """Batched autoreset step: semantically identical to
        ``vmap(step_autoreset)``, but the reset program runs under a
        batch-level ``lax.cond`` on ``done.any()`` — on the (typical)
        steps where NO lane terminated, the reset's full extra transition
        is skipped at runtime instead of being computed and discarded per
        lane.  Divergences are rare, so this nearly halves the autoreset
        step cost.

        RNG streams match ``vmap(step_autoreset)`` exactly: the per-lane
        key split happens unconditionally, and a skipped reset only ever
        discards draws that the per-lane version would also have
        discarded (non-done lanes never keep reset results).
        """
        new_states, obs, reward, done, info = jax.vmap(self.step)(states, actions)
        keys = jax.vmap(jax.random.split)(new_states.key)
        k_reset, key = keys[:, 0], keys[:, 1]
        new_states = new_states._replace(key=key)

        def do_resets(operand):
            new_states, obs, k_reset = operand
            reset_states, reset_obs = jax.vmap(self.reset)(k_reset, new_states.oltc_tap)

            def sel(r, n):
                d = done.reshape(done.shape + (1,) * (n.ndim - done.ndim))
                return jnp.where(d, r, n)

            merged = jax.tree_util.tree_map(sel, reset_states, new_states)
            # Shaping carry persists across resets (see step_autoreset).
            merged = merged._replace(shaping=new_states.shaping)
            return merged, jnp.where(done[:, None], reset_obs, obs)

        def no_resets(operand):
            new_states, obs, _ = operand
            return new_states, obs

        merged, obs = jax.lax.cond(
            jnp.any(done), do_resets, no_resets, (new_states, obs, k_reset)
        )
        return merged, obs, reward, done, info

    # ------------------------------------------------------------------
    def rollout(self, state: EnvState, policy_fn, n_steps: int, autoreset=True,
                obs0=None):
        """Run ``n_steps`` on-device under ``lax.scan``.

        policy_fn(key, obs, t) -> action.  Returns (final_state, traj) where
        traj stacks (obs, action, reward, done) along time.  For a
        partial-observation env (``obs=`` triples), pass the ``obs0``
        returned by :meth:`reset`/:meth:`step` — it cannot be recomputed
        from the carried state alone (it may include branch/bus solution
        quantities).
        """
        step = self.step_autoreset if autoreset else self.step

        if obs0 is None:
            if self._obs_plan is not None:
                raise ValueError(
                    "rollout over a partial-observation env requires obs0 "
                    "(the observation returned by reset/step)"
                )
            s_vec = self._state_vector(state.dev_p, state.dev_q, state.soc, state.p_pot, state.aux)
            obs0 = jnp.where(state.terminated, 0.0, self.observation(s_vec))

        def body(carry, t):
            st, obs = carry
            k_act, key = jax.random.split(st.key)
            action = policy_fn(k_act, obs, t)
            st = st._replace(key=key)
            st, obs2, r, d, info = step(st, action)
            return (st, obs2), (obs, action, r, d)

        (state, _), traj = jax.lax.scan(body, (state, obs0), jnp.arange(n_steps))
        return state, traj

    # ------------------------------------------------------------------
    def random_policy(self):
        """Uniform random policy over the action box (gym.spaces.Box.sample
        equivalent for bounded boxes)."""
        lo, hi = self.action_low, self.action_high

        def policy(key, obs, t):
            shape = obs.shape[:-1] + (self.n_action,)
            u = jax.random.uniform(key, shape, dtype=self.dtype)
            return lo + u * (hi - lo)

        return policy
