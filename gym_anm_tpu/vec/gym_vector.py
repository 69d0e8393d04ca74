"""Gymnasium ``VectorEnv`` adapter over the pure-functional vec tier.

The vec tier's native interface is pure functions (reset/step over an
``EnvState`` pytree) designed for ``jit``/``vmap``/``lax.scan``; this module
wraps one :class:`~gym_anm_tpu.vec.core.VecEnv` in the standard
``gymnasium.vector.VectorEnv`` API so off-the-shelf RL tooling (SB3-style
training loops, CleanRL scripts, Gymnasium vector wrappers) can drive the
batched on-device environment without writing any JAX.

All three Gymnasium autoreset conventions are supported (pass
``autoreset_mode=``):

* ``SAME_STEP`` (default): on the step where a lane terminates, the
  returned observation is the RESET observation of the new episode, and
  the terminal observation — the reference's zero vector
  (anm_env.py:444-448) — rides in ``infos["final_obs"]`` with the usual
  ``_final_obs`` mask.
* ``NEXT_STEP``: the terminating step returns the terminal observation
  itself; the lane resets on the FOLLOWING step (its action is ignored,
  reward 0, terminations False).  This is the mode Gymnasium's stateful
  vector wrappers (``NormalizeObservation``, ``NormalizeReward``, …)
  require, so the full wrapper ecosystem composes over this adapter.
* ``DISABLED``: terminated lanes absorb (zero observation, reward 0,
  ``terminations`` stays True) until ``reset()`` is called on the whole
  farm — the pure tier's native absorbing semantics.

Rewards/terminations are the reference MDP's (terminal reward −c2/(1−γ),
reward clipping, ≤100 reset retries) in every mode.

Performance note: this adapter crosses host↔device every ``step`` call, so
it runs at dispatch-latency speed, not at
the scan-fused millions-of-steps/s the native tier reaches.  Use it for
API interop and tooling; for throughput, use :meth:`VecEnv.rollout`
(``lax.scan`` on device) or a jitted loop over
:meth:`VecEnv.step_autoreset_batch`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

try:
    import gymnasium as gym
    from gymnasium.vector import AutoresetMode, VectorEnv
    from gymnasium.vector.utils import batch_space
except ImportError as e:
    raise ImportError(
        "GymVectorEnv needs gymnasium (pip install gymnasium); VecEnv "
        "itself runs without it") from e

from .core import VecEnv as _VecEnv, VecTask, farm_keys

__all__ = ["GymVectorEnv"]


class GymVectorEnv(VectorEnv):
    """A ``gymnasium.vector.VectorEnv`` view of a batched :class:`VecEnv`.

    Parameters
    ----------
    task : VecTask | VecEnv
        A task factory result (e.g. ``make_ieee33_multicap_task()``) or an
        already-constructed :class:`VecEnv`.
    num_envs : int
        Number of parallel lanes.
    dtype : jnp dtype
        Compute precision when ``task`` is a :class:`VecTask` (float32 for
        throughput, float64 for parity-grade numerics).
    seed : int
        Default RNG seed; ``reset(seed=None)`` advances an internal counter
        from it so successive unseeded resets differ.
    rng_impl : str | None
        ``None`` = threefry (deterministic across backends); ``"rbg"`` =
        XLA's native fast RNG (see :func:`farm_keys`).
    obs : str | list
        Observation spec forwarded to :class:`VecEnv` when ``task`` is a
        :class:`VecTask` — ``"state"`` or compat-style
        ``(variable, ids[, unit])`` triples.
    autoreset_mode : AutoresetMode | str
        ``SAME_STEP`` (default), ``NEXT_STEP``, or ``DISABLED`` — see the
        module docstring.  Strings accept the enum values
        (``"SameStep"``/``"NextStep"``/``"Disabled"``).
    mesh : jax.sharding.Mesh | None
        Shard the lane axis over a device mesh (e.g.
        ``parallel.make_env_mesh(jax.devices())``): the farm then spans
        every device behind the same Gymnasium API, with host numpy in/out
        scattered/gathered automatically by GSPMD.  ``num_envs`` must be a
        multiple of ``mesh.size``.  Lanes are independent, so sharded and
        unsharded farms agree to f32 solver tolerance (partition-dependent
        matmul blocking rounds differently within the chord solver's
        ≤1e-4 acceptance band — the same tolerance the repo-wide
        multi-device equivalence gates use).
    """

    metadata = {"autoreset_mode": AutoresetMode.SAME_STEP, "render_modes": []}
    render_mode = None

    def __init__(self, task, num_envs: int, dtype=jnp.float32, seed: int = 0,
                 rng_impl=None, obs="state",
                 autoreset_mode=AutoresetMode.SAME_STEP, mesh=None):
        self.venv = task if isinstance(task, _VecEnv) else _VecEnv(task, dtype=dtype, obs=obs)
        self.num_envs = int(num_envs)
        if mesh is not None and self.num_envs % mesh.size != 0:
            raise ValueError(
                f"num_envs={num_envs} must be a multiple of mesh.size={mesh.size}"
            )
        self.mesh = mesh
        self.autoreset_mode = AutoresetMode(autoreset_mode)
        # Per-instance metadata: wrappers read the mode from here.
        self.metadata = {**type(self).metadata, "autoreset_mode": self.autoreset_mode}
        self._rng_impl = rng_impl
        self._seed0 = int(seed)
        self._reset_count = 0
        self._state = None

        np_dtype = np.dtype(self.venv.dtype)
        self.single_observation_space = gym.spaces.Box(
            low=np.asarray(self.venv.obs_low, np_dtype),
            high=np.asarray(self.venv.obs_high, np_dtype),
            dtype=np_dtype,
        )
        self.single_action_space = gym.spaces.Box(
            low=np.asarray(self.venv.action_low, np_dtype),
            high=np.asarray(self.venv.action_high, np_dtype),
            dtype=np_dtype,
        )
        self.observation_space = batch_space(self.single_observation_space, num_envs)
        self.action_space = batch_space(self.single_action_space, num_envs)

        if self.autoreset_mode == AutoresetMode.SAME_STEP:
            step_fn = self.venv.step_autoreset_batch
        elif self.autoreset_mode == AutoresetMode.NEXT_STEP:
            step_fn = self._next_step_batch
        else:  # DISABLED — absorbing lanes, reset() resets the whole farm
            step_fn = jax.vmap(self.venv.step)
        # Donate the carried state: the previous step's buffers are dead the
        # moment the new state exists (the adapter owns the only reference).
        if mesh is None:
            self._reset_jit = jax.jit(jax.vmap(self.venv.reset))
            self._step_jit = jax.jit(step_fn, donate_argnums=0)
        else:
            from ..parallel.mesh import env_sharding

            # One sharding broadcast over every per-lane leaf (leading-dim
            # lane axis; GSPMD scatters host inputs / gathers outputs).
            sh = env_sharding(mesh)
            self._reset_jit = jax.jit(
                jax.vmap(self.venv.reset), in_shardings=sh, out_shardings=sh
            )
            self._step_jit = jax.jit(
                step_fn, donate_argnums=0, in_shardings=sh, out_shardings=sh
            )

    # ------------------------------------------------------------------
    def _next_step_batch(self, states, actions):
        """NEXT_STEP autoreset: lanes whose PREVIOUS step terminated are
        reset now (their action is ignored) instead of stepping.

        Same batch-level ``lax.cond`` structure as
        :meth:`VecEnv.step_autoreset_batch` — on the typical step where no
        lane needs a reset, the reset program never executes.  The stepped
        values for needs-reset lanes cost nothing extra (they ride the
        batched step as absorbing lanes) and are overwritten by the merge.
        """
        venv = self.venv
        prev_done = states.terminated
        new_states, obs, reward, done, info = jax.vmap(venv.step)(states, actions)
        keys = jax.vmap(jax.random.split)(new_states.key)
        k_reset, key = keys[:, 0], keys[:, 1]
        new_states = new_states._replace(key=key)

        def do_resets(operand):
            new_states, obs, k_reset = operand
            reset_states, reset_obs = jax.vmap(venv.reset)(k_reset, new_states.oltc_tap)

            def sel(r, n):
                d = prev_done.reshape(prev_done.shape + (1,) * (n.ndim - prev_done.ndim))
                return jnp.where(d, r, n)

            merged = jax.tree_util.tree_map(sel, reset_states, new_states)
            # Shaping carry persists across resets (reference tracker
            # semantics — see VecEnv.step_autoreset).
            merged = merged._replace(shaping=new_states.shaping)
            return merged, jnp.where(prev_done[:, None], reset_obs, obs)

        def no_resets(operand):
            new_states, obs, _ = operand
            return new_states, obs

        merged, obs = jax.lax.cond(
            jnp.any(prev_done), do_resets, no_resets, (new_states, obs, k_reset)
        )
        # Gymnasium NEXT_STEP convention for the reset step: reward 0,
        # terminations False (the fresh episode has not stepped yet).
        reward = jnp.where(prev_done, 0.0, reward)
        done = jnp.logical_and(done, jnp.logical_not(prev_done))
        return merged, obs, reward, done, info

    # ------------------------------------------------------------------
    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is None:
            seed = self._seed0 + self._reset_count
        self._reset_count += 1
        keys = farm_keys(int(seed), self.num_envs, impl=self._rng_impl)
        self._state, obs = self._reset_jit(keys)
        return np.asarray(jax.device_get(obs)), {}

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        acts = jnp.asarray(actions, dtype=self.venv.dtype)
        self._state, obs, reward, done, info = self._step_jit(self._state, acts)
        obs_np, reward_np, done_np, info = jax.device_get((obs, reward, done, info))
        obs_np = np.asarray(obs_np)
        terminations = np.asarray(done_np, dtype=bool)
        truncations = np.zeros(self.num_envs, dtype=bool)

        infos: dict = {k: np.asarray(v) for k, v in info.items()}
        if self.autoreset_mode == AutoresetMode.SAME_STEP and terminations.any():
            # SAME_STEP convention: the terminal observation (the
            # reference's zero vector) and a per-lane final info, masked.
            final_obs = np.full(self.num_envs, None, dtype=object)
            final_info = np.full(self.num_envs, None, dtype=object)
            zero = np.zeros(self.venv.n_obs, dtype=obs_np.dtype)
            for i in np.flatnonzero(terminations):
                final_obs[i] = zero.copy()
                final_info[i] = {}
            infos["final_obs"] = final_obs
            infos["_final_obs"] = terminations.copy()
            infos["final_info"] = final_info
            infos["_final_info"] = terminations.copy()

        return obs_np, np.asarray(reward_np), terminations, truncations, infos

    # ------------------------------------------------------------------
    @property
    def state(self):
        """The device-resident :class:`EnvState` pytree (advanced use)."""
        return self._state

    def close_extras(self, **kwargs):
        self._state = None
