"""On-device offline-RL dataset generation at scale.

The on-device counterpart of :mod:`gym_anm_tpu.offline`: whole datasets are
produced by a single ``lax.scan`` over a vmapped environment batch — no host
round-trips, millions of transitions per minute on one chip.  No reference
counterpart exists at this scale (the reference collects one transition per
Python step, offline.py:7-78).
"""

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .vec.controllers import Controller
from .vec.core import EnvState, VecEnv


def generate_dataset_vec(env: VecEnv, controller: Optional[Controller], key,
                         batch: int, steps: int, autoreset: bool = True):
    """Collect (obs, action, reward, next_obs, done) for ``batch`` lanes ×
    ``steps`` steps under one jitted scan.

    ``controller=None`` collects uniform-random actions.  Returns arrays of
    shape [steps, batch, ...] (device arrays; convert as needed).
    """
    if controller is None:
        from .vec.controllers import make_l0

        controller = make_l0(env)

    k_env, k_ctrl = jax.random.split(key)
    env_keys = jax.random.split(k_env, batch)

    @jax.jit
    def run(env_keys, k_ctrl):
        state, obs = jax.vmap(env.reset)(env_keys)
        carry0 = jax.vmap(controller.init_carry)(jax.random.split(k_ctrl, batch))
        step = env.step_autoreset_batch if autoreset else (
            lambda st, a: jax.vmap(env.step)(st, a))

        def body(sc, t):
            state, obs, carry = sc
            k = jax.vmap(lambda s: jax.random.fold_in(s.key, 7))(state)
            action, carry = jax.vmap(controller.act)(k, state, obs, carry)
            action = jnp.clip(action, env.action_low, env.action_high)
            state2, obs2, r, d, _ = step(state, action)
            return (state2, obs2, carry), (obs, action, r, obs2, d)

        (state, obs, carry), traj = jax.lax.scan(
            body, (state, obs, carry0), jnp.arange(steps)
        )
        return traj

    return run(env_keys, k_ctrl)


def make_mixed_collector(env: VecEnv, controllers: Sequence[Controller],
                         batch: int, steps: int):
    """Build a reusable jitted mixed-policy collector:

        collect(key, assignment) -> traj

    with traj = (obs, action, reward, next_obs, done), each [steps, batch,
    ...].  ``assignment`` is the per-lane controller index; all controllers
    run branch-free via masking inside ONE compiled program, so repeated
    collections (different keys/assignments) reuse the compile — call sites
    that loop MUST reuse the returned function, re-building it retraces.
    """

    @jax.jit
    def collect(key, assignment):
        k_env, k_ctrl = jax.random.split(key)
        env_keys = jax.random.split(k_env, batch)
        state, obs = jax.vmap(env.reset)(env_keys)
        carries0 = tuple(
            jax.vmap(c.init_carry)(jax.random.split(jax.random.fold_in(k_ctrl, i), batch))
            for i, c in enumerate(controllers)
        )

        def body(sc, t):
            state, obs, carries = sc
            k = jax.vmap(lambda s: jax.random.fold_in(s.key, 11))(state)
            outs = [
                jax.vmap(c.act)(k, state, obs, carries[i]) for i, c in enumerate(controllers)
            ]
            actions = jnp.stack([o[0] for o in outs])       # [n, B, A]
            new_carries = tuple(o[1] for o in outs)
            action = jnp.take_along_axis(
                actions, assignment[None, :, None], axis=0
            )[0]
            action = jnp.clip(action, env.action_low, env.action_high)
            state2, obs2, r, d, _ = env.step_autoreset_batch(state, action)
            return (state2, obs2, new_carries), (obs, action, r, obs2, d)

        (state, obs, carries), traj = jax.lax.scan(
            body, (state, obs, carries0), jnp.arange(steps)
        )
        return traj

    return collect


def make_block_collector(env: VecEnv, controllers: Sequence[Controller],
                         batch: int, steps: int):
    """Block-assignment specialization of :func:`make_mixed_collector`:
    lane block ``i`` (contiguous, ``batch // n`` lanes, remainder to the
    last block) is driven by controller ``i``, so each controller's ``act``
    runs only on ITS OWN lanes via static slicing — no n× masked
    evaluation of every controller on every lane.  Semantically identical
    to ``make_mixed_collector`` with
    ``assignment = repeat(arange(n), batch//n ...)``; per-lane env key
    chains and controller carries are unchanged.

        collect(key) -> (traj, assignment)

    with traj = (obs, action, reward, next_obs, done), each [steps, batch,
    ...].  This is the dataset-generation fast path (the bench workload).
    """
    n = len(controllers)
    sizes = [batch // n] * n
    sizes[-1] += batch - sum(sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    assignment = jnp.asarray(np.repeat(np.arange(n), sizes), jnp.int32)

    @jax.jit
    def collect(key):
        k_env, k_ctrl = jax.random.split(key)
        env_keys = jax.random.split(k_env, batch)
        state, obs = jax.vmap(env.reset)(env_keys)
        # Carry init keys are the GLOBAL-lane key table sliced to the block,
        # so trajectories are bit-identical to make_mixed_collector with the
        # same block assignment (pinned in tests/test_vec_controllers.py).
        carries0 = tuple(
            jax.vmap(c.init_carry)(
                jax.random.split(jax.random.fold_in(k_ctrl, i), batch)[starts[i]:starts[i + 1]])
            for i, c in enumerate(controllers)
        )

        def body(sc, t):
            state, obs, carries = sc
            k = jax.vmap(lambda s: jax.random.fold_in(s.key, 11))(state)
            blocks, new_carries = [], []
            for i, c in enumerate(controllers):
                sl = slice(starts[i], starts[i + 1])
                st_i = jax.tree_util.tree_map(lambda x: x[sl], state)
                a_i, carry_i = jax.vmap(c.act)(k[sl], st_i, obs[sl], carries[i])
                blocks.append(a_i)
                new_carries.append(carry_i)
            action = jnp.clip(jnp.concatenate(blocks, axis=0),
                              env.action_low, env.action_high)
            state2, obs2, r, d, _ = env.step_autoreset_batch(state, action)
            return (state2, obs2, tuple(new_carries)), (obs, action, r, obs2, d)

        (state, obs, carries), traj = jax.lax.scan(
            body, (state, obs, carries0), jnp.arange(steps)
        )
        return traj

    return collect, assignment


def generate_mixed_dataset_vec(env: VecEnv, controllers: Sequence[Controller], key,
                               batch: int, steps: int,
                               weights: Optional[Sequence[float]] = None,
                               assignment=None, collector=None):
    """Mixed-policy dataset: each lane is assigned one controller (sampled
    with ``weights``, or fixed via ``assignment``), and all controllers run
    branch-free via masking.

    Passing an explicit per-lane ``assignment`` (int array [batch]) turns
    this into a single-compile multi-controller collector — e.g.
    ``jnp.repeat(jnp.arange(n), lanes)`` gives each controller its own lane
    block within ONE jitted program, instead of compiling one program per
    controller.

    When calling repeatedly (same env/shapes), build the program once with
    :func:`make_mixed_collector` and pass it as ``collector`` — otherwise
    each call creates a fresh jit closure and recompiles.

    Returns (traj, assignment) where traj = (obs, action, reward, next_obs,
    done) with shape [steps, batch, ...] and assignment is the per-lane
    controller index.
    """
    n = len(controllers)
    if weights is None:
        probs = jnp.full(n, 1.0 / n)
    else:
        w = jnp.asarray(weights, dtype=jnp.float32)
        if w.shape[0] != n:
            raise ValueError("Length of weights must match number of controllers")
        probs = w / w.sum()

    k_run, k_assign = jax.random.split(jax.random.fold_in(key, 3))
    if assignment is None:
        assignment = jax.random.choice(k_assign, n, (batch,), p=probs)
    else:
        assignment = jnp.asarray(assignment, jnp.int32)
        if assignment.shape != (batch,):
            raise ValueError(f"assignment must have shape ({batch},)")

    if collector is None:
        collector = make_mixed_collector(env, controllers, batch, steps)
    return collector(k_run, assignment), assignment


def behavior_cloning_vec(obs, actions, action_low, action_high):
    """Least-squares linear policy with bias on device (jnp.linalg.lstsq)."""
    X = obs.reshape(-1, obs.shape[-1])
    Y = actions.reshape(-1, actions.shape[-1])
    X1 = jnp.concatenate([X, jnp.ones((X.shape[0], 1), X.dtype)], axis=1)
    w, _, _, _ = jnp.linalg.lstsq(X1, Y, rcond=None)

    def policy(state_vec):
        a = jnp.concatenate([state_vec, jnp.ones(state_vec.shape[:-1] + (1,), state_vec.dtype)], -1) @ w
        return jnp.clip(a, action_low, action_high)

    return policy, w


def evaluate_controller_vec(env: VecEnv, controller: Controller, key,
                            batch: int, steps: int):
    """Mean per-step reward of a controller over a fresh batch (jitted)."""
    traj = generate_dataset_vec(env, controller, key, batch, steps)
    _, _, rewards, _, _ = traj
    return float(jnp.mean(rewards))
