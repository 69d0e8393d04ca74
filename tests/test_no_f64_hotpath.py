"""Guard: no float64 ops may leak into the f32 tier's compiled hot paths.

The package enables ``jax_enable_x64`` globally (the compat/parity tier
needs it), which makes any UNANNOTATED scalar draw, constant, or
``where``-of-scalars default to f64, putting f64 elementwise/RNG work on the
f32 hot path.  Two such leaks were found this way: the diurnal load-noise
draw, and the hour-of-day task carry, which dragged ~76 f64 ops through the
clock/sine/reset-retry chain.

This test compiles the actual reset/step programs of every f32 task and
asserts the optimized HLO contains ZERO f64-producing instructions, so
the trap cannot regress silently.  (CPU-compiled HLO is a faithful proxy:
XLA's dtype semantics are platform-independent, only the lowering cost
differs.)
"""

import re

import jax
import jax.numpy as jnp
import pytest

from gym_anm_tpu.vec import (
    VecEnv,
    farm_keys,
    make_anm6easy_task,
    make_ieee33_multicap_task,
    make_ieee33_renewable_task,
    make_ieee33_task,
    make_ieee33_unequal_task,
)

TASKS = {
    "ieee33": make_ieee33_task,
    "multicap": make_ieee33_multicap_task,
    "renewable": make_ieee33_renewable_task,
    "unequal": make_ieee33_unequal_task,
    "anm6easy": make_anm6easy_task,
}


def _f64_ops(hlo_text):
    """f64-array-producing instructions in optimized HLO (constants and
    broadcasts included — after constant folding, ANY survivor implies
    runtime f64 work or an f64 buffer crossing a program boundary)."""
    return re.findall(r"f64\[[0-9,]*\][^ ]* (\w+)", hlo_text)


def test_controller_suite_is_f64_free():
    """The L0-L5 act programs (the dataset-generation inner loop) must
    compile f64-free too — Python-float ``where`` branches are weak f64
    under x64 (three controllers leaked exactly that way)."""
    env = VecEnv(make_ieee33_multicap_task(), dtype=jnp.float32)
    from gym_anm_tpu.vec.controllers import make_suite

    state, _ = jax.jit(jax.vmap(env.reset))(farm_keys(0, 4))
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    for ctrl in make_suite(env):
        carry = jax.vmap(ctrl.init_carry)(jax.random.split(jax.random.PRNGKey(1), 4))
        hlo = (
            jax.jit(jax.vmap(ctrl.act))
            .lower(keys, state, jnp.zeros((4, env.n_obs), jnp.float32), carry)
            .compile()
            .as_text()
        )
        assert not _f64_ops(hlo), f"{ctrl.name} leaks f64 ops: {_f64_ops(hlo)[:10]}"


@pytest.mark.parametrize("name", list(TASKS))
def test_scan_embedded_step_is_f64_free(name):
    """The bench/rollout embedding: step_autoreset_batch under lax.scan.

    A standalone step program can hide an f64 constant — XLA folds the
    f64→f32 convert of a trace-time table at compile — but under scan the
    same table is HOISTED into the while-loop carry in its original f64
    form with an in-loop convert (caught live: the ANM6 profile tables as
    f64[3,96]/f64[2,96] loop state in the MPC bench scan).  Guard the
    embedded form too."""
    env = VecEnv(TASKS[name](), dtype=jnp.float32)
    B = 8
    keys = farm_keys(0, B)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    lo, hi = env.action_low, env.action_high

    def run(state, obs, seed):
        def body(sc, t):
            st, obs = sc
            k = jax.random.fold_in(jax.random.PRNGKey(seed, impl="threefry2x32"), t)
            a = lo + jax.random.uniform(k, (B, env.n_action), dtype=env.dtype) * (hi - lo)
            st, obs, r, d, _ = env.step_autoreset_batch(st, a)
            return (st, obs), r.sum()

        (state, obs), rs = jax.lax.scan(body, (state, obs), jnp.arange(3))
        return rs.sum()

    hlo = jax.jit(run).lower(state, obs, 0).compile().as_text()
    assert not _f64_ops(hlo), f"{name} scan-step leaks f64 ops: {_f64_ops(hlo)[:10]}"


@pytest.mark.parametrize("name", list(TASKS))
def test_f32_hot_paths_are_f64_free(name):
    env = VecEnv(TASKS[name](), dtype=jnp.float32)
    keys = farm_keys(0, 8)
    reset_fn = jax.jit(jax.vmap(env.reset))
    state, _ = reset_fn(keys)
    acts = jnp.zeros((8, env.n_action), jnp.float32)

    hlo = reset_fn.lower(keys).compile().as_text()
    assert not _f64_ops(hlo), f"{name}.reset leaks f64 ops: {_f64_ops(hlo)[:10]}"

    step_fn = jax.jit(env.step_autoreset_batch)
    hlo = step_fn.lower(state, acts).compile().as_text()
    assert not _f64_ops(hlo), f"{name}.step leaks f64 ops: {_f64_ops(hlo)[:10]}"
