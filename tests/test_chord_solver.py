"""Chord-Newton fast-path correctness.

The float32 throughput tier solves the load flow with a chord iteration
whose matrix is the flat-start Jacobian at the lane's OLTC tap, applied via
a rank-2 Sherman-Morrison-Woodbury correction of a shared inverse
(physics/power_flow.py: make_chord_const, chord_solve).  These tests pin the
algebraic identities in float64 and the end-to-end agreement between the
chord path and the exact Newton-Raphson loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gym_anm_tpu.physics.power_flow import (
    _assemble_v,
    _jacobian,
    _mismatch,
    chord_solve,
    make_chord_const,
    nr_solve,
)
from gym_anm_tpu.physics.complexops import cmatvec
from gym_anm_tpu.physics.ybus import build_ybus
from gym_anm_tpu.vec import VecEnv, make_ieee33_task


@pytest.fixture(scope="module")
def env64():
    return VecEnv(make_ieee33_task(), dtype=jnp.float64)


def _ybus_at_tap(tb, a, dtype=jnp.float64):
    tap = jnp.asarray(tb.tap0, dtype).at[tb.oltc_branch].set(a)
    return build_ybus(
        tb.n_bus, tb.br_f, tb.br_t,
        jnp.asarray(tb.series_re, dtype), jnp.asarray(tb.series_im, dtype),
        jnp.asarray(tb.shunt_im, dtype), jnp.asarray(tb.shift_cos, dtype),
        jnp.asarray(tb.shift_sin, dtype), tap,
    )


def _delta(tb, a):
    """ΔY[t,f] = −y·e^{−jθs}·(1/a − 1/a₀)."""
    inv_da = 1.0 / a - 1.0 / tb.chord_a0
    y = tb.chord_y_re + 1j * tb.chord_y_im
    return -y * np.exp(-1j * tb.chord_shift) * inv_da


def _flat_jacobian(Yre, Yim, n):
    x0 = jnp.concatenate([jnp.zeros(n, jnp.float64), jnp.ones(n, jnp.float64)])
    _, (vr, vi, yr, yi) = _mismatch(x0, jnp.zeros(n, jnp.float64), jnp.zeros(n, jnp.float64), Yre, Yim, n)
    return np.asarray(_jacobian(vr, vi, yr, yi, Yre, Yim, n))


def test_rank2_jacobian_identity(env64):
    """J(x0, a) == J0 + U·W(a)·Eᵀ exactly, for taps across the OLTC range."""
    tb = env64.tables
    n = tb.n_bus - 1
    J0 = _flat_jacobian(*_ybus_at_tap(tb, tb.chord_a0), n)
    it = tb.chord.t_bus - 1
    rows = [it, n + it]
    for a in (0.9, 0.97, 1.03, 1.1):
        Ja = _flat_jacobian(*_ybus_at_tap(tb, a), n)
        d = _delta(tb, a)
        W = np.array([[d.imag, d.real], [d.real, -d.imag]])
        dJ = np.zeros_like(J0)
        dJ[np.ix_(rows, rows)] = W
        np.testing.assert_allclose(Ja, J0 + dJ, rtol=0, atol=1e-9)


def test_decomposed_mismatch_identity(env64):
    """V∘conj(Y0·V + δ·e_t) == V∘conj(Y(a)·V) at arbitrary states."""
    tb = env64.tables
    n = tb.n_bus - 1
    a = 0.94
    Yre, Yim = _ybus_at_tap(tb, a)
    d = _delta(tb, a)
    key = jax.random.PRNGKey(0)
    x = jnp.concatenate(
        [0.2 * jax.random.normal(key, (n,), jnp.float64),
         1.0 + 0.15 * jax.random.normal(jax.random.fold_in(key, 1), (n,), jnp.float64)]
    )
    p = 0.3 * jax.random.normal(jax.random.fold_in(key, 2), (n,), jnp.float64)
    q = 0.3 * jax.random.normal(jax.random.fold_in(key, 3), (n,), jnp.float64)
    F_true, _ = _mismatch(x, p, q, Yre, Yim, n)

    vr, vi = _assemble_v(x[:n], x[n:], jnp.float64)
    yr, yi = cmatvec(jnp.asarray(tb.chord.Y0re, jnp.float64),
                     jnp.asarray(tb.chord.Y0im, jnp.float64), vr, vi)
    yr = yr.at[tb.chord.t_bus].add(d.real)
    yi = yi.at[tb.chord.t_bus].add(d.imag)
    sr = vr * yr + vi * yi
    si = vi * yr - vr * yi
    F_dec = jnp.concatenate([sr[1:] - p, si[1:] - q])
    np.testing.assert_allclose(np.asarray(F_dec), np.asarray(F_true), rtol=0, atol=1e-10)


def test_chord_matches_nr_solution(env64):
    """chord_solve reaches the same voltages as exact NR (both stop on the
    true-mismatch residual, so solutions agree to solver tolerance)."""
    tb = env64.tables
    n = tb.n_bus - 1
    key = jax.random.PRNGKey(7)
    B = 32
    taps = jax.random.uniform(key, (B,), jnp.float64, 0.9, 1.1)
    p = 0.02 * jax.random.normal(jax.random.fold_in(key, 1), (B, n), jnp.float64)
    q = 0.02 * jax.random.normal(jax.random.fold_in(key, 2), (B, n), jnp.float64)

    def chord_v(p, q, a):
        d = -(tb.chord_y_re + 1j * tb.chord_y_im) * (1.0 / a - 1.0 / tb.chord_a0)
        x, F, diff, it, acc = chord_solve(
            p, q, jnp.imag(d), jnp.real(d), jnp.real(d), jnp.imag(d), tb.chord
        )
        return _assemble_v(x[:n], x[n:], jnp.float64), diff, acc

    def nr_v(p, q, a):
        Yre, Yim = _ybus_at_tap(tb, a)
        r = nr_solve(Yre, Yim, p, q)
        return r.v_re, r.v_im, r.stable

    (vr_c, vi_c), diff, acc = jax.vmap(chord_v)(p, q, taps)
    vr_n, vi_n, stable = jax.vmap(nr_v)(p, q, taps)
    assert bool(jnp.all(acc)), f"chord rejected lanes, diff max {float(diff.max()):.2e}"
    assert bool(jnp.all(stable))
    # Both solvers stop at ‖F‖∞ ≤ 1e-5, which bounds the voltage gap near
    # ~1e-6 (residual-to-state sensitivity), not bitwise equality.
    np.testing.assert_allclose(np.asarray(vr_c), np.asarray(vr_n), rtol=0, atol=5e-6)
    np.testing.assert_allclose(np.asarray(vi_c), np.asarray(vi_n), rtol=0, atol=5e-6)


def test_warm_start_guess_independent(env64):
    """Chained f32 warm starts reach the same solutions as flat-start f64,
    and poisoned (non-finite) guesses fall back to flat start."""
    env32 = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    B = 32
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    s32, _ = jax.jit(jax.vmap(env32.reset))(keys)
    s64, _ = jax.jit(jax.vmap(env64.reset))(keys)
    step32 = jax.jit(jax.vmap(env32.step))
    step64 = jax.jit(jax.vmap(env64.step))
    key = jax.random.PRNGKey(2)
    for _ in range(4):
        key, k = jax.random.split(key)
        a = env32.action_low + jax.random.uniform(
            k, (B, env32.n_action)) * (env32.action_high - env32.action_low)
        s32, *_ = step32(s32, a)
        s64, *_ = step64(s64, a.astype(jnp.float64))
        np.testing.assert_allclose(np.asarray(s32.bus_vm),
                                   np.asarray(s64.bus_vm, np.float32),
                                   rtol=0, atol=5e-5)

    poisoned = s32._replace(
        v_guess=s32.v_guess.at[0].set(jnp.nan).at[1, :5].set(jnp.inf))
    a = jnp.broadcast_to((env32.action_low + env32.action_high) / 2,
                         (B, env32.n_action))
    _, obs, _, done, info = step32(poisoned, a)
    assert float(info["diff"][:2].max()) <= 1e-4
    assert not bool(done[:2].any())
    assert bool(jnp.isfinite(obs).all())


def _assert_acceptance_total(batch=8192):
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    for seed, (n_unaccepted, max_diff) in enumerate(chip_smoke.chord_acceptance(batch)):
        assert n_unaccepted == 0, (
            f"seed {seed}: {n_unaccepted}/{batch} lanes unaccepted — each one "
            "forces the batch-wide NR fallback")
        assert max_diff <= 1e-4


def test_chord_acceptance_rate_is_total():
    """Under the bench-like action distribution (random caps in [0,1] p.u.,
    random taps in [0.9,1.1], B=8192), EVERY lane's chord exit must be
    accepted.  This guards the solver's worst performance cliff: under
    vmap, a single unaccepted lane drags the whole batch through the
    exact-NR fallback body every step — exactly what an unsafeguarded
    acceleration tweak caused once."""
    _assert_acceptance_total()


@pytest.mark.gpu
def test_chord_acceptance_rate_is_total_on_gpu(gpu):
    """The same guard under the GPU's default matmul precision (TF32 for
    the chord update's default-precision dots), which the CPU cannot
    show; chip_smoke.py phase b runs this check on the card."""
    _assert_acceptance_total()


def test_chord_divergence_recovers_via_fallback(env64):
    """A chord phase that overflows to non-finite values, or wanders to an
    iterate worse than the flat start, must NOT block the exact-NR fallback
    (NaN makes `diff > xtol` False) — the sanitized exit resets such lanes
    to the flat start so the fallback converges where flat-start Newton
    would.  Regression for a false-network-collapse failure mode."""
    from gym_anm_tpu.physics.power_flow import nr_solve_lazy
    from gym_anm_tpu.physics.ybus import build_ybus

    env32 = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    tb = env32.tables
    n = tb.n_bus - 1
    z = jnp.zeros((), jnp.float32)

    def ybus32():
        return build_ybus(
            tb.n_bus, tb.br_f, tb.br_t,
            jnp.asarray(tb.series_re), jnp.asarray(tb.series_im),
            jnp.asarray(tb.shunt_im), jnp.asarray(tb.shift_cos),
            jnp.asarray(tb.shift_sin), jnp.asarray(tb.tap0),
        )

    # Overflow case: absurd injections drive the chord iterate to inf/NaN
    # inside the stall window; the exit must still be finite.
    p_huge = -jnp.ones(n, jnp.float32) * 1e12
    x, F, diff, it, acc = chord_solve(p_huge, p_huge, z, z, z, z, tb.chord)
    assert bool(jnp.all(jnp.isfinite(x))) and bool(jnp.isfinite(diff))
    assert not bool(acc)

    # Bad-basin cases: benign injections + finite-but-terrible warm starts.
    # Exact NR from flat start converges in ~3 iterations here; the chord
    # exit must not strand the fallback in the bad basin.
    p = -jnp.ones(n, jnp.float32) * 0.01
    q = p * 0.5
    bad_guesses = [
        jnp.concatenate([jnp.zeros(n), jnp.full((n,), 1e-6)]),   # vm ~ 0
        jnp.concatenate([jnp.zeros(n), jnp.full((n,), -1.0)]),   # vm < 0
        jnp.concatenate([jnp.full((n,), 30.0), jnp.ones(n)]),    # wild angles
        jnp.concatenate([jnp.zeros(n), jnp.full((n,), 1e15)]),   # vm overflow
    ]
    for x0 in bad_guesses:
        init = chord_solve(p, q, z, z, z, z, tb.chord, x0=x0.astype(jnp.float32))
        r = nr_solve_lazy(ybus32, p, q, init=init)
        assert bool(r.stable), f"fallback failed from guess, diff={float(r.diff):.2e}"
        assert float(r.diff) <= 1e-4


@pytest.mark.parametrize("task_name", ["renewable", "multicap", "anm6easy"])
def test_f32_solver_health_across_tasks(task_name):
    """The f32 fast path stays within the acceptance residual and produces
    finite physics on every shipped task family.

    (A direct f32-vs-f64 trajectory comparison is only valid for
    deterministic tasks — stochastic next_vars hooks draw jax.random noise
    in their own dtype, so the tiers legitimately see different loads.
    Deterministic cross-checks live in test_warm_start_guess_independent.)
    """
    from gym_anm_tpu.vec import (
        make_anm6easy_task,
        make_ieee33_multicap_task,
        make_ieee33_renewable_task,
    )

    task = {"renewable": make_ieee33_renewable_task,
            "multicap": make_ieee33_multicap_task,
            "anm6easy": make_anm6easy_task}[task_name]()
    env = VecEnv(task, dtype=jnp.float32)
    B = 32
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    a = jnp.broadcast_to((env.action_low + env.action_high) / 2, (B, env.n_action))
    step = jax.jit(jax.vmap(env.step))
    for _ in range(4):
        state, obs, r, done, info = step(state, a)
        live = ~np.asarray(done)
        assert live.any()
        assert np.asarray(info["diff"])[live].max() <= 1e-4
        assert np.isfinite(np.asarray(obs)).all()
        assert np.isfinite(np.asarray(r)).all()
        vm = np.asarray(state.bus_vm)[live]
        assert (vm > 0.5).all() and (vm < 1.5).all()


def test_f32_step_matches_f64(env64):
    """The f32 step (chord path) agrees with the f64 step (exact NR) on
    rewards and voltages to f32 solver tolerance."""
    env32 = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    B = 64
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    s32, _ = jax.jit(jax.vmap(env32.reset))(keys)
    s64, _ = jax.jit(jax.vmap(env64.reset))(keys)
    acts = env32.action_low + jax.random.uniform(
        jax.random.PRNGKey(1), (B, env32.n_action), jnp.float32
    ) * (env32.action_high - env32.action_low)

    _, _, r32, d32, _ = jax.jit(jax.vmap(env32.step))(s32, acts)
    _, _, r64, d64, _ = jax.jit(jax.vmap(env64.step))(s64, acts.astype(jnp.float64))
    assert not bool(d32.any()) and not bool(d64.any())
    np.testing.assert_allclose(np.asarray(r32), np.asarray(r64), rtol=2e-3, atol=2e-4)


def test_warm_started_worst_lane_iteration_budget():
    """The in-band one-non-improving-iteration plateau exit keeps the
    warm-started worst-lane chord iteration count at <=10 on the bench
    action distribution (it was ~11.4 with the two-iteration exit; see
    docs/performance.md).  A regression here directly costs batch
    throughput: under vmap every lane runs until the worst lane stops."""
    env = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    B = 1024
    lo, hi = env.action_low, env.action_high
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    step = jax.jit(lambda st, a: jax.vmap(env.step)(st, a))
    k = jax.random.PRNGKey(8)
    worst = []
    for t in range(12):
        k, ka = jax.random.split(k)
        acts = lo + jax.random.uniform(ka, (B, env.n_action), dtype=env.dtype) * (hi - lo)
        state, obs, r, d, info = step(state, acts)
        diff = np.asarray(info["diff"])
        assert (diff <= 1e-4).all()
        worst.append(int(np.asarray(info["n_iter"]).max()))
    # skip the first two steps (reset transient); warm-started steady state
    assert max(worst[2:]) <= 10, worst


def _bench_like_problem(tb, B, seed=0, warm_noise=True):
    """Bench-distribution chord inputs + a noisy warm start (the warm start
    makes per-lane iteration counts spread out, which is what exercises the
    masked-lane/compaction machinery)."""
    n = tb.n_bus - 1
    key = jax.random.PRNGKey(seed)
    qc = jax.random.uniform(key, (B, 2), jnp.float32)
    taps = jax.random.uniform(jax.random.fold_in(key, 1), (B,), jnp.float32, 0.9, 1.1)
    q_ns = jnp.zeros((B, n), jnp.float32).at[:, 7].set(qc[:, 0]).at[:, 24].set(qc[:, 1])
    p_ns = jnp.zeros((B, n), jnp.float32)
    inv_da = 1.0 / taps - 1.0 / tb.chord_a0
    dtf_re = -(tb.chord_y_re) * inv_da
    dtf_im = -(tb.chord_y_im) * inv_da
    x0 = jnp.concatenate([jnp.zeros((B, n)), jnp.ones((B, n))], axis=1).astype(jnp.float32)
    if warm_noise:
        x0 = x0 + 0.01 * jax.random.normal(jax.random.fold_in(key, 2), x0.shape, jnp.float32)
        x0 = x0.at[3].set(jnp.nan)  # non-finite guess lane: must reset to flat
    return p_ns, q_ns, dtf_im, dtf_re, dtf_re, dtf_im, x0


def test_chord_warm_start_batch_contract():
    """vmap(chord_solve) on a bench-like warm-start distribution (noisy
    warm starts spread per-lane iteration counts; one lane has a NaN
    guess and must reset to the flat start): acceptance total, every
    lane at/below the plateau bound, and the straggler spread the
    batched while loop has to mask through actually exists."""
    tb = VecEnv(make_ieee33_task(), dtype=jnp.float32).tables
    B = 2048
    args = _bench_like_problem(tb, B)

    def lane(p, q, wa, wb, dr, di, x):
        return chord_solve(p, q, wa, wb, dr, di, tb.chord, x0=x)

    x, F, diff, it, acc = jax.jit(jax.vmap(lane))(*args)
    assert int(jnp.sum(~acc)) == 0
    assert float(jnp.max(diff)) <= 1e-4
    assert bool(jnp.all(jnp.isfinite(x))), "NaN-guess lane did not reset"
    assert int(jnp.max(it)) > int(jnp.median(it)), "no straggler spread"
