"""Smoke test of the main path on the GPU: the benchmark's programs at the
batch sizes the benchmark runs, checked, and compared with the same
programs on JAX's CPU backend in the same process.

One process drives the card; there is no fallback: without a GPU the
script exits non-zero before any phase.  Phases (one card, the default):

a. The four ``bench.py`` programs, built as ``bench.py`` builds them:
   base IEEE33 (128-step scan) at B=8192 (compiled with the persistent
   compile cache disabled) and B=32768, multicap-17 with autoreset, the
   L0-L5 block collector (64 steps) and the ANM6Easy MPC farm (64 steps),
   all at B=8192, plus ``__graft_entry__.entry()``.  Every lane finite;
   lanes still live after one more step solved to ``diff <= 1e-4``; MPC
   actions finite and mean reward per step above -5 (the informed-
   controller level).
b. Chord acceptance under the card's default matmul precision: B=8192,
   3 seeds, no unaccepted lane (``chord_acceptance``; the same check at
   ``Precision.HIGHEST`` is printed beside it).
c. Each program at B=512 for 16 steps on the card and on the CPU (same
   keys, same host-drawn actions, float32), compared by
   ``compare_trajectories``: identical ``done``; |Δ|V|| <= 1e-4 p.u. on
   every live lane; each step's lane-mean reward within 2e-4 + 1e-3
   relative; each lane's reward within that bar plus what its own
   voltage and set-point gaps can move it (``tolerances_for``), and at
   most 1% of lane-steps outside the bar alone; the dataset's
   observations per lane.  Then the f32 exact-NR
   fallback (``nr_solve`` under vmap from flat start, B=8192) and the f64
   ``nr_solve`` on the card against the pure-numpy ``numpy_nr_solve``:
   |ΔV| <= 1e-4 (f32) and <= 1e-8 (f64).

With ``--four`` (four cards) it runs only the multi-card path:
``__graft_entry__.dryrun_multichip(4)`` and the base IEEE33 farm at
B=4x8192 sharded by ``parallel.make_env_mesh``, compared lane for lane
with the same farm on one card.

Prints the card's name and power limit, the compile-cache directory and
each program's compile and run wall times; the last line is one JSON
object ``{"ok": true, "device": {"platform", "kind", "count"}}``.

Usage: python chip_smoke.py [--four]
"""

import contextlib
import json
import os
import sys
import time
import traceback
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

import bench
import gym_anm_tpu  # noqa: F401 — sets x64 and the compile cache before any compile

LIVE_DIFF_TOL = 1e-4       # f32 plateau acceptance: 10·xtol
# Card vs CPU.  Each backend's solve stops at a residual of at most 1e-4
# p.u. (plateau acceptance), which bounds the voltage gap near 1e-4 p.u.
V_TOL = 1e-4
# Reward: f32 rounding of the reward's own sums.  A lane's reward may
# also move by what its voltage gap moves the branch-flow penalty
# (``tolerances_for``); that is the bar per lane.  The bar alone may fail
# on a few lanes: the f32 tier against the f64 tier on the CPU, for the
# ieee33 program as compared here, has 22 of 8192 lane-steps outside it
# (scripts/f32_tier_witness.py), so at most 1% may be.
REWARD_ATOL = 2e-4
REWARD_RTOL = 1e-3
REWARD_OUTLIER_SHARE = 0.01
# Observations other than the slack injection follow from the same inputs
# by elementwise f32 arithmetic: a few ulps.
OBS_ATOL = 1e-5            # MW, MVAr, MWh
OBS_RTOL = 1e-5
NR_V_TOL = {np.float32: 1e-4, np.float64: 1e-8}  # |ΔV| vs numpy_nr_solve


class Smoke:
    """Collects PASS/FAIL lines; a fault in one phase does not hide the
    results of the others."""

    def __init__(self):
        self.failures = []

    def check(self, name, ok, detail=""):
        print(f"{'PASS' if ok else 'FAIL'}  {name}  {detail}", flush=True)
        if not ok:
            self.failures.append(name)
        return bool(ok)

    @contextlib.contextmanager
    def phase(self, name):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            yield
        except Exception as e:  # noqa: BLE001 — report, run the other phases
            traceback.print_exc()
            self.check(f"phase {name} raised", False, f"{type(e).__name__}: {e}")
        print(f"== phase {name}: {time.perf_counter() - t0:.1f} s wall", flush=True)


@contextlib.contextmanager
def compile_cache_disabled():
    """Compile without reading or writing the persistent cache, so the
    program is compiled by this process's compiler whatever the cache
    holds."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
        cc.reset_cache()


def compile_and_run(label, jitted, *args, cold=False):
    """AOT-compile ``jitted`` for ``args``, run it once to completion, and
    print both wall times.  Returns the outputs."""
    t0 = time.perf_counter()
    with compile_cache_disabled() if cold else contextlib.nullcontext():
        compiled = jitted.lower(*args).compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t_run = time.perf_counter() - t0
    print(f"   {label}: compile {t_compile:.1f} s"
          f"{' (cache disabled)' if cold else ''}, run {t_run:.3f} s", flush=True)
    return out


def _all_finite(tree):
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax.device_get(tree))]
    return all(bool(np.isfinite(x).all()) for x in leaves
               if np.issubdtype(x.dtype, np.floating))


def _uniform_actions(env, key, batch):
    lo, hi = env.action_low, env.action_high
    return lo + jax.random.uniform(key, (batch, env.n_action), dtype=env.dtype) * (hi - lo)


def check_step_health(smoke, name, actions, obs, reward, done, info):
    """Finite outputs; every lane that did not terminate solved to
    ``LIVE_DIFF_TOL``.  Prints worst-lane and mean solver iterations."""
    done = np.asarray(done)
    diff = np.asarray(info["diff"])
    n_iter = np.asarray(info["n_iter"])
    live = ~done
    live_diff = float(diff[live].max()) if live.any() else 0.0
    smoke.check(
        f"{name}: step health",
        _all_finite((actions, obs, reward)) and live_diff <= LIVE_DIFF_TOL,
        f"done={int(done.sum())}/{done.size} live max diff={live_diff:.2e} "
        f"n_iter worst={int(n_iter.max())} mean={float(n_iter.mean()):.2f}")


# ---------------------------------------------------------------------------
# Phase a: the bench programs at bench sizes.
# ---------------------------------------------------------------------------

def random_farm_program(smoke, name, env, batch, autoreset, cold=False):
    run_jit, state, obs = bench.make_random_run(env, batch, 128, autoreset)
    state, obs, total = compile_and_run(f"{name} B={batch}", run_jit, state, obs, 0, cold=cold)
    smoke.check(f"{name} B={batch}: finite state after 128 steps",
                _all_finite((state, obs, total)))
    step = env.step_autoreset_batch if autoreset else jax.vmap(env.step)
    acts = _uniform_actions(env, jax.random.PRNGKey(99), batch)
    _, obs, r, d, info = jax.jit(step)(state, acts)
    check_step_health(smoke, f"{name} B={batch}", acts, obs, r, d, info)


def phase_programs(smoke, batch=8192, big_batch=32768):
    from gym_anm_tpu.offline_vec import make_block_collector
    from gym_anm_tpu.vec import VecEnv, make_ieee33_multicap_task, make_ieee33_task
    from gym_anm_tpu.vec.controllers import make_suite

    import __graft_entry__

    env = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    env_mc = VecEnv(make_ieee33_multicap_task(), dtype=jnp.float32)
    random_farm_program(smoke, "ieee33", env, batch, autoreset=False, cold=True)
    random_farm_program(smoke, "ieee33", env, big_batch, autoreset=False)
    random_farm_program(smoke, "multicap17", env_mc, batch, autoreset=True)

    collect, _ = make_block_collector(env_mc, make_suite(env_mc), batch, 64)
    traj = compile_and_run(f"l0l5 dataset B={batch}", collect, jax.random.PRNGKey(0))
    done = np.asarray(traj[4])
    smoke.check(f"l0l5 dataset B={batch}: finite trajectories", _all_finite(traj[:4]),
                f"done={int(done.sum())}/{done.size} lane-steps")

    run_jit, step, state, obs, carry = bench.make_mpc_run(batch, 64)
    state, obs, carry, total = compile_and_run(
        f"mpc farm B={batch}", run_jit, state, obs, carry, 0)
    mean_r = float(total) / (batch * 64)
    smoke.check(f"mpc farm B={batch}: reward per step at the informed level",
                np.isfinite(mean_r) and mean_r > -5.0, f"mean reward/step={mean_r:.4f}")
    _, obs, _, a, r, d, info = jax.jit(step)(state, obs, carry, jax.random.PRNGKey(99))
    check_step_health(smoke, f"mpc farm B={batch}", a, obs, r, d, info)

    fn, args = __graft_entry__.entry()
    out = compile_and_run("__graft_entry__.entry()", jax.jit(fn), *args)
    smoke.check("__graft_entry__.entry(): finite", _all_finite(out))


# ---------------------------------------------------------------------------
# Phase b: chord acceptance.
# ---------------------------------------------------------------------------

def chord_acceptance(batch=8192, seeds=(0, 1, 2)):
    """Per seed, ``(unaccepted lanes, max diff)`` of the f32 chord solve
    on IEEE33 under the bench-like distribution: random capacitor
    set-points in [0, 1] p.u., random taps in [0.9, 1.1].

    Under vmap one unaccepted lane makes the whole batch run the exact-NR
    fallback body every step, so acceptance must be total.  The products
    run at whatever matmul precision is in force."""
    from gym_anm_tpu.physics.power_flow import chord_solve
    from gym_anm_tpu.vec import VecEnv, make_ieee33_task

    tb = VecEnv(make_ieee33_task(), dtype=jnp.float32).tables
    n = tb.n_bus - 1

    def lane(p, q, a):
        inv_da = 1.0 / a - 1.0 / tb.chord_a0
        dtf_re = -(tb.chord_y_re) * inv_da
        dtf_im = -(tb.chord_y_im) * inv_da
        return chord_solve(p, q, dtf_im, dtf_re, dtf_re, dtf_im, tb.chord)

    solve = jax.jit(jax.vmap(lane))
    results = []
    for seed in seeds:
        key = jax.random.PRNGKey(seed)
        qc = jax.random.uniform(key, (batch, 2), jnp.float32)
        taps = jax.random.uniform(jax.random.fold_in(key, 1), (batch,), jnp.float32, 0.9, 1.1)
        q_ns = jnp.zeros((batch, n), jnp.float32).at[:, 7].set(qc[:, 0]).at[:, 24].set(qc[:, 1])
        p_ns = jnp.zeros((batch, n), jnp.float32)
        _x, _F, diff, _it, acc = solve(p_ns, q_ns, taps)
        results.append((int(jnp.sum(~acc)), float(jnp.max(diff))))
    return results


def phase_acceptance(smoke, batch=8192):
    for label in ("default", "highest"):
        with (contextlib.nullcontext() if label == "default"
              else jax.default_matmul_precision("highest")):
            results = chord_acceptance(batch)
        for seed, (n_unacc, max_diff) in enumerate(results):
            detail = f"unaccepted={n_unacc}/{batch} max diff={max_diff:.2e}"
            if label == "default":
                smoke.check(f"chord acceptance, default precision (seed {seed})",
                            n_unacc == 0 and max_diff <= LIVE_DIFF_TOL, detail)
            else:
                print(f"INFO  chord acceptance, HIGHEST precision (seed {seed})  {detail}")


# ---------------------------------------------------------------------------
# Phase c: card vs CPU, and the NR solves vs the pure-numpy solver.
# ---------------------------------------------------------------------------

def _random_farm_trajectory(env, autoreset, batch, n_steps, seed=0):
    """(fn, args): reset from ``farm_keys(seed)`` then ``n_steps`` steps
    under host-drawn uniform actions; returns per-step ``v`` (the state's
    [θ, |V|] solution), ``reward`` and ``done``."""
    from gym_anm_tpu.vec import farm_keys

    step = env.step_autoreset_batch if autoreset else jax.vmap(env.step)
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(env.action_low), np.asarray(env.action_high)
    actions = (lo + rng.uniform(size=(n_steps, batch, env.n_action)) * (hi - lo)).astype(np.float32)

    def run(keys, actions):
        state, _ = jax.vmap(env.reset)(keys)

        def body(st, a):
            st, _, r, d, _ = step(st, a)
            return st, {"v": st.v_guess, "reward": r, "done": d}

        return jax.lax.scan(body, state, actions)[1]

    return run, (np.asarray(farm_keys(seed, batch)), actions)


def _mpc_trajectory(batch, n_steps, dtype=jnp.float32):
    """(fn, args): ``n_steps`` of the bench MPC farm step from its initial
    state; returns per-step ``v``, ``reward``, ``done`` and ``action``."""
    _run_jit, step, state, obs, carry = bench.make_mpc_run(batch, n_steps, dtype)

    def run(state, obs, carry, key):
        def body(sc, t):
            st, obs, carry, a, r, d, _ = step(*sc, jax.random.fold_in(key, t))
            return (st, obs, carry), {"v": st.v_guess, "reward": r, "done": d, "action": a}

        return jax.lax.scan(body, (state, obs, carry), jnp.arange(n_steps))[1]

    return run, jax.device_get((state, obs, carry, jax.random.PRNGKey(7)))


def _dataset_trajectory(env, batch, n_steps):
    """(fn, args): the bench L0-L5 block collector; returns its dataset
    (``obs``, ``action``, ``reward``, ``next_obs``, ``done``)."""
    from gym_anm_tpu.offline_vec import make_block_collector
    from gym_anm_tpu.vec.controllers import make_suite

    collect, _ = make_block_collector(env, make_suite(env), batch, n_steps)

    def run(key):
        return dict(zip(("obs", "action", "reward", "next_obs", "done"), collect(key)))

    return run, (np.asarray(jax.random.PRNGKey(3)),)


def run_on(device, fn, args):
    """Run ``jax.jit(fn)(*args)`` on ``device`` and return host arrays."""
    with jax.default_device(device):
        out = jax.jit(fn)(*jax.device_put(args, device))
        return jax.device_get(jax.block_until_ready(out))


class Tolerances(NamedTuple):
    """Per-lane limits of one program's card-vs-reference comparison."""

    k_v: float            # |Δr| per p.u. of δ: slack injection, bus bands
    k_v_branch: float     # |Δr| per p.u. of δ and of v_max: branch flows
    k_action: np.ndarray  # |Δr| per MW or MVAr of |Δa|, per action column
    obs_atol: np.ndarray  # |Δobs| per observation column (MW, MVAr, MWh)


def tolerances_for(env):
    """The limits for ``env``, derived from its network and its reward
    (transition.py step 10: r = −δt·(e_loss + λ·penalty), each term
    1-Lipschitz through max(0, ·) and the cost clipping).

    With δ the largest |ΔV| over a lane's buses (complex, p.u.) and v_max
    its largest |V|:
    - the slack injection P_sl = Re(conj(Σ_j Y_0j·V_j)) moves by at most
      Σ_j |Y_0j|·δ, bounded by the branches at the slack bus;
    - each bus-band excess moves by at most δ;
    - each branch's |S| = |V_f·conj(A·V_f − B·V_t)| (A = (y+y_sh)/a² or
      y+y_sh, B = y/a) moves by at most 2·v_max·(|A|+|B|)·δ;
    - a generator's projected p_g moves by at most |ΔP|+|ΔQ| of its
      set-points (the projection is non-expansive), and enters e_loss
      twice (injection and curtailment).
    Tap set-points are equal on both sides in every program compared.
    Observations ("state" observations: device P and Q, SoC, potentials,
    aux) move by the slack injection's bound at ``V_TOL`` in the slack
    device's columns, and by ``OBS_ATOL`` elsewhere."""
    tb = env.tables
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    y = np.abs(f64(tb.series_re) + 1j * f64(tb.series_im))
    y_tot = np.abs(f64(tb.series_re) + 1j * (f64(tb.series_im) + f64(tb.shunt_im)))
    a_min = float(np.min(np.concatenate([f64(tb.tap0).ravel(), f64(tb.oltc_tap_min).ravel()])))
    per_branch = y_tot * max(1.0, 1.0 / a_min**2) + y / a_min   # |A| + |B|
    at_slack = (np.asarray(tb.br_f) == tb.slack_bus) | (np.asarray(tb.br_t) == tb.slack_bus)
    y_slack = float(per_branch[at_slack].sum())

    k_action = np.zeros(env.n_action)
    k_action[:2 * env.spec.n_gen] = 2.0 * tb.delta_t / tb.baseMVA  # [P_gen, Q_gen, ...]
    obs_atol = np.full(env.n_obs, OBS_ATOL)
    if env.n_obs == env.n_state:  # "state" observations
        for col in (tb.slack_dev, tb.n_dev + tb.slack_dev):
            obs_atol[col] += tb.baseMVA * y_slack * V_TOL
    return Tolerances(
        k_v=tb.delta_t * (y_slack + tb.lamb * (tb.n_bus - 1)),
        k_v_branch=tb.delta_t * tb.lamb * 2.0 * float(per_branch.sum()),
        k_action=k_action, obs_atol=obs_atol)


def _voltages(v_guess):
    """Complex non-slack bus voltages from the state's [θ.., |V|..]."""
    v = np.asarray(v_guess, np.float64)
    n = v.shape[-1] // 2
    return v[..., n:] * np.exp(1j * v[..., :n])


def compare_trajectories(card, ref, tol):
    """Compare one program's per-step outputs on the card with the same
    program's on the reference backend.  Each side is a dict of [T, B, ...]
    arrays: ``reward`` and ``done``, and where the program yields them
    ``v`` (the state's [θ, |V|] solution), ``action``, ``obs`` and
    ``next_obs``.

    Returns ``(ok, detail)``.  Checked:
    - ``done`` identical;
    - |Δ|V|| <= ``V_TOL`` on every lane live on both sides;
    - each step's lane-mean reward within ``REWARD_ATOL`` +
      ``REWARD_RTOL``·|mean|;
    - where the program yields voltages, each live lane's reward within
      that bar plus what the lane's own voltage and generator set-point
      gaps can move it (``tol``, from ``tolerances_for``);
    - at most ``REWARD_OUTLIER_SHARE`` of live lane-steps outside the bar
      alone;
    - each observation within ``tol.obs_atol`` + ``OBS_RTOL``·|obs|.
    Actions are reported: a controller may act discontinuously on its
    inputs, so no bound on them follows from the voltages."""
    checks, detail = {}, []
    d_c, d_r = np.asarray(card["done"]), np.asarray(ref["done"])
    checks["done identical"] = np.array_equal(d_c, d_r)
    live = ~(d_c | d_r)
    n_live = int(live.sum())

    r_c, r_r = np.asarray(card["reward"], np.float64), np.asarray(ref["reward"], np.float64)
    dr = np.abs(r_c - r_r)
    bar = REWARD_ATOL + REWARD_RTOL * np.abs(r_r)
    m_c, m_r = r_c.mean(axis=-1), r_r.mean(axis=-1)
    checks["step-mean reward"] = bool(np.all(
        np.abs(m_c - m_r) <= REWARD_ATOL + REWARD_RTOL * np.abs(m_r)))
    n_out = int((live & ~(dr <= bar)).sum())
    checks["lanes outside the reward bar"] = n_out <= REWARD_OUTLIER_SHARE * n_live
    detail.append(f"reward: max|dr|={float(np.max(dr, initial=0.0, where=live)):.2e},"
                  f" {n_out}/{n_live} lane-steps outside {REWARD_ATOL:g}+{REWARD_RTOL:g}|r|")

    if "v" in ref:
        v_c, v_r = _voltages(card["v"]), _voltages(ref["v"])
        # |V| is held to V_TOL.  The complex gap also carries the angle,
        # which in the MPC's closed loop drifts with the action gap; it
        # scales the reward bound.
        dvm = np.abs(np.abs(v_c) - np.abs(v_r)).max(axis=-1)
        delta = np.abs(v_c - v_r).max(axis=-1)
        v_max = np.maximum(np.maximum(np.abs(v_c).max(axis=-1), np.abs(v_r).max(axis=-1)), 1.0)
        checks["|dV|"] = not (live & ~(dvm <= V_TOL)).any()
        allow = bar + (tol.k_v + tol.k_v_branch * v_max) * delta
        if "action" in ref:
            da = np.abs(np.asarray(card["action"], np.float64) - np.asarray(ref["action"], np.float64))
            allow = allow + (da * tol.k_action).sum(axis=-1)
        checks["per-lane reward"] = not (live & ~(dr <= allow)).any()
        worst = float(np.max(dr / allow, initial=0.0, where=live))
        detail.append(f"|dV| max={float(np.max(dvm, initial=0.0, where=live)):.2e}"
                      f" (complex {float(np.max(delta, initial=0.0, where=live)):.2e}),"
                      f" per-lane |dr|/bound max={worst:.2e}")

    for key in ("obs", "next_obs"):
        if key in ref:
            o_c, o_r = np.asarray(card[key], np.float64), np.asarray(ref[key], np.float64)
            d = np.abs(o_c - o_r)
            checks[key] = not (~(d <= tol.obs_atol + OBS_RTOL * np.abs(o_r))).any()
            detail.append(f"{key} max|d|={float(d.max()):.2e}")
    if "action" in ref:
        da = np.abs(np.asarray(card["action"], np.float64) - np.asarray(ref["action"], np.float64))
        detail.append(f"action max|d|={float(da.max()):.2e}")

    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        detail.append("FAILED: " + ", ".join(failed))
    return not failed, "; ".join(detail)


def nr_reference_problems(batch, seed=0):
    """IEEE33 at nominal taps and per-bus loads of U(0, 2)× the nominal
    case33bw loads: ``(Y [N, N] complex, p [B, n], q [B, n])`` in p.u."""
    from gym_anm_tpu.networks import ieee33_network
    from gym_anm_tpu.physics import build_ybus
    from gym_anm_tpu.specs.network import load_network

    spec = load_network(ieee33_network)
    series = 1.0 / (spec.br_r + 1j * spec.br_x)
    Yre, Yim = build_ybus(
        spec.n_bus, spec.br_f, spec.br_t,
        jnp.asarray(series.real), jnp.asarray(series.imag), jnp.asarray(spec.br_b / 2),
        jnp.asarray(np.cos(spec.br_shift)), jnp.asarray(np.sin(spec.br_shift)),
        jnp.asarray(spec.br_tap0, jnp.float64))
    Y = np.asarray(Yre) + 1j * np.asarray(Yim)
    p_nom = np.zeros(spec.n_bus)
    q_nom = np.zeros(spec.n_bus)
    for d in spec.load_pos:
        p_nom[int(spec.dev_bus[d])] += spec.p_min[d]
        q_nom[int(spec.dev_bus[d])] += spec.p_min[d] * spec.qp_ratio[d]
    scale = np.random.default_rng(seed).uniform(0.0, 2.0, (batch, spec.n_bus - 1))
    return Y, p_nom[1:] * scale, q_nom[1:] * scale


def numpy_reference_voltages(Y, p, q):
    """Complex bus voltages [B, N] of ``numpy_nr_solve`` (pure numpy f64,
    solved to 1e-10), lane by lane."""
    from gym_anm_tpu.physics.power_flow import numpy_nr_solve

    n = Y.shape[0] - 1
    out = np.empty((p.shape[0], n + 1), complex)
    for i in range(p.shape[0]):
        x = numpy_nr_solve(Y, p[i], q[i])
        out[i] = np.concatenate([[1.0 + 0.0j], x[n:] * np.exp(1j * x[:n])])
    return out


def nr_solve_max_dv(Y, p, q, dtype, v_ref, xtol=1e-5):
    """Largest |V − v_ref| over lanes and buses of ``nr_solve`` under vmap
    from flat start at ``dtype``, and the number of lanes it did not
    report stable."""
    from gym_anm_tpu.physics.power_flow import nr_solve

    Yre, Yim = jnp.asarray(Y.real, dtype), jnp.asarray(Y.imag, dtype)
    res = jax.jit(jax.vmap(lambda pp, qq: nr_solve(Yre, Yim, pp, qq, xtol=xtol)))(
        jnp.asarray(p, dtype), jnp.asarray(q, dtype))
    v = np.asarray(res.v_re, np.float64) + 1j * np.asarray(res.v_im, np.float64)
    return float(np.abs(v - v_ref).max()), int((~np.asarray(res.stable)).sum())


def phase_reference(smoke, batch=512, n_steps=16, nr_batch=8192):
    from gym_anm_tpu.vec import (VecEnv, make_anm6easy_task, make_ieee33_multicap_task,
                                 make_ieee33_task)

    card, cpu = jax.devices()[0], jax.devices("cpu")[0]
    env = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    env_mc = VecEnv(make_ieee33_multicap_task(), dtype=jnp.float32)
    env_mpc = VecEnv(make_anm6easy_task(), dtype=jnp.float32)  # bench.make_mpc_run's
    programs = (
        ("ieee33", env, lambda: _random_farm_trajectory(env, False, batch, n_steps)),
        ("multicap17", env_mc, lambda: _random_farm_trajectory(env_mc, True, batch, n_steps)),
        ("l0l5 dataset", env_mc, lambda: _dataset_trajectory(env_mc, batch, n_steps)),
        ("mpc farm", env_mpc, lambda: _mpc_trajectory(batch, n_steps)),
    )
    for name, program_env, build in programs:
        fn, args = build()
        out_card, out_cpu = run_on(card, fn, args), run_on(cpu, fn, args)
        ok, detail = compare_trajectories(out_card, out_cpu, tolerances_for(program_env))
        smoke.check(f"{name} B={batch} x {n_steps} steps: card vs CPU", ok, detail)

    Y, p, q = nr_reference_problems(nr_batch)
    t0 = time.perf_counter()
    v_ref = numpy_reference_voltages(Y, p, q)
    print(f"   numpy_nr_solve reference, {nr_batch} lanes: {time.perf_counter() - t0:.1f} s")
    for dtype, xtol in ((np.float32, 1e-5), (np.float64, 1e-10)):
        max_dv, n_unstable = nr_solve_max_dv(Y, p, q, dtype, v_ref, xtol=xtol)
        smoke.check(
            f"nr_solve {np.dtype(dtype).name} B={nr_batch} vs numpy_nr_solve",
            max_dv <= NR_V_TOL[dtype] and n_unstable == 0,
            f"|dV| max={max_dv:.2e} unstable lanes={n_unstable}")


# ---------------------------------------------------------------------------
# Phase d (--four): the sharded farm.
# ---------------------------------------------------------------------------

def phase_four(smoke, n_cards=4, batch_per_card=8192):
    import __graft_entry__
    from gym_anm_tpu.parallel import env_sharding, make_env_mesh, shard_env_state
    from gym_anm_tpu.vec import VecEnv, make_ieee33_task

    with smoke.phase(f"d1 dryrun_multichip({n_cards})"):
        t0 = time.perf_counter()
        __graft_entry__.dryrun_multichip(n_cards)
        smoke.check(f"dryrun_multichip({n_cards}): {n_cards} cards agree with one",
                    True, f"{time.perf_counter() - t0:.1f} s")

    with smoke.phase(f"d2 ieee33 farm B={n_cards}x{batch_per_card}, sharded vs one card"):
        batch = n_cards * batch_per_card
        env = VecEnv(make_ieee33_task(), dtype=jnp.float32)
        run_jit, state, obs = bench.make_random_run(env, batch, 128, autoreset=False)
        mesh = make_env_mesh(jax.devices()[:n_cards])
        sharded = compile_and_run(
            f"ieee33 B={batch} on {n_cards} cards", run_jit,
            shard_env_state(state, mesh), jax.device_put(obs, env_sharding(mesh)), 0)
        one = jax.devices()[0]
        single = compile_and_run(
            f"ieee33 B={batch} on one card", run_jit,
            jax.device_put(state, one), jax.device_put(obs, one), 0)
        (st_n, obs_n, tot_n), (st_1, obs_1, tot_1) = jax.device_get((sharded, single))
        dv = float(np.abs(np.asarray(st_n.bus_vm, np.float64) - st_1.bus_vm).max())
        dobs = float(np.abs(np.asarray(obs_n, np.float64) - obs_1).max())
        rel = abs(float(tot_n) - float(tot_1)) / max(abs(float(tot_1)), 1e-3)
        smoke.check(
            f"ieee33 B={batch}: {n_cards} cards agree lane for lane with one",
            _all_finite((st_n, obs_n)) and dv <= V_TOL and rel <= REWARD_RTOL,
            f"|dV| max={dv:.2e} obs max|d|={dobs:.2e} reward-sum rel={rel:.2e}")


def main(argv):
    four = "--four" in argv
    device = bench.require_gpu()
    n_cards = 4 if four else 1
    if device["count"] < n_cards:
        raise SystemExit(f"--four needs four GPUs; JAX found {device['count']}")
    print(f"card: {bench.gpu_name_and_power_limit()}")
    print(f"jax {jax.__version__}, devices: {json.dumps(device)}")
    cache = jax.config.jax_compilation_cache_dir
    n_cached = len(os.listdir(cache)) if cache and os.path.isdir(cache) else 0
    print(f"compile cache: {cache} ({n_cached} entries at start)", flush=True)

    smoke = Smoke()
    if four:
        phase_four(smoke, n_cards)
    else:
        with smoke.phase("a bench programs"):
            phase_programs(smoke)
        with smoke.phase("b chord acceptance"):
            phase_acceptance(smoke)
        with smoke.phase("c card vs CPU reference"):
            phase_reference(smoke)
    if smoke.failures:
        print("FAILED: " + "; ".join(smoke.failures), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
