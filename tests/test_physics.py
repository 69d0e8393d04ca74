"""Physics kernels: Y-bus values, NR solver invariants and reference parity."""

import jax.numpy as jnp
import numpy as np
import pytest

from gym_anm_tpu import load_network
from gym_anm_tpu.env.simulator import Simulator
from gym_anm_tpu.networks import anm6_network, ieee33_network, two_bus_network
from gym_anm_tpu.physics import build_ybus, nr_solve

from .conftest import requires_reference
from .oracle import check_pfe_solution


def _my_ybus(spec, tap=None):
    series = 1.0 / (spec.br_r + 1j * spec.br_x)
    tap = spec.br_tap0 if tap is None else tap
    Yre, Yim = build_ybus(
        spec.n_bus,
        spec.br_f,
        spec.br_t,
        jnp.asarray(series.real),
        jnp.asarray(series.imag),
        jnp.asarray(spec.br_b / 2),
        jnp.asarray(np.cos(spec.br_shift)),
        jnp.asarray(np.sin(spec.br_shift)),
        jnp.asarray(tap, dtype=jnp.float64),
    )
    return np.asarray(Yre) + 1j * np.asarray(Yim)


def test_ybus_analytic_transformer():
    """Hand-derived Y-bus for a 2-bus line with an off-nominal transformer
    (same check as tests/simulator/test_simulator_basics.py:48-67)."""
    r, x, b = 0.1, 0.3, 0.2
    tap_magn, shift_deg = 0.97, 30.0
    net = {
        "baseMVA": 10.0,
        "bus": np.array([[0, 0, 100, 1.1, 0.9], [1, 1, 100, 1.1, 0.9]]),
        "device": np.array(
            [
                [0, 0, 0, None, 50, -50, 50, -50, None, None, None, None, None, None, None],
                [1, 1, -1, 0.2, 0, -10, None, None, None, None, None, None, None, None, None],
            ],
            dtype=object,
        ),
        "branch": np.array([[0, 1, r, x, b, 10, tap_magn, shift_deg]]),
    }
    spec = load_network(net)
    Y = _my_ybus(spec)

    y = 1 / (r + 1j * x)
    ysh = 1j * b / 2
    tap = tap_magn * np.exp(1j * shift_deg * np.pi / 180)
    expected = np.array(
        [
            [(y + ysh) / np.abs(tap) ** 2, -y / np.conj(tap)],
            [-y / tap, y + ysh],
        ]
    )
    np.testing.assert_allclose(Y, expected, rtol=1e-12)


@requires_reference
@pytest.mark.parametrize("net", [two_bus_network, anm6_network, ieee33_network])
def test_ybus_matches_reference(reference, net):
    from gym_anm.simulator import Simulator as RefSim

    spec = load_network(net)
    ref = RefSim(net, delta_t=1.0, lamb=100)
    np.testing.assert_array_equal(_my_ybus(spec), ref.Y_bus.toarray())


@requires_reference
@pytest.mark.parametrize("net", [two_bus_network, anm6_network, ieee33_network])
def test_nr_matches_reference_solver(reference, net):
    from gym_anm.simulator import Simulator as RefSim
    from gym_anm.simulator import solve_load_flow as ref_slf

    spec = load_network(net)
    ref = RefSim(net, delta_t=1.0, lamb=100)
    series = 1.0 / (spec.br_r + 1j * spec.br_x)
    Yre = jnp.asarray(_my_ybus(spec).real)
    Yim = jnp.asarray(_my_ybus(spec).imag)

    rng = np.random.default_rng(0)
    for _ in range(10):
        p = rng.uniform(-0.03, 0.0, spec.n_bus - 1)
        q = rng.uniform(-0.01, 0.01, spec.n_bus - 1)
        for i, bus in enumerate(ref.buses.values()):
            if not bus.is_slack:
                bus.p, bus.q = p[i - 1], q[i - 1]
        V_ref, stable_ref = ref_slf.solve_pfe_newton_raphson(ref, xtol=1e-5)
        res = nr_solve(Yre, Yim, jnp.asarray(p), jnp.asarray(q))
        V = np.asarray(res.v_re) + 1j * np.asarray(res.v_im)
        assert bool(res.stable) == stable_ref
        np.testing.assert_allclose(V, V_ref, atol=1e-10)


def test_nr_batched_vmap():
    """vmapped solves equal per-lane solves (masked while-loop semantics)."""
    import jax

    spec = load_network(ieee33_network)
    Y = _my_ybus(spec)
    Yre, Yim = jnp.asarray(Y.real), jnp.asarray(Y.imag)
    rng = np.random.default_rng(3)
    B = 16
    p = jnp.asarray(rng.uniform(-0.05, 0.0, (B, spec.n_bus - 1)))
    q = jnp.asarray(rng.uniform(-0.02, 0.02, (B, spec.n_bus - 1)))
    batched = jax.vmap(lambda pp, qq: nr_solve(Yre, Yim, pp, qq))(p, q)
    for i in range(B):
        single = nr_solve(Yre, Yim, p[i], q[i])
        np.testing.assert_allclose(batched.v_re[i], single.v_re, atol=1e-12)
        np.testing.assert_allclose(batched.v_im[i], single.v_im, atol=1e-12)
        assert int(batched.n_iter[i]) == int(single.n_iter)


def test_nr_divergence_flags():
    """Absurd injections must not report a stable solution."""
    spec = load_network(two_bus_network)
    Y = _my_ybus(spec)
    res = nr_solve(jnp.asarray(Y.real), jnp.asarray(Y.imag), jnp.asarray([-1e6]), jnp.asarray([-1e6]))
    assert not bool(res.stable)


@pytest.mark.parametrize("net", [two_bus_network, anm6_network, ieee33_network])
def test_transition_satisfies_pfe_invariants(net):
    """Random feasible injections -> the solution satisfies the PFE oracle
    (style of tests/simulator/test_simulator_transitions.py)."""
    sim = Simulator(net, delta_t=1.0, lamb=100)
    spec = sim.spec
    rng = np.random.default_rng(11)
    for _ in range(5):
        P_load = {int(spec.dev_ids[p]): rng.uniform(-3, 0) for p in spec.load_pos}
        gen_ids = [int(spec.dev_ids[p]) for p in spec.gen_nonslack_pos]
        P_pot = {i: rng.uniform(0, 20) for i in gen_ids}
        P_set = {i: rng.uniform(0, 20) for i in gen_ids}
        Q_set = {i: rng.uniform(-5, 5) for i in gen_ids}
        for p in spec.des_pos:
            i = int(spec.dev_ids[p])
            P_set[i] = rng.uniform(-10, 10)
            Q_set[i] = rng.uniform(-5, 5)
        for p in spec.cap_pos:
            Q_set[int(spec.dev_ids[p])] = rng.uniform(0, 0.5)
        _, _, _, _, conv = sim.transition(P_load, P_pot, P_set, Q_set)
        assert conv
        check_pfe_solution(sim)


def test_numpy_nr_solve_matches_baseline_vmin():
    """The host-side numpy NR solver (used to pick chord linearization
    points) reproduces the measured BASELINE anchor: IEEE33 at 1.0x
    nominal case33bw load has v_min = 0.95328 p.u. (BASELINE.md, measured
    against the reference solver)."""
    import numpy as np

    from gym_anm_tpu.networks import ieee33_network
    from gym_anm_tpu.physics.power_flow import numpy_nr_solve
    from gym_anm_tpu.specs.network import load_network

    spec = load_network(ieee33_network)
    N = spec.n_bus
    series = 1.0 / (spec.br_r + 1j * spec.br_x)
    tap = spec.br_tap0 * np.exp(1j * spec.br_shift)
    sh = 1j * spec.br_b / 2.0
    Y = np.zeros((N, N), complex)
    for k in range(spec.n_branch):
        f, t = int(spec.br_f[k]), int(spec.br_t[k])
        Y[f, t] += -series[k] / np.conj(tap[k])
        Y[t, f] += -series[k] / tap[k]
        Y[f, f] += (series[k] + sh[k]) / np.abs(tap[k]) ** 2
        Y[t, t] += series[k] + sh[k]

    # Full nominal loads (NOT the 1/100 init_state quirk): p_min is the
    # nominal case33bw draw in p.u.
    p_bus = np.zeros(N)
    q_bus = np.zeros(N)
    for d in spec.load_pos:
        bus = int(spec.dev_bus[d])
        p_bus[bus] += spec.p_min[d]
        q_bus[bus] += spec.p_min[d] * spec.qp_ratio[d]

    x = numpy_nr_solve(Y, p_bus[1:], q_bus[1:])
    vm = x[N - 1:]
    assert np.all(np.isfinite(vm))
    np.testing.assert_allclose(vm.min(), 0.95328, atol=5e-5)


@pytest.mark.parametrize("batch", [1, 7, 256])
def test_f32_nr_solve_vmapped_matches_numpy(batch):
    """The f32 exact-NR fallback under vmap, from flat start, reaches the
    pure-numpy float64 solution (numpy_nr_solve, solved to 1e-10) within
    1e-4 p.u. on every lane — whatever the batch size, since the batched
    solve is the same plain XLA program for any leading shape."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    Y, p, q = chip_smoke.nr_reference_problems(batch, seed=batch)
    v_ref = chip_smoke.numpy_reference_voltages(Y, p, q)
    max_dv, n_unstable = chip_smoke.nr_solve_max_dv(Y, p, q, np.float32, v_ref)
    assert n_unstable == 0
    assert max_dv <= chip_smoke.NR_V_TOL[np.float32], max_dv



@pytest.mark.parametrize("voltages", ["flat", "random"])
def test_branch_penalty_flow_ignores_sign_of_zero_p(voltages):
    """The penalty's branch term reads max(|S_from|, |S_to|).  The signed
    flow equals it up to sign, except where p_from is exactly 0 and sign()
    zeroes it: a flat profile over charged lines carries reactive power
    only, yet its flow must still count."""
    from gym_anm_tpu.physics.transition import branch_flows, make_tables

    tb = make_tables(load_network(anm6_network), delta_t=1.0, lamb=100)
    n_br = tb.n_branch
    tb = tb._replace(shunt_im=np.full(n_br, 0.01), shift_cos=np.ones(n_br),
                     shift_sin=np.zeros(n_br))
    if voltages == "flat":
        v_re, v_im = np.ones(tb.n_bus), np.zeros(tb.n_bus)
    else:
        rng = np.random.default_rng(3)
        v_re, v_im = rng.uniform(0.95, 1.05, tb.n_bus), rng.uniform(-0.05, 0.05, tb.n_bus)
    *_, p_from, q_from, p_to, q_to, s_signed, s_max = [
        np.asarray(x) for x in branch_flows(tb, jnp.asarray(v_re), jnp.asarray(v_im),
                                            jnp.ones(n_br))]
    expected = np.maximum(np.hypot(p_from, q_from), np.hypot(p_to, q_to))
    np.testing.assert_allclose(s_max, expected, rtol=1e-12)
    if voltages == "flat":
        assert np.all(p_from == 0) and np.all(s_signed == 0)
        np.testing.assert_allclose(s_max, 0.01, rtol=1e-9)
    else:
        np.testing.assert_allclose(np.abs(s_signed), s_max, rtol=1e-12)
