"""chip_smoke.py and bench.py on a machine without a GPU, and the smoke
test's card-vs-reference comparison."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    """No GPU: a non-zero exit that names the missing GPU, and no result
    line — neither script falls back to the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


N_BUS = 4  # non-slack buses of the synthetic trajectories
TOL = chip_smoke.Tolerances(k_v=100.0, k_v_branch=1000.0,
                            k_action=np.array([0.1, 0.1, 0.0]),
                            obs_atol=np.full(5, 1e-3))


def _trajectory(n_steps=4, batch=200, seed=0):
    """A program's per-step outputs, as chip_smoke's builders return them:
    ``v`` is the state's [θ.., |V|..] solution."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(-0.05, 0.05, (n_steps, batch, N_BUS))
    vm = rng.uniform(0.95, 1.05, (n_steps, batch, N_BUS))
    done = np.zeros((n_steps, batch), bool)
    done[2, 3] = True
    return {
        "v": np.concatenate([theta, vm], axis=-1).astype(np.float32),
        "reward": -rng.uniform(0.001, 2.0, (n_steps, batch)).astype(np.float32),
        "done": done,
        "action": rng.uniform(0.0, 1.0, (n_steps, batch, 3)).astype(np.float32),
    }


def _bar(reward):
    return chip_smoke.REWARD_ATOL + chip_smoke.REWARD_RTOL * np.abs(reward)


@pytest.mark.parametrize("inject, ok", [
    (None, True),
    ("voltage", False),
    ("step_reward", False),
    ("done", False),
    ("nan_reward", False),
    ("voltage_on_done_lane", True),
    ("one_lane_reward", True),
    ("small_drift", True),
    ("lane_reward_without_voltage_gap", False),
    ("many_lanes_outside_bar", False),
    ("action_gap_explains_reward", True),
    ("nan_voltage", False),
])
def test_compare_trajectories_flags_mismatch(inject, ok):
    ref = _trajectory()
    card = {k: x.copy() for k, x in ref.items()}
    mean_bar = _bar(ref["reward"].mean(axis=1))
    if inject == "voltage":
        card["v"][1, 4, N_BUS + 2] += 2 * chip_smoke.V_TOL
    elif inject == "step_reward":
        card["reward"][3] += 2 * mean_bar[3]  # every lane of one step
    elif inject == "done":
        card["done"][0, 0] = True
    elif inject == "nan_reward":
        card["reward"][0, 1] = np.nan
    elif inject == "voltage_on_done_lane":
        card["v"][2, 3] += 1.0  # a terminated lane's voltages are not compared
    elif inject == "one_lane_reward":
        # Far outside the bar, but inside what the lane's own voltage gap
        # (5e-5 p.u.) can move the penalty: (100 + 1000·v_max)·5e-5 > 0.05.
        card["v"][3, 0, N_BUS] += 5e-5
        card["reward"][3, 0] += 0.03
    elif inject == "small_drift":
        card["v"][..., N_BUS:] += 0.5 * chip_smoke.V_TOL
        card["reward"] += 0.5 * _bar(ref["reward"])
    elif inject == "lane_reward_without_voltage_gap":
        card["reward"][3, 0] += 0.03
    elif inject == "many_lanes_outside_bar":
        # Each lane explained by its voltage gap, but 5% of lane-steps
        # outside the bar alone (the cap is 1%).
        card["v"][:, :10, N_BUS] += 5e-5
        card["reward"][:, :10] += 0.01
    elif inject == "action_gap_explains_reward":
        card["action"][1, 5, 0] += 0.2  # moves the bound by 0.1·0.2
        card["reward"][1, 5] += 0.015
    elif inject == "nan_voltage":
        card["v"][0, 7, N_BUS] = np.nan
    got, detail = chip_smoke.compare_trajectories(card, ref, TOL)
    assert got is ok, detail


def _dataset(n_steps=4, batch=200, seed=1):
    """The L0-L5 collector's outputs: no voltages, observations both sides."""
    rng = np.random.default_rng(seed)
    traj = _trajectory(n_steps, batch, seed)
    del traj["v"]
    traj["obs"] = rng.uniform(-5.0, 5.0, (n_steps, batch, 5)).astype(np.float32)
    traj["next_obs"] = rng.uniform(-5.0, 5.0, (n_steps, batch, 5)).astype(np.float32)
    return traj


def test_compare_trajectories_without_voltages():
    """The dataset collector reports no |V|: done, observations and the
    rewards' bars still decide; actions are reported."""
    ref = _dataset()
    mean_bar = _bar(ref["reward"].mean(axis=1))
    card = dict(ref, reward=ref["reward"] - 2 * mean_bar[:, None])
    assert chip_smoke.compare_trajectories(ref, ref, TOL)[0]
    assert not chip_smoke.compare_trajectories(card, ref, TOL)[0]


@pytest.mark.parametrize("inject, ok", [
    ("obs", False),
    ("next_obs", False),
    ("obs_within_tolerance", True),
    ("action", True),
    ("one_lane_reward", True),
])
def test_compare_dataset_trajectories(inject, ok):
    ref = _dataset()
    card = {k: x.copy() for k, x in ref.items()}
    if inject in ("obs", "next_obs"):
        card[inject][1, 2, 3] += 2 * TOL.obs_atol[3] + 2 * chip_smoke.OBS_RTOL * 5.0
    elif inject == "obs_within_tolerance":
        card["obs"] += 0.5 * TOL.obs_atol
    elif inject == "action":
        card["action"][0, 0] += 1.0  # a controller's choice: reported
    elif inject == "one_lane_reward":
        card["reward"][3, 0] += 0.03  # one lane-step outside the bar: under the cap
    got, detail = chip_smoke.compare_trajectories(card, ref, TOL)
    assert got is ok, detail


@pytest.mark.parametrize("task", ["ieee33", "ieee33_multicap", "anm6easy"])
def test_tolerances_for_bench_envs(task):
    """Set-point gaps count only for generator P and Q; the slack device's
    observation columns get the slack injection's bound."""
    import jax.numpy as jnp

    from gym_anm_tpu import vec

    env = vec.VecEnv(getattr(vec, f"make_{task}_task")(), dtype=jnp.float32)
    tol = chip_smoke.tolerances_for(env)
    n_gen, tb = env.spec.n_gen, env.tables
    assert 0 < tol.k_v < tol.k_v_branch < np.inf
    assert np.all(tol.k_action[:2 * n_gen] == 2 * tb.delta_t / tb.baseMVA)
    assert not tol.k_action[2 * n_gen:].any()
    slack = [tb.slack_dev, tb.n_dev + tb.slack_dev]
    assert np.all(tol.obs_atol[slack] > chip_smoke.OBS_ATOL)
    assert np.all(np.delete(tol.obs_atol, slack) == chip_smoke.OBS_ATOL)


def test_f32_tier_within_card_bounds():
    """The witness for the comparison's bounds: the f32 tier against the
    f64 tier on the CPU, for the ieee33 program as phase c runs it (B=512,
    16 steps), passes the comparison the card is held to."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import f32_tier_witness

    ok, detail = f32_tier_witness.ieee33_f32_vs_f64()
    assert ok, detail
