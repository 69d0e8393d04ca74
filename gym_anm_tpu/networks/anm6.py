"""The 6-bus / 7-device ANM6 distribution network.

Grid parameters identical to the reference's renderable environment family
(``gym_anm/envs/anm6_env/network.py:49-82``): a 132/33 kV slack connection
feeding three MV buses that host {residential load, PV}, {factory load,
wind farm} and {EV-charging load, storage} pairs, plus the fixed 24-hour
load and generation profiles of the ANM6Easy task, shared by the compat
environment and the vectorized task.
"""

import numpy as np

network = {"baseMVA": 100.0}

# [BUS_ID, BUS_TYPE, BASE_KV, VMAX, VMIN]
network["bus"] = np.array(
    [
        [0, 0, 132, 1.0, 1.0],
        [1, 1, 33, 1.1, 0.9],
        [2, 1, 33, 1.1, 0.9],
        [3, 1, 33, 1.1, 0.9],
        [4, 1, 33, 1.1, 0.9],
        [5, 1, 33, 1.1, 0.9],
    ]
)

# [DEV_ID, BUS_ID, DEV_TYPE, Q/P, PMAX, PMIN, QMAX, QMIN, P+, P-, Q+, Q-,
#  SOC_MAX, SOC_MIN, EFF]
network["device"] = np.array(
    [
        [0, 0, 0, None, 200, -200, 200, -200, None, None, None, None, None, None, None],
        [1, 3, -1, 0.2, 0, -10, None, None, None, None, None, None, None, None, None],
        [2, 3, 2, None, 30, 0, 30, -30, 20, None, 15, -15, None, None, None],
        [3, 4, -1, 0.2, 0, -30, None, None, None, None, None, None, None, None, None],
        [4, 4, 2, None, 50, 0, 50, -50, 35, None, 20, -20, None, None, None],
        [5, 5, -1, 0.2, 0, -30, None, None, None, None, None, None, None, None, None],
        [6, 5, 3, None, 50, -50, 50, -50, 30, -30, 25, -25, 100, 0, 0.9],
    ],
    dtype=object,
)

# [F_BUS, T_BUS, BR_R, BR_X, BR_B, RATE, TAP, SHIFT]
network["branch"] = np.array(
    [
        [0, 1, 0.0036, 0.1834, 0.0, 32, 1, 0],
        [1, 2, 0.03, 0.022, 0.0, 25, 1, 0],
        [1, 3, 0.0307, 0.0621, 0.0, 18, 1, 0],
        [2, 4, 0.0303, 0.0611, 0.0, 18, 1, 0],
        [2, 5, 0.0159, 0.0502, 0.0, 18, 1, 0],
    ]
)


def _piecewise_day(s1, s12, s2, s23, s3):
    """Assemble a 96-step daily profile from plateau/ramp segments
    (the construction pattern of anm6_easy.py:77-132)."""
    return np.concatenate((s1, s12, s2, s23, s3, s23[::-1], s2, s12[::-1], s1[:4]))


def _get_load_time_series():
    """Fixed 24-hour load profiles (anm6_easy.py:77-107), reproduced
    digit-for-digit."""
    # Device 1: residential load.
    P1 = _piecewise_day(
        -np.ones(25),
        np.linspace(-1.5, -4.5, 7),
        -5 * np.ones(13),
        np.linspace(-4.625, -2.375, 7),
        -2 * np.ones(13),
    )
    # Device 3: industrial load.
    P3 = _piecewise_day(
        -4 * np.ones(25),
        np.linspace(-4.75, -9.25, 7),
        -10 * np.ones(13),
        np.linspace(-11.25, -18.75, 7),
        -20 * np.ones(13),
    )
    # Device 5: EV-charging station load.
    P5 = _piecewise_day(
        np.zeros(25),
        np.linspace(-3.125, -21.875, 7),
        -25 * np.ones(13),
        np.linspace(-21.875, -3.125, 7),
        np.zeros(13),
    )
    P_loads = np.vstack((P1, P3, P5))
    assert P_loads.shape == (3, 96)
    return P_loads


def _get_gen_time_series():
    """Fixed 24-hour maximum-generation profiles (anm6_easy.py:110-132),
    including the asymmetric PV ramp into a lower plateau."""
    # Device 2: residential PV aggregation.
    P2 = _piecewise_day(
        np.zeros(25),
        np.linspace(0.5, 3.5, 7),
        4 * np.ones(13),
        np.linspace(7.25, 36.75, 7),
        30 * np.ones(13),
    )
    # Device 4: wind farm.
    P4 = _piecewise_day(
        40 * np.ones(25),
        np.linspace(36.375, 14.625, 7),
        11 * np.ones(13),
        np.linspace(14.725, 36.375, 7),
        40 * np.ones(13),
    )
    P_maxs = np.vstack((P2, P4))
    assert P_maxs.shape == (2, 96)
    return P_maxs
