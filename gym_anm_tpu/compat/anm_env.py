"""Gymnasium-compatible base environment.

Drop-in equivalent of the reference ``ANMEnv``
(``gym_anm/envs/anm_env.py:22-627``): same constructor, spaces, hooks
(``init_state``/``next_vars``/``observation_bounds``/``observation``),
reset-retry loop, reward clipping and terminal semantics.  Subclasses
written against the reference work unchanged; the physics underneath runs
as one jitted XLA program per step.

For at-scale on-device rollouts use :mod:`gym_anm_tpu.vec` instead — this
class exists for API parity and single-env trajectory matching.
"""

from copy import deepcopy
from logging import getLogger
from typing import Optional

import numpy as np

try:
    import gymnasium as gym
    from gymnasium import spaces
except ImportError as e:
    raise ImportError(
        "gym_anm_tpu.compat needs gymnasium (pip install gymnasium); "
        "the vectorized tier gym_anm_tpu.vec runs without it") from e

from ..env.simulator import Simulator
from ..errors import (
    EnvInitializationError,
    EnvNextVarsError,
    ObsNotSupportedError,
    ObsSpaceError,
)
from ..specs.constants import (
    DEV_TYPE_CAPACITOR,
    DEV_TYPE_OLTC,
    DEV_TYPE_STORAGE,
    STATE_VARIABLES,
)
from .utils import check_env_args

logger = getLogger(__name__)


class ANMEnv(gym.Env):
    """Base class for ANM environments (reference: anm_env.py:22)."""

    def __init__(self, network, observation, K, delta_t, gamma, lamb,
                 aux_bounds=None, costs_clipping=None, seed=None):
        # Initialize the RNG (gym.Env.reset seeds self.np_random).
        super().reset(seed=seed)

        self.K = K
        self.gamma = gamma
        self.lamb = lamb
        self.delta_t = delta_t
        self.aux_bounds = aux_bounds

        if costs_clipping is None:
            c1, c2 = np.inf, np.inf
        else:
            c1 = np.inf if costs_clipping[0] is None else costs_clipping[0]
            c2 = np.inf if costs_clipping[1] is None else costs_clipping[1]
        self.costs_clipping = (c1, c2)

        self.simulator = Simulator(network, self.delta_t, self.lamb)

        check_env_args(K, delta_t, lamb, gamma, observation, aux_bounds,
                       self.simulator.state_bounds)

        self.state_values = [
            ("dev_p", "all", "MW"),
            ("dev_q", "all", "MVAr"),
            ("des_soc", "all", "MWh"),
            ("gen_p_max", "all", "MW"),
            ("aux", "all", None),
        ]
        self.state_values = self._expand_all_ids(self.state_values)
        self.state_N = sum(len(s[1]) for s in self.state_values)

        self.action_space = self._build_action_space()

        self.obs_values = self._build_observation_space(observation)
        self.observation_space = self.observation_bounds()
        if self.observation_space is not None:
            self.observation_N = self.observation_space.shape[0]

    # --- user hooks ----------------------------------------------------
    def init_state(self):
        """Sample an initial state vector s0 (subclass hook)."""
        raise NotImplementedError

    def next_vars(self, s_t):
        """Sample internal variables [P_load, P_pot, aux] (subclass hook)."""
        raise NotImplementedError

    # --------------------------------------------------------------------
    def observation_bounds(self):
        """Bounds of the observation space (anm_env.py:193-233)."""
        lower_bounds, upper_bounds = [], []
        if self.obs_values is None:
            logger.warning("The observation space is unbounded.")
            return None

        bounds = self.simulator.state_bounds
        for key, nodes, unit in self.obs_values:
            for n in nodes:
                if key == "aux":
                    if self.aux_bounds is not None:
                        lower_bounds.append(self.aux_bounds[n][0])
                        upper_bounds.append(self.aux_bounds[n][1])
                    else:
                        lower_bounds.append(-np.inf)
                        upper_bounds.append(np.inf)
                else:
                    lower_bounds.append(bounds[key][n][unit][0])
                    upper_bounds.append(bounds[key][n][unit][1])

        return spaces.Box(low=np.array(lower_bounds), high=np.array(upper_bounds),
                          dtype=np.float64)

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None):
        """Reset the environment (anm_env.py:235-311)."""
        super().reset(seed=seed, options=options)

        self.terminated = False
        self.render_mode = None
        self.timestep = 0
        self.e_loss = 0.0
        self.penalty = 0.0

        # Retry sampled initial states until the load flow converges.
        n_init_states = 0
        n_init_states_max = 100
        init_state_found = False
        while not init_state_found:
            n_init_states += 1
            self.state = self.init_state()

            expected = (2 * self.simulator.N_device + self.simulator.N_des
                        + self.simulator.N_non_slack_gen + self.K)
            if self.state.size != expected:
                raise EnvInitializationError(
                    "Expected size of initial state s0 is %d but actual is %d"
                    % (expected, self.state.size)
                )

            init_state_found = self.simulator.reset(self.state)

            # NB: like the reference (anm_env.py:284-289), this raises on the
            # 100th attempt even if that attempt succeeded.
            if n_init_states == n_init_states_max:
                raise EnvInitializationError(
                    "No non-terminal state found out of %d initial states for "
                    "environment %s" % (n_init_states_max, type(self).__name__)
                )

        # Re-construct the state vector in case the sampled one was infeasible.
        self.state = self._construct_state()
        obs = self.observation(self.state)

        if self.observation_space is None:
            # float64, like every other space here: the env emits float64
            # observations, and gymnasium's Box.contains rejects them in a
            # float32 box.  (The reference's callable-observation path is
            # unusable as shipped — it crashes on reset with an
            # AttributeError before reaching this — so this working path is
            # a deliberate fix, not a parity deviation.)
            self.observation_space = spaces.Box(
                low=-np.ones(len(obs)) * np.inf, high=np.ones(len(obs)) * np.inf,
                dtype=np.float64,
            )
            self.observation_N = self.observation_space.shape[0]

        err_msg = "Observation %r (%s) invalid." % (obs, type(obs))
        assert self.observation_space.contains(obs), err_msg

        if self.terminated:
            self.state = self._terminal_state(self.state_N)
            obs = self._terminal_state(self.observation_N)

        return obs, {}

    def observation(self, s_t):
        """Observation vector for the current state (anm_env.py:313-331)."""
        obs = self._extract_state_variables(self.obs_values)
        obs = np.clip(obs, self.observation_space.low, self.observation_space.high)
        return obs

    def step(self, action):
        """MDP transition (anm_env.py:333-469)."""
        err_msg = "Action %r (%s) invalid." % (action, type(action))
        assert self.action_space.contains(action), err_msg

        truncated = False
        info = {}

        # Remain in a terminal state with zero reward.
        if self.terminated:
            obs = self._terminal_state(self.observation_N)
            return obs, 0.0, self.terminated, truncated, info

        # 1. Internal stochastic variables.
        vars = self.next_vars(self.state)
        expected_size = self.simulator.N_load + self.simulator.N_non_slack_gen + self.K
        if vars.size != expected_size:
            raise EnvNextVarsError(
                "Next vars vector has size %d but expected is %d" % (vars.size, expected_size)
            )

        n_load = self.simulator.N_load
        n_gen = self.simulator.N_non_slack_gen
        P_load = vars[:n_load]
        P_pot = vars[n_load : n_load + n_gen]
        aux = vars[n_load + n_gen :]
        assert len(aux) == self.K, (
            "Only {} auxiliary variables are generated, but K={} are expected.".format(len(aux), self.K)
        )

        sim = self.simulator
        P_load_dict, P_pot_dict = {}, {}
        load_idx, gen_idx = 0, 0
        for dev_id, dev in sim.devices.items():
            if dev.type == -1:
                P_load_dict[dev_id] = P_load[load_idx]
                load_idx += 1
            elif dev.type in (1, 2):
                P_pot_dict[dev_id] = P_pot[gen_idx]
                gen_idx += 1

        # 2. Slice the action vector [P_gen, Q_gen, P_des, Q_des, Q_cap, tap].
        gen_ids = [i for i, d in sim.devices.items() if d.type in (1, 2)]
        des_ids = [i for i, d in sim.devices.items() if d.type == DEV_TYPE_STORAGE]
        cap_ids = [i for i, d in sim.devices.items() if d.type == DEV_TYPE_CAPACITOR]
        oltc_ids = [i for i, d in sim.devices.items() if d.type == DEV_TYPE_OLTC]
        N_gen, N_des, N_cap = len(gen_ids), len(des_ids), len(cap_ids)

        P_set_points, Q_set_points, tap_set_points = {}, {}, {}
        for a, dev_id in zip(action[:N_gen], gen_ids):
            P_set_points[dev_id] = a
        for a, dev_id in zip(action[N_gen : 2 * N_gen], gen_ids):
            Q_set_points[dev_id] = a
        for a, dev_id in zip(action[2 * N_gen : 2 * N_gen + N_des], des_ids):
            P_set_points[dev_id] = a
        base = 2 * N_gen + N_des
        for a, dev_id in zip(action[base : base + N_des], des_ids):
            Q_set_points[dev_id] = a
        base += N_des
        for a, dev_id in zip(action[base : base + N_cap], cap_ids):
            Q_set_points[dev_id] = a
        base += N_cap
        for a, dev_id in zip(action[base : base + len(oltc_ids)], oltc_ids):
            tap_set_points[dev_id] = a

        # 3. Apply in the simulator; divergence => terminal.
        _, r, e_loss, penalty, pfe_converged = sim.transition(
            P_load_dict, P_pot_dict, P_set_points, Q_set_points, tap_set_points
        )
        self.terminated = not pfe_converged

        # 3b. Clip the costs (anm_env.py:439-448).
        if not self.terminated:
            self.e_loss = np.sign(e_loss) * np.clip(np.abs(e_loss), 0, self.costs_clipping[0])
            self.penalty = np.clip(penalty, 0, self.costs_clipping[1])
            r = -(self.e_loss + self.penalty)
        else:
            r = -self.costs_clipping[1] / (1 - self.gamma)
            self.e_loss = self.costs_clipping[0]
            self.penalty = self.costs_clipping[1]

        # 4. New state and observation vectors.
        if not self.terminated:
            for k in range(self.K):
                self.state[k - self.K] = aux[k]
            self.state = self._construct_state()
            obs = self.observation(self.state)
            err_msg = "Observation %r (%s) invalid." % (obs, type(obs))
            assert self.observation_space.contains(obs), err_msg
        else:
            self.state = self._terminal_state(self.state_N)
            obs = self._terminal_state(self.observation_N)

        self.timestep += 1
        return obs, r, self.terminated, truncated, info

    def render(self, mode="human"):
        raise NotImplementedError()

    def close(self):
        raise NotImplementedError()

    # --------------------------------------------------------------------
    def _build_action_space(self):
        bounds = self.simulator.get_action_space()
        P_gen_bounds, Q_gen_bounds, P_des_bounds, Q_des_bounds = bounds[:4]
        Q_cap_bounds = bounds[4] if len(bounds) > 4 else {}
        tap_bounds = bounds[5] if len(bounds) > 5 else {}

        lower_bounds, upper_bounds = [], []
        for x in [P_gen_bounds, Q_gen_bounds, P_des_bounds, Q_des_bounds, Q_cap_bounds, tap_bounds]:
            for dev_id in sorted(x.keys()):
                lower_bounds.append(x[dev_id][0])
                upper_bounds.append(x[dev_id][1])

        return spaces.Box(low=np.array(lower_bounds), high=np.array(upper_bounds),
                          dtype=np.float64)

    def _build_observation_space(self, observation):
        if isinstance(observation, str) and observation == "state":
            obs_values = deepcopy(self.state_values)
        elif isinstance(observation, list):
            obs_values = deepcopy(observation)
            for idx, o in enumerate(obs_values):
                if len(o) == 2:
                    obs_values[idx] = tuple(list(o) + [STATE_VARIABLES[o[0]][0]])
        elif callable(observation):
            obs_values = None
            self.observation = observation
        else:
            raise ObsSpaceError()

        return self._expand_all_ids(obs_values)

    def _expand_all_ids(self, values):
        """Translate the 'all' option into explicit ID lists
        (anm_env.py:542-568)."""
        if values is not None:
            for idx, o in enumerate(values):
                if isinstance(o[1], str) and o[1] == "all":
                    sim = self.simulator
                    if "bus" in o[0]:
                        ids = list(sim.buses.keys())
                    elif "dev" in o[0]:
                        ids = list(sim.devices.keys())
                    elif "des" in o[0]:
                        ids = [i for i, d in sim.devices.items() if d.type == DEV_TYPE_STORAGE]
                    elif "gen" in o[0]:
                        ids = [i for i, d in sim.devices.items() if d.type in (1, 2)]
                    elif "branch" in o[0]:
                        ids = list(sim.branches.keys())
                    elif o[0] == "aux":
                        ids = list(range(0, self.K))
                    else:
                        raise ObsNotSupportedError(o[0], STATE_VARIABLES.keys())
                    values[idx] = (o[0], ids, o[2])
        return values

    def _construct_state(self):
        return self._extract_state_variables(self.state_values)

    def _extract_state_variables(self, values):
        """Gather the requested (quantity, id, unit) triples from the
        simulator state dict (anm_env.py:581-611)."""
        full_state = self.simulator.state
        out = []
        for value in values:
            for idx in value[1]:
                if value[0] in full_state.keys():
                    o = full_state[value[0]][value[2]][idx]
                elif value[0] == "aux":
                    o = self.state[idx - self.K]
                else:
                    raise ObsNotSupportedError(value[0], STATE_VARIABLES.keys())
                out.append(o)
        return np.array(out)

    def _terminal_state(self, n):
        return np.zeros(n)
