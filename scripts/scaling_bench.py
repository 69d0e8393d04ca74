"""Multi-device / multi-host scaling-efficiency benchmark for the env farm.

Steps a fixed per-device batch of IEEE33 envs (weak scaling) over meshes of
increasing size and reports throughput + efficiency vs the 1-device run.
On a pod slice this measures real ICI scaling (the BASELINE gate is ≥80%
efficiency at ≥2 hosts); on a single-chip or CPU machine pass ``--cpu`` to
exercise the same sharded program over N virtual host devices (mechanism
check, not a hardware number).

``--multihost N`` is the one-command ≥2-host gate: it spawns 1..N OS
processes, each running ``jax.distributed.initialize`` (the exact bring-up
a real pod-slice deployment uses — tests/test_multihost.py's path), steps
the globally-sharded farm with a cross-process reward psum every step, and
prints the weak-scaling efficiency table vs the 1-process run.  On this
CPU-only machine the collectives ride Gloo; on real multi-host GPU
hardware the SAME command (without ``--cpu`` semantics — each process then
sees its slice's chips) produces the BASELINE gate number.

Usage:  python scripts/scaling_bench.py [--cpu] [--per-device 1024]
        [--steps 32]
        python scripts/scaling_bench.py --multihost 2 [--per-device 256]
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

_WORKER = "--worker" in sys.argv

if "--cpu" in sys.argv:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
elif _WORKER:
    # Multihost worker: CPU + per-process virtual devices, BEFORE jax init.
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={sys.argv[sys.argv.index('--devices-per-proc') + 1]}"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from gym_anm_tpu.vec import VecEnv, make_ieee33_task  # noqa: E402


def run_at(n_devices, per_device, n_steps, reps=3):
    devices = jax.devices()[:n_devices]
    mesh = Mesh(np.array(devices), ("env",))
    env_sh = NamedSharding(mesh, P("env"))
    env = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    B = per_device * n_devices

    keys = jax.random.split(jax.random.PRNGKey(0), B)
    state, obs = jax.jit(jax.vmap(env.reset), out_shardings=(env_sh, env_sh))(keys)
    lo, hi = env.action_low, env.action_high

    def rollout(state, obs, seed):
        def body(carry, t):
            st, obs = carry
            k = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            acts = lo + jax.random.uniform(k, (B, env.n_action), dtype=env.dtype) * (hi - lo)
            st, obs, r, d, _ = jax.vmap(env.step)(st, acts)
            return (st, obs), r.sum()

        (state, obs), rs = jax.lax.scan(body, (state, obs), jnp.arange(n_steps))
        return state, obs, rs.sum()

    roll = jax.jit(rollout, in_shardings=(env_sh, env_sh, None),
                   out_shardings=(env_sh, env_sh, None), donate_argnums=(0,))
    state, obs, tot = roll(state, obs, 0)
    jax.block_until_ready(tot)
    t0 = time.perf_counter()
    for r in range(reps):
        state, obs, tot = roll(state, obs, r + 1)
    jax.block_until_ready(tot)
    dt = time.perf_counter() - t0
    return B * n_steps * reps / dt


def worker(proc_id, n_procs, port, per_device, n_steps, devices_per_proc, reps=3):
    """One multihost process: distributed init + timed global-farm rollout.

    The rollout is the same program as :func:`run_at` but over the GLOBAL
    mesh; the per-step ``r.sum()`` over the env-sharded reward is a global
    reduction, so every step crosses the process boundary (Gloo here,
    ICI/DCN on real hardware).  Prints ``SPS <proc_id> <steps/s>``.
    """
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = jax.devices()
    assert len(devs) == n_procs * devices_per_proc, devs
    mesh = Mesh(np.array(devs), ("env",))
    env_sh = NamedSharding(mesh, P("env"))
    env = VecEnv(make_ieee33_task(), dtype=jnp.float32)
    B = per_device * len(devs)

    keys = jax.random.split(jax.random.PRNGKey(0), B)
    lanes_local = B // n_procs
    local_keys = keys[proc_id * lanes_local : (proc_id + 1) * lanes_local]
    with jax.default_device(jax.local_devices()[0]):
        state_l, obs_l = jax.vmap(env.reset)(local_keys)

    def to_global(x):
        return jax.make_array_from_process_local_data(env_sh, np.asarray(x))

    state = jax.tree_util.tree_map(to_global, state_l)
    obs = to_global(obs_l)
    lo, hi = env.action_low, env.action_high

    def rollout(state, obs, seed):
        def body(carry, t):
            st, obs = carry
            k = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            acts = lo + jax.random.uniform(k, (B, env.n_action), dtype=env.dtype) * (hi - lo)
            st, obs, r, d, _ = jax.vmap(env.step)(st, acts)
            return (st, obs), r.sum()

        (state, obs), rs = jax.lax.scan(body, (state, obs), jnp.arange(n_steps))
        return state, obs, rs.sum()

    roll = jax.jit(rollout, in_shardings=(env_sh, env_sh, None),
                   out_shardings=(env_sh, env_sh, None), donate_argnums=(0,))
    state, obs, tot = roll(state, obs, 0)
    jax.block_until_ready(tot)
    t0 = time.perf_counter()
    for r in range(reps):
        state, obs, tot = roll(state, obs, r + 1)
    jax.block_until_ready(tot)
    dt = time.perf_counter() - t0
    print(f"SPS {proc_id} {B * n_steps * reps / dt:.1f}", flush=True)
    jax.distributed.shutdown()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_table(max_procs, per_device, n_steps, devices_per_proc):
    """Spawn 1..max_procs worker sets; print the efficiency table."""
    import re

    print(f"multihost weak scaling: {devices_per_proc} virtual device(s)/process, "
          f"per-device batch {per_device}, {n_steps} steps x 3 reps")
    n_cores = os.cpu_count() or 1
    if n_cores < max_procs * devices_per_proc:
        print(f"  NOTE: {n_cores} CPU core(s) < {max_procs * devices_per_proc} "
              "virtual devices — processes share cores, so the efficiency "
              "column measures core contention, NOT interconnect scaling; "
              "the gate value is only meaningful on real multi-host hardware")
    base = None
    results = []
    sizes = [n for n in (1, 2, 4, 8) if n <= max_procs]
    for n in sizes:
        port = str(_free_port())
        procs = [
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 str(i), str(n), port,
                 "--per-device", str(per_device), "--steps", str(n_steps),
                 "--devices-per-proc", str(devices_per_proc)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for i in range(n)
        ]
        sps = None
        for p in procs:
            out, _ = p.communicate(timeout=900)
            if p.returncode != 0:
                print(out[-2000:])
                raise RuntimeError(f"worker failed at n_procs={n}")
            m = re.search(r"SPS 0 (\S+)", out)
            if m:
                sps = float(m.group(1))
        assert sps is not None
        if base is None:
            base = sps
        eff = sps / (base * n)
        results.append({"processes": n, "devices": n * devices_per_proc,
                        "steps_per_s": round(sps, 1), "efficiency": round(eff, 3)})
        print(f"  {n} process(es) x {devices_per_proc} dev: {sps:,.0f} steps/s  "
              f"(weak-scaling efficiency {eff:.1%})")
    gate = all(r["efficiency"] >= 0.8 for r in results if r["processes"] >= 2)
    print(json.dumps({"metric": "ieee33_multihost_weak_scaling",
                      "per_device_batch": per_device,
                      "gate_80pct_at_2plus_hosts": gate,
                      "results": results}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="8 virtual CPU devices (mechanism check)")
    ap.add_argument("--per-device", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--multihost", type=int, default=0, metavar="N",
                    help="spawn 1..N jax.distributed processes and print the "
                         "weak-scaling efficiency table (the >=80%% BASELINE gate)")
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--worker", nargs=3, metavar=("ID", "NPROCS", "PORT"))
    args = ap.parse_args()
    if args.worker:
        worker(int(args.worker[0]), int(args.worker[1]), args.worker[2],
               args.per_device, args.steps, args.devices_per_proc)
        return
    if args.multihost:
        if args.multihost < 1:
            ap.error("--multihost must be >= 1")
        multihost_table(args.multihost, args.per_device, args.steps,
                        args.devices_per_proc)
        return
    if args.per_device < 1 or args.steps < 1:
        ap.error("--per-device and --steps must be >= 1")

    n_avail = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8) if n <= n_avail]
    print(f"devices available: {n_avail} ({jax.devices()[0].platform})")

    base = None
    results = []
    for n in sizes:
        sps = run_at(n, args.per_device, args.steps)
        if base is None:
            base = sps
        eff = sps / (base * n)
        results.append({"devices": n, "steps_per_s": round(sps, 1),
                        "efficiency": round(eff, 3)})
        print(f"  {n} device(s): {sps:,.0f} steps/s  "
              f"(weak-scaling efficiency {eff:.1%})")

    print(json.dumps({"metric": "ieee33_weak_scaling",
                      "per_device_batch": args.per_device,
                      "results": results}))


if __name__ == "__main__":
    main()
