"""Capture a jax.profiler trace of the benchmark step and summarize it.

Produces the kernel-level evidence for docs/performance.md: total device
kernel count per step, launch-bound vs compute-bound split, and the top-N
fusions by total device time.  The .xplane.pb protobuf is parsed with a
built-in minimal decoder (tsl/profiler xplane schema) — no tensorflow /
tensorboard dependency.

Usage: python scripts/trace_step.py [batch] [--task ieee33|multicap] [--steps 64] [--top 25]
"""

import collections
import glob
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# minimal protobuf wire-format decoder (schema-directed)
# ---------------------------------------------------------------------------
def _read_varint(buf, i):
    out = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf):
    """Yield (field_number, wire_type, value) over one message buffer."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _read_varint(buf, i)
        elif wt == 1:
            val, i = buf[i : i + 8], i + 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i : i + ln], i + ln
        elif wt == 5:
            val, i = buf[i : i + 4], i + 4
        else:
            raise ValueError(f"wire type {wt}")
        yield fnum, wt, val


def parse_xspace(path):
    """-> list of planes: {name, lines: [{name, events:[(meta_id, dur_ps)]}],
    event_names: {id: name}}."""
    data = open(path, "rb").read()
    planes = []
    for fnum, _wt, val in _fields(data):
        if fnum != 1:  # XSpace.planes
            continue
        plane = {"name": "", "lines": [], "event_names": {}}
        for pf, _pwt, pval in _fields(val):
            if pf == 2:
                plane["name"] = pval.decode()
            elif pf == 3:  # XLine
                line = {"name": "", "events": []}
                for lf, _lwt, lval in _fields(pval):
                    if lf == 2:
                        line["name"] = lval.decode()
                    elif lf == 4:  # XEvent
                        meta_id = dur = 0
                        for ef, _ewt, eval_ in _fields(lval):
                            if ef == 1:
                                meta_id = eval_
                            elif ef == 3:
                                dur = eval_
                        line["events"].append((meta_id, dur))
                plane["lines"].append(line)
            elif pf == 4:  # map<int64, XEventMetadata>
                kid, name, disp = None, "", ""
                for mf, _mwt, mval in _fields(pval):
                    if mf == 1:
                        kid = mval
                    elif mf == 2:  # XEventMetadata
                        for emf, _emwt, emval in _fields(mval):
                            if emf == 1:
                                kid = emval if kid is None else kid
                            elif emf == 2:
                                name = emval.decode()
                            elif emf == 4:
                                disp = emval.decode()
                if kid is not None:
                    plane["event_names"][kid] = disp or name
        planes.append(plane)
    return planes


def summarize(trace_dir, n_steps_total, top=25):
    files = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True)
    assert files, f"no xplane.pb under {trace_dir}"
    device_planes = []
    for f in files:
        for plane in parse_xspace(f):
            # Real accelerator planes only ('/device:GPU:0', ...); custom
            # planes carry no kernels of their own.
            if "/device:" in plane["name"] and "CUSTOM" not in plane["name"]:
                device_planes.append(plane)
    assert device_planes, "no device plane found in trace"

    per_kernel = collections.Counter()   # name -> total ps
    per_kernel_n = collections.Counter()
    total_events = 0
    for plane in device_planes:
        names = plane["event_names"]
        for line in plane["lines"]:
            lname = line["name"].lower()
            if "step" in lname and "xla" not in lname:
                continue  # steptrace line duplicates op events
            for meta_id, dur in line["events"]:
                name = names.get(meta_id, f"#{meta_id}")
                per_kernel[name] += dur
                per_kernel_n[name] += 1
                total_events += 1

    total_ps = sum(per_kernel.values())
    print(f"\ndevice planes: {[p['name'] for p in device_planes]}")
    print(f"total device events: {total_events} "
          f"({total_events / n_steps_total:.1f} per env-step-scan-step)")
    print(f"total device busy time: {total_ps/1e9:.3f} ms "
          f"({total_ps/1e9/n_steps_total*1000:.1f} us/step)")
    print(f"\ntop {top} kernels by device time:")
    print(f"{'us/step':>9} {'count/step':>11}  name")
    for name, ps in per_kernel.most_common(top):
        print(f"{ps/1e6/n_steps_total:9.2f} {per_kernel_n[name]/n_steps_total:11.2f}  {name[:100]}")


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    batch = int(args[0]) if args else 8192
    argstr = " ".join(sys.argv[1:])
    which = "multicap" if ("--task=multicap" in sys.argv
                           or "--task multicap" in argstr) else "ieee33"
    top = 25
    for a in sys.argv:
        if a.startswith("--top="):
            top = int(a.split("=")[1])

    from gym_anm_tpu.vec import VecEnv, make_ieee33_multicap_task, make_ieee33_task

    task = (make_ieee33_task if which == "ieee33" else make_ieee33_multicap_task)()
    env = VecEnv(task, dtype=jnp.float32)
    auto = which != "ieee33"

    lo, hi = env.action_low, env.action_high
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    state, obs = jax.jit(jax.vmap(env.reset))(keys)
    step = env.step_autoreset_batch if auto else (
        lambda st, a: jax.vmap(env.step)(st, a))
    n_steps = 64

    def run(state, obs, seed):
        def body(carry, t):
            st, obs = carry
            k = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            acts = lo + jax.random.uniform(k, (batch, env.n_action), dtype=env.dtype) * (hi - lo)
            st, obs, r, d, _ = step(st, acts)
            return (st, obs), r.sum()

        (state, obs), rs = jax.lax.scan(body, (state, obs), jnp.arange(n_steps))
        return state, obs, rs.sum()

    run_jit = jax.jit(run, donate_argnums=(0,))
    state, obs, tot = run_jit(state, obs, 0)  # compile + warm
    jax.block_until_ready(tot)

    # A fresh directory per run (under $TMPDIR): the recursive glob in
    # summarize() would otherwise sum an older dump with this one, and two
    # checkouts tracing on one machine would overwrite each other's.
    trace_dir = tempfile.mkdtemp(prefix=f"jax-trace-{which}-{batch}-")
    print(f"trace: {trace_dir}")
    n_reps = 2
    with jax.profiler.trace(trace_dir):
        for rep in range(n_reps):
            state, obs, tot = run_jit(state, obs, rep + 1)
        jax.block_until_ready(tot)

    summarize(trace_dir, n_steps_total=n_steps * n_reps, top=top)


if __name__ == "__main__":
    main()
