"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic come from BENCHMARK.json at the
root of the checkout and the files it names: ``benchmark/configs/<config>.json``,
``benchmark/traffic/<traffic>.json`` (whose "driver" names the module under
``benchmark/drivers/``), ``benchmark/limits/<workload>.json`` (the limit of
each number compared) and one reader a metric, ``benchmark/metrics/<name>.py``.
Set-up builds the world from the seed, the program's state and its warm-up
frames; the window then runs closed-loop steps for ``--seconds``; with
``--trace 1`` a fixed number of steps inside it is profiled. Once the window
has closed, a sample of the window's frames, drawn from the seed over the
whole window, is compared with the plain reference (``benchmark/reference``);
a run is correct only if those frames agree and no frame of the window
failed. Exits non-zero, printing no result, without enough CUDA devices or
if JAX or the JAX package got imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "surikatoko_tpu")


class Refused(Exception):
    """The run cannot give a result (exit code 2)."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of the manifest with its configuration, traffic,
    limits and metric entries, found by name."""
    man = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfgs = {c["name"]: c for c in man["configs"]}
    cfg = load_json(root / cfgs[cell["config"]]["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    limits_file = root / "benchmark" / "limits" / f"{name}.json"
    limits = load_json(limits_file) if limits_file.exists() else {}
    applies = lambda m: name in m.get("workloads", [name])
    return dict(cell=cell, cfg=cfg, traffic=traffic, limits=limits,
                end_to_end=[m for m in man["end_to_end"] if applies(m)],
                per_layer=[m for m in man["per_layer"] if applies(m)])


def reader(metric: str, root: Path = ROOT):
    """``read(record)`` of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Reservoir:
    """Which window steps are compared: ``n`` of them, uniform over however
    many steps the window holds, drawn from the seed (reservoir sampling).
    ``slot(k)``, asked before step k, is the place in the sample that step
    k takes (a later step may take it over), or None."""

    def __init__(self, seed: int, n: int):
        import random

        import numpy as np
        ss = np.random.SeedSequence(int(seed)).spawn(5)[4]
        self.rng = random.Random(int(ss.generate_state(1)[0]))
        self.n = n
        self.steps = []

    def slot(self, k: int):
        if k < self.n:
            self.steps.append(k)
            return k
        j = self.rng.randrange(k + 1)
        if j < self.n:
            self.steps[j] = k
            return j
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT, edit=None,
             patch=None, control: bool = False) -> dict:
    """One run of a cell; returns the result (and, under "_readings", the
    numbers compared). ``edit(spec)`` may change the cell's files as read
    (the tests' small sizes), ``patch(cell)`` parts of the program after
    set-up (the tests' faults). ``control``: also the readings of the
    control, the reference in the program's place one precision lower
    (under "_control"); the benchmark's own runs do not make it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.lib import trace as trace_mod
    from benchmark.lib.cell import Spans, full_precision

    spec = load_cell(workload, root)
    if edit is not None:
        edit(spec)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise Refused("no CUDA device")
        if torch.cuda.device_count() < spec["cell"]["chips"]:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell needs {spec['cell']['chips']}")
    full_precision()
    traffic = spec["traffic"]
    drv = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    spans = Spans()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t_import = time.perf_counter()
    cell = drv.Cell(spec["cfg"], traffic, seed, device, spans)
    sync()
    t_cell = time.perf_counter()
    for _ in range(traffic["warmup_frames"]):
        cell.step()
    sync()
    if patch is not None:
        patch(cell)
    sample = Reservoir(seed, traffic["check_frames"])
    base = len(cell.samples)            # samples the driver took in set-up
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    setup_parts = {"imports": t_import - T_START, "cell": t_cell - t_import,
                   "warmup": t0 - t_cell}
    t_lo = traffic["trace_after"]
    t_hi = t_lo + traffic["trace_steps"]
    lat, frames, failed, k, prof, traced = [], 0, 0, 0, None, []
    t_end = t0
    while t_end - t0 < seconds or (trace and k < t_hi):
        if trace and k == t_lo:
            sync()
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []))
            prof.start()
            win = record_function(trace_mod.WINDOW_SPAN)
            win.__enter__()
        j = sample.slot(k)
        if j is not None:
            cell.capture_next()
        spans.step = k
        a = time.perf_counter()
        n, bad = cell.step()
        t_end = time.perf_counter()
        lat.append(t_end - a)
        if j is not None and base + j < len(cell.samples) - 1:
            cell.samples[base + j] = cell.samples.pop()
        frames += n
        failed += bad
        if trace and t_lo <= k < t_hi:
            traced.append(k)
        k += 1
        if trace and k == t_hi:
            win.__exit__(None, None, None)
            sync()
            prof.stop()
    window_s = t_end - t0
    steady = sorted(set(range(k)) - set(traced))
    mem = torch.cuda.max_memory_allocated() if cuda else 0
    rec = dict(seconds=window_s, frames=frames, steps=k, latencies=lat,
               steady=steady, setup_s=setup_s, work=cell.work,
               spans=spans.by_name(steady), trace=None)
    if trace:
        rec["trace"] = trace_mod.reduce(trace_mod.events_of(prof), len(traced))
        prof = None
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cell.release()
    if cuda:
        torch.cuda.empty_cache()
    readings = cell.check()
    if control:
        out_control = cell.control()
    compared = {n: {"value": v, "limit": spec["limits"].get(n)}
                for n, v in sorted(readings.items())}
    compared["failed_frames"] = {"value": failed, "limit": 0}
    correct = (len(cell.samples) > base and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in compared.values()))
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": 1, "memory_peak_bytes": mem}
    out = {"correct": correct, "attempted": frames, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace:
        t = rec["trace"]
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        out["breakdown"] = {"device_ops": [list(x) for x in t.top_ops],
                            "idle_gaps": [list(x) for x in t.idle_gaps]}
    out["compared"] = compared
    out["_readings"] = readings
    out["_setup_parts"] = setup_parts
    out["_slices"] = _per_slice(lat)
    if traced:
        mean_ms = lambda ks: 1e3 * sum(lat[i] for i in ks) / len(ks)
        out["_profiled_ms"] = (mean_ms(traced), mean_ms(steady))
    if control:
        out["_control"] = out_control
    return out


def _per_slice(lat: list, slice_s: float = 2.0) -> list:
    """Steps completed in each ``slice_s`` of the window (how steady the
    rate was within the run)."""
    out, t, n = [], 0.0, 0
    for d in lat:
        t += d
        n += 1
        if t >= slice_s:
            out.append(n)
            t, n = t - slice_s, 0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    os.environ.setdefault("USE_FLAX", "0")
    try:
        out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    bad = forbidden_modules()
    if bad:
        print(f"imported: {', '.join(bad)}", file=sys.stderr)
        return 3
    out.pop("_readings")
    print("setup: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                out.pop("_setup_parts").items()),
          file=sys.stderr)
    print(f"steps a 2 s slice of the window: {out.pop('_slices')}",
          file=sys.stderr)
    if "_profiled_ms" in out:
        print("mean step ms, profiled / other steps: %.4f / %.4f"
              % out.pop("_profiled_ms"), file=sys.stderr)
    for n, c in out["compared"].items():
        print(f"{n} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
