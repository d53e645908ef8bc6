"""Run one cell of the benchmark and print its result as the last line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``),
which names the driver that runs it (``drivers/<driver>.py``). A run makes
the weights and inputs from the seed on the card, builds and warms the
program up (``setup_s``, from the process's start), measures for
``--seconds``, reads the card's peak memory, frees the program, and decides
``correct`` against the plain reference. ``--trace 1`` measures the same
window under the profiler and reports the per-layer metrics
(``metrics/<name>.py``) instead of the end-to-end ones.

It refuses to run without as many CUDA cards as the cell asks for, and
fails if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import time

T_IMPORT = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux /proc), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE_AT_IMPORT = _process_age()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# the JAX side of the repo, by whole top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "diffusionremotesensing_tpu")


def cache_dirs() -> None:
    """Every kernel cache at a fixed place inside the checkout (the port
    builds its CUDA libraries into its own ``build/``)."""
    base = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("USE_JAX", "0")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find(bench: dict, workload: str):
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    traffic = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    return cell, config, traffic, driver


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones (a metric with ``workloads`` only in the cells listed)."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             config: dict = None, traffic: dict = None, setup_t0: float = None) -> dict:
    """One run of a cell on ``device``: set-up, the window (traced with
    ``trace``), the peak memory, the check. ``config`` and ``traffic``
    replace the cell's files (tests run a cell at a small size on the CPU).
    Returns the result line's fields and ``checks``."""
    import torch

    cell, cfg, tr, driver = find(bench, workload)
    cfg, tr = config or cfg, traffic or tr
    c = driver.Cell(cfg, tr, seed, device)
    c.setup()
    setup_s = (AGE_AT_IMPORT + time.perf_counter() - T_IMPORT if setup_t0 is None
               else time.perf_counter() - setup_t0)
    reading = {} if trace else None
    if trace:
        from portbench import trace as trace_mod

        with trace_mod.profiled(reading):
            run = c.window(seconds)
    else:
        run = c.window(seconds)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = {"config": cfg, "traffic": tr, "run": run, "work": c.context(run), "trace": reading}
    c.free()
    if cuda:
        torch.cuda.empty_cache()
    limits = tr["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in c.check().items()}
    correct = run["failed"] == 0 and all(v["value"] <= v["limit"] for v in checks.values())
    metrics = {}
    if trace:
        for m in metrics_for(bench, workload, True):
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = c.end_to_end(run)
        e2e["setup_s"] = (setup_s, "s")
        for m in metrics_for(bench, workload, False):
            v, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": peak}
    if trace:
        dev.update(busy_s=reading["busy_s"], window_s=reading["window_s"])
    out = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = reading["breakdown"]
    out["checks"] = checks
    out["_summary"] = (f"{workload} seed {seed}: {run['units']} units, window "
                       f"{run['seconds']:.3f} s, setup {setup_s:.3f} s"
                       + (f", arrivals late by up to {run['late_s']:.4f} s" if "late_s" in run else ""))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()

    import torch

    bench = load_json(ROOT, "BENCHMARK.json")
    chips = find(bench, args.workload)[0]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"portbench: {chips} CUDA card(s) needed, found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}, which the port must not use", file=sys.stderr)
        return 3
    print(f"portbench: {out.pop('_summary')}", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
