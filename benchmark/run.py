"""Benchmark of aim_tpu_torch: one cell of BENCHMARK.json a run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Loads the cell from BENCHMARK.json, its configuration from the file the
cell's config names, and its traffic mix from `benchmark/traffic/<mix>.json`;
makes the mix's pool from the seed; warms up with one batch of the cell's
own shape (set-up ends there); runs batches one after another, each
waiting for the last, for `--seconds`; checks the outputs of the window
against the plain reference; prints one JSON line.  With `--trace 0` the
line holds the cell's end-to-end metrics, with `--trace 1` (the window
under torch.profiler) its per-layer metrics, each read by
`benchmark/metrics/<metric>.py`.

`--rehearse` runs the program's plain paths on the CPU at `--pairs` pairs
a batch, and `--control` puts the plain reference, writing mismatches as
`M`, in the program's place; neither prints a metric.
"""

import time

T0 = time.perf_counter()  # set-up: imports, CUDA, the pool, the warm batch

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [p for p in (HERE, ROOT) if p not in sys.path]

BANNED = ("jax", "jaxlib", "flax", "aim_tpu")


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the program's plain paths on the CPU")
    ap.add_argument("--control", action="store_true",
                    help="the plain reference in the program's place")
    ap.add_argument("--pairs", type=int, default=None,
                    help="pairs a batch (rehearsal and tests)")
    return ap.parse_args(argv)


def load_cell(name, root=ROOT):
    """The benchmark, the cell, its configuration and its traffic mix."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def metrics_for(bench, cell, trace: bool):
    """The metric entries this run reports: the cell's end-to-end ones, or
    with a trace its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def card_info():
    """Name and power limit of each card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not read ({exc.__class__.__name__})"
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


def disk_io():
    """This process's bytes sent to storage and cancelled by truncation."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines())
    except OSError:
        return "not read"
    return (f"write_bytes={io.get('write_bytes', '?')} "
            f"cancelled_write_bytes={io.get('cancelled_write_bytes', '?')}")


def cpu_times():
    """CPU seconds this process has used, its threads' included."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def threads():
    try:
        return len(os.listdir("/proc/self/task"))
    except OSError:
        return "?"


class Run:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _window(entry, seconds, trace, torch, control_units=None):
    """Batches one after another until `seconds` have passed (or, for the
    control, one batch a unit); returns (records, window_s, profiler)."""
    records = []
    prof = None
    span = contextlib.nullcontext
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function
    t_start = time.perf_counter()
    with span("window"):
        i = 0
        while True:
            with span("batch"):
                t0 = time.perf_counter()
                try:
                    rec = entry.batch(i)
                except Exception:     # a failed batch counts; the run goes on
                    traceback.print_exc(file=sys.stderr)
                    rec = {"pairs": entry.n, "unit": None, "failed": True}
                t1 = time.perf_counter()
            rec["wall_s"] = t1 - t0
            records.append(rec)
            i += 1
            if control_units is not None:
                if i >= control_units:
                    break
            elif t1 - t_start >= seconds:
                break
    window_s = time.perf_counter() - t_start
    if prof is not None:
        prof.__exit__(None, None, None)
    return records, window_s, prof


def main(argv=None) -> int:
    args = parse_args(argv)
    bench, cell, config, traffic = load_cell(args.workload)
    chips = int(cell["chips"])
    mode = "rehearse" if args.rehearse else "control" if args.control \
        else "gpu"
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")

    import torch
    # One caller, as a read mapper running its own threads sets it: at
    # torch's default, a thread a core, the pool that each pinned copy
    # wakes spins idle between copies, slows the caller and spreads runs.
    torch.set_num_threads(1)
    marks = [("import", time.perf_counter())]
    if mode == "gpu" and not (torch.cuda.is_available()
                              and torch.cuda.device_count() >= chips):
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import aim_tpu_torch.api  # noqa: F401
        import aim_tpu_torch.cli  # noqa: F401
    except ImportError as exc:
        print(f"benchmark: the program is missing ({exc})", file=sys.stderr)
        return 2
    import check
    import devtrace
    import drive
    if mode == "gpu":
        torch.cuda.init()
    marks.append(("cuda", time.perf_counter()))

    workdir = tempfile.mkdtemp(prefix="aim_bench_")
    try:
        ctx = {"config": config, "traffic": traffic, "mode": mode,
               "chips": chips, "seed": args.seed, "workdir": workdir,
               "pairs": args.pairs}
        entry = drive.make(ctx)
        entry.setup()
        marks.append(("pool", time.perf_counter()))
        try:
            if mode != "control":     # the control is not timed
                entry.warm()
        except Exception:     # the window's batches count what fails
            traceback.print_exc(file=sys.stderr)
        cuda = mode == "gpu"
        devs = list(range(chips)) if cuda else []
        for d in devs:
            torch.cuda.synchronize(d)
        setup_s = time.perf_counter() - T0
        marks.append(("warm", T0 + setup_s))
        phases = " ".join(f"{k}={t - t0:.3f}" for (k, t), t0 in
                          zip(marks, [T0] + [t for _, t in marks]))

        control_units = entry.control_units() if mode == "control" else None
        cpu0 = cpu_times()
        records, window_s, prof = _window(entry, args.seconds, args.trace,
                                          torch, control_units)
        cpu_s = cpu_times() - cpu0
        peak = max((torch.cuda.max_memory_allocated(d) for d in devs),
                   default=0)
        trace = None
        if prof is not None:
            path = os.path.join(workdir, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            trace = devtrace.reduce_trace(devtrace.load(path))
            os.remove(path)
        entry.release()
        if cuda:
            torch.cuda.empty_cache()

        failed = sum(r["pairs"] for r in records if r["failed"])
        t_check = time.perf_counter()
        counts = check.total(entry.check(), failed)
        t_check = time.perf_counter() - t_check
        correct = check.passed(counts)

        run = Run(batches=[r for r in records if not r["failed"]],
                  window_s=window_s, setup_s=setup_s, trace=trace,
                  chips=chips, card=torch.cuda.get_device_name(0)
                  if cuda else "cpu", entry=entry, cell=cell, config=config,
                  traffic=traffic)
        metrics = {}
        if mode == "gpu":
            for m in metrics_for(bench, cell, bool(args.trace)):
                value = reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif mode == "rehearse":
            for m in metrics_for(bench, cell, bool(args.trace)):
                value = reader(m["name"])(run)
                if value is not None and m["source"] == "host_clock":
                    metrics["cpu_rehearsal." + m["name"]] = {
                        "value": value, "unit": m["unit"]}

        found = banned_modules()
        if found:
            print(f"benchmark: modules that must not load: {found}",
                  file=sys.stderr)
            return 3
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": run.card, "count": chips,
                  "memory_peak_bytes": int(peak)}
        if trace is not None:
            device["busy_s"] = sum(trace["busy_s"].get(d, 0.0)
                                   for d in range(chips)) / chips
            device["window_s"] = trace["window_s"]
        line = {"correct": correct,
                "attempted": sum(r["pairs"] for r in records),
                "failed": failed, "metrics": metrics, "device": device}
        if mode != "gpu":
            line["mode"] = mode
        if cuda:
            line["card"] = card_info()
        if trace is not None:
            line["breakdown"] = {
                "device_ops": [[k, v] for k, v in trace["device_ops"]],
                "idle_gaps": [[k, v] for k, v in trace["idle_gaps"]]}
        line["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                          for k, v in counts.items()}
        print(f"batches {len(records)} window_s {window_s:.6f} "
              f"setup_s {setup_s:.6f} card {line.get('card', run.card)} "
              f"io {disk_io()}", file=sys.stderr)
        print(f"setup {phases} check_s={t_check:.3f}", file=sys.stderr)
        print(f"host cpu_s={cpu_s:.3f} threads={threads()} "
              f"torch_threads={torch.get_num_threads()} "
              f"cpus={os.cpu_count()}", file=sys.stderr)
        print("batch_ms " + " ".join(f"{r['wall_s'] * 1e3:.1f}"
                                     for r in records), file=sys.stderr)
        for k, v in counts.items():
            print(f"check {k} {v} limit {check.LIMITS[k]}",
                  file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(line), flush=True)
        return 0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
