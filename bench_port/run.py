"""Run one cell of the port's benchmark once and print one JSON line.

    python3 -m bench_port.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `bench_port/` and
the port, `gpt_sovits_tpu_torch/`, on a machine with the cards the cell
asks for. Everything is found by name: the cell in `BENCHMARK.json`, its
configuration file, its traffic mix (`traffic/<traffic>.json`), its limits
and traced slice (`workloads/<cell>.json`), the configuration's family
(`families/<family>.py`), the mix's driver (`drivers/<driver>.py`) and each
metric's reader (`metrics/<metric>.py`).

A run builds the configuration on the card from the seed, warms one request
of each size the mix sends, then lets the mix's closed-loop callers run for
`--seconds`. A request counts where it completed inside the window; a rate
is its work over the time from the window's start to the last such
completion. After the window, requests still in flight are waited for, the
peak memory is read, the program is freed, and a sample of the completed
requests, drawn from the seed, is held against the plain reference
(`reference/`): `correct` is every compared number within its limit and no
request failed. With `--trace 1` the metrics are the cell's per-layer ones,
read from spans, counters and a profiled slice of the window; with
`--trace 0` its end-to-end ones.

The run exits non-zero and prints no result without enough cards, without
the port, or when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gpt_sovits_tpu")
WAIT_AFTER_CLOSE_S = 120.0
POLL_S = 0.005  # the dispatcher's sleep when nothing has returned: 200 wake-ups a second


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's (the whole name before the first dot: the port's own name
    begins with the JAX package's)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell as `BENCHMARK.json` and the files it names describe it."""

    def __init__(self, bench: dict, name: str):
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.entry, self.chips = name, entry, int(entry["chips"])
        conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
        self.cfg = load_json(Path(conf["file"]))
        self.mix = load_json(HERE / "traffic" / f"{entry['traffic']}.json")
        self.spec = load_json(HERE / "workloads" / f"{name}.json")
        moves = set()
        self.end_to_end = []
        for m in bench["end_to_end"]:
            if "workloads" not in m or name in m["workloads"]:
                self.end_to_end.append(m)
                moves.add(m["name"])
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


class Run:
    """What a run measured, as the metrics' readers see it."""

    def __init__(self, cell: Cell, seed: int):
        self.cell, self.cfg, self.mix, self.seed = cell, cell.cfg, cell.mix, seed
        self.records: list = []  # every request sent in the window, in order of completion
        self.done: list = []  # those completed inside it
        self.t0 = self.t_end = 0.0
        self.window_s = 0.0  # the window's start to its last completion
        self.counters0: dict = {}
        self.counters1: dict = {}
        self.k1_calls: list = []  # (host time, write slots) of each K1 step, traced runs only
        self.reading = None  # the traced slice (trace.Reading)
        self.traced = None  # the request the slice profiled, where the slice is one request
        self.setup_s = 0.0
        self.power_limit_w = None
        self.sentences = None


def power_limit() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class K1Spy:
    """A span around each call of the S1 step kernel's entry
    (`ops/decode_step.py fused_decode_step`): the host time and the rows'
    write slots, which the pool passes as a host list."""

    def __init__(self, out: list):
        from gpt_sovits_tpu_torch.ops import decode_step

        self.module, self.out = decode_step, out
        self.inner = decode_step.fused_decode_step

        def spy(x, weights, kv_cache, mask, write_idx, *args, **kw):
            self.out.append((time.perf_counter(), list(write_idx) if isinstance(write_idx, (list, tuple)) else
                             [int(write_idx)] * x.shape[0]))
            return self.inner(x, weights, kv_cache, mask, write_idx, *args, **kw)

        decode_step.fused_decode_step = spy

    def close(self):
        self.module.fused_decode_step = self.inner


def warm_requests(mix: dict, seed: int) -> list:
    """One request of each shape the mix sends, from a stream of their own."""
    from bench_port import traffic

    seq = traffic.Requests(mix, seed ^ 0x5EED)
    want = {json.dumps(v, sort_keys=True) for v in mix["shapes"]["values"]}
    out = {}
    while len(out) < len(want):
        r = seq.next()
        key = json.dumps({"segments": len(r["sentences"]), **({"max_sec": r["max_sec"]} if r["max_sec"] else {})},
                         sort_keys=True)
        out.setdefault(key, r)
    return list(out.values())


def warm_profiler() -> None:
    """One short slice in set-up: the profiler's first start in a process
    (CUPTI's set-up) takes seconds, which a slice in the window must not."""
    import torch

    from bench_port.trace import Slice

    with Slice():
        torch.ones(1, device="cuda").add_(1)


def run_window(run: Run, driver, seconds: float, trace: bool, device="cuda") -> None:
    """The closed loop: `clients` callers, each sending its next request when
    its last one has returned, for `seconds`; then every request in flight is
    waited for. Several callers are one dispatcher in the main thread, which
    submits, polls for what has returned and submits again (`dispatch`); one
    caller calls the driver's blocking entry. A traced run profiles the
    slices the cell's file names: stretches of time at fractions of the
    window (`offsets`, from a helper thread), or whole requests, the first
    sent after each fraction (`after`); they are read after the window, and
    the first whose kernels match the launch counts is the run's."""
    from bench_port import traffic
    from bench_port.trace import Slice

    clients = int(run.mix["clients"])
    seq = traffic.Requests(run.mix, run.seed)
    spec = run.cell.spec.get("trace", {}) if trace else {}
    slices = []
    sync(device)
    run.counters0 = driver.counters()
    run.t0 = time.perf_counter()
    run.t_end = run.t0 + seconds
    if clients == 1:
        marks = [run.t0 + f * seconds for f in spec.get("after", [])]
        while time.perf_counter() < run.t_end:
            rec = {"req": seq.next(), "sent": time.perf_counter()}
            profiled = bool(marks) and rec["sent"] >= marks[0]
            try:
                if profiled:
                    marks.pop(0)
                    rec["profiled"] = True
                    with Slice() as sl:
                        rec.update(driver.call(rec["req"]))
                    slices.append((sl, rec))
                else:
                    rec.update(driver.call(rec["req"]))
            except Exception as e:  # the request failed: counted, and the run is not correct
                rec["error"] = repr(e)
            rec["done"] = time.perf_counter()
            run.records.append(rec)
        run.counters1 = driver.counters()
    else:
        dispatch(run, driver, seq, clients, spec, slices)
    run.done = [r for r in run.records if "error" not in r and r["done"] <= run.t_end]
    last = max((r["done"] for r in run.done), default=run.t_end)
    run.window_s = last - run.t0
    for sl, rec in slices:
        run.reading, run.traced = sl.read(), rec
        if run.reading.matched:
            break


def profile_offsets(run: Run, spec: dict, slices: list) -> None:
    """Time slices of `spec["seconds"]` at the spec's fractions of the
    window, profiled from this (helper) thread while it sleeps."""
    from bench_port.trace import Slice

    for f in spec.get("offsets", []):
        time.sleep(max(0.0, run.t0 + f * (run.t_end - run.t0) - time.perf_counter()))
        with Slice() as sl:
            time.sleep(spec["seconds"])
        slices.append((sl, None))


def dispatch(run: Run, driver, seq, clients: int, spec: dict, slices: list) -> None:
    """`clients` closed-loop callers in one thread: each returned request is
    taken (`ready`, `finish`) and the caller's next one submitted (`start`)
    at once. Time slices are profiled from a helper thread, so that the
    profiler's own start and stop never hold up the callers."""
    inflight: list = []
    counted = False
    profiler = threading.Thread(target=profile_offsets, args=(run, spec, slices), name="profile-slices")
    profiler.start()

    def send():
        rec = {"req": seq.next(), "sent": time.perf_counter()}
        try:
            rec["handle"] = driver.start(rec["req"], rec)
            inflight.append(rec)
        except Exception as e:  # the request failed: counted, and the run is not correct
            rec["error"], rec["done"] = repr(e), time.perf_counter()
            run.records.append(rec)

    for _ in range(clients):
        send()
    while inflight:
        now = time.perf_counter()
        if not counted and now >= run.t_end:
            run.counters1, counted = driver.counters(), True
        if now > run.t_end + WAIT_AFTER_CLOSE_S:
            raise RuntimeError("a request was still in flight two minutes after the window closed")
        returned = [r for r in inflight if driver.ready(r["handle"])]
        for rec in returned:
            rec["done"] = time.perf_counter()
            inflight.remove(rec)
        for rec in returned:
            try:
                rec.update(driver.finish(rec.pop("handle")))
            except Exception as e:
                rec["error"] = repr(e)
            run.records.append(rec)
            if rec["done"] < run.t_end:
                send()
        if not returned:
            time.sleep(POLL_S)
    profiler.join()
    if not counted:
        run.counters1 = driver.counters()


def draw_sample(run: Run) -> list:
    """The requests the reference checks: from those completed in the window,
    the greedy ones first (the longest of them, then others drawn from the
    seed), then others of any sampling; as many as the cell's file says."""
    from bench_port.weights import stream_seed

    n_greedy, n_any = run.cell.spec["sample"]["greedy"], run.cell.spec["sample"]["any"]
    rng = np.random.default_rng(stream_seed(run.seed, "sample"))
    greedy = [r for r in run.done if r["req"]["sampling"].get("top_k") == 1]
    size = lambda r: sum(len(t) for t in r.get("tokens", [])) or sum(len(t) for g in r["groups"] for t in g["tokens"])
    picked = []
    if greedy:
        longest = max(greedy, key=size)
        rest = [r for r in greedy if r is not longest]
        picked = [longest] + [rest[i] for i in rng.permutation(len(rest))[: n_greedy - 1]]
    others = [r for r in run.done if not any(r is p for p in picked)]
    picked += [others[i] for i in rng.permutation(len(others))[:n_any]]
    return [{**r["req"], **{k: v for k, v in r.items() if k not in ("req",)}} for r in picked]


def finite(x: float) -> float | str:
    return x if math.isfinite(x) else "inf"


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda") -> tuple[dict, Run]:
    """One run of the cell: set-up, the window, the metrics, the check.
    Returns the result's fields and the run. `device` "cpu" is for
    rehearsals at small widths."""
    import torch

    from bench_port import traffic

    on_card = torch.device(device).type == "cuda"
    run = Run(cell, seed)
    run.sentences = traffic.load(cell.mix["sentences"])
    family = importlib.import_module(f"bench_port.families.{cell.cfg['family']}")
    driver_cls = importlib.import_module(f"bench_port.drivers.{cell.mix['driver']}").Driver

    pipe = family.build(cell.cfg, seed, device)
    driver = driver_cls(pipe, cell.cfg, cell.mix)
    driver.warm(warm_requests(cell.mix, seed))
    if trace and on_card:
        warm_profiler()
    sync(device)
    run.setup_s = time.perf_counter() - T_START

    spy = K1Spy(run.k1_calls) if trace and cell.spec.get("trace", {}).get("k1_spans") else None
    try:
        run_window(run, driver, seconds, trace, device)
    finally:
        if spy:
            spy.close()
        driver.close()
    sync(device)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    run.power_limit_w = power_limit() if on_card else None

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    failed = sum(1 for r in run.records if "error" in r)
    sample = draw_sample(run)
    del driver, pipe
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = family.check(cell.cfg, seed, device, sample, run.sentences)
    checked = numbers.pop("_checked", {})
    limits = cell.spec["limits"]
    correct = failed == 0 and bool(sample) and all(v <= limits[k] for k, v in numbers.items())
    device_rec = {"platform": "gpu" if on_card else "cpu",
                  "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                  "count": cell.chips, "memory_peak_bytes": int(memory_peak), "power_limit_w": run.power_limit_w}
    result = {"correct": correct, "attempted": len(run.records), "failed": failed, "metrics": metrics,
              "device": device_rec}
    if trace and run.reading is not None:
        device_rec["busy_s"], device_rec["window_s"] = run.reading.busy_s, run.reading.window_s
        device_rec["slice_matched"] = run.reading.matched
        result["breakdown"] = {"device_ops": run.reading.device_ops, "idle_gaps": run.reading.idle_gaps}
    result["checked"] = {**checked, "completed_in_window": len(run.done), "window_s": run.window_s}
    result["checks"] = {k: {"value": finite(v), "limit": limits[k]} for k, v in numbers.items()}
    return result, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    os.environ["USE_FLAX"] = "0"  # libraries that would load JAX on their own
    os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    cell = Cell(load_json(root / "BENCHMARK.json"), args.workload)

    import torch

    # the card is fed from the host: one intra-op thread keeps torch's CPU
    # ops from spinning up idle workers beside the service's own threads
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 3
    import gpt_sovits_tpu_torch  # noqa: F401  (without the port there is nothing to measure)

    result, _ = measure(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the process that prints the result: {', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"correct = {result['correct']} (failed requests {result['failed']} of {result['attempted']})",
          file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
