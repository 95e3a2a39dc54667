"""The benchmark's harness: finds a cell's files by name, sets the cell up,
measures its window, reduces the trace to per-layer metrics, checks the
outputs against the reference and prints the result line.

Everything that belongs to one configuration, traffic mix, cell, entry or
per-layer metric is a file of its own, found by the name that
`BENCHMARK.json` gives it:

    benchmark/configs/<config>.json     model sizes, rig, tracker, precision
    benchmark/traffic/<traffic>.json    traffic parameters (generate.py reads them)
    benchmark/workloads/<cell>.json     the entry, traced calls, compared numbers and limits
    benchmark/entries/<entry>.py        how a call into the program is made and checked
    benchmark/metrics/<metric>.py       read(window or trace) -> value; a per-layer
                                        reader returns None where it finds nothing
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpupose")
KINDS = {"configs": ".json", "traffic": ".json", "workloads": ".json",
         "entries": ".py", "metrics": ".py"}


def find(kind, name, roots=(HERE,)):
    """The file of `kind` named `name` under the first root that has it."""
    for root in roots:
        path = Path(root) / kind / (name + KINDS[kind])
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind} file named {name!r} under {[str(r) for r in roots]}")


def load_json(kind, name, roots=(HERE,)):
    return json.loads(find(kind, name, roots).read_text())


def load_module(kind, name, roots=(HERE,)):
    path = find(kind, name, roots)
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}".replace(".", "_")
                                                  .replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def subseed(seed, tag):
    """A 63-bit seed for one use (`tag`) of the run's seed."""
    import numpy as np

    data = [int(seed) & 0xFFFFFFFF, int(seed) >> 32, *tag.encode()]
    return int(np.random.SeedSequence(data).generate_state(1, np.uint64)[0] >> 1)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_line():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def quantile(values, q):
    """The q-quantile of `values`, linear between order statistics."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Spans:
    """Host spans around the program's layers: (name, seconds, frames),
    each ended by a device sync so that it holds the layer's device work,
    and marked for the profiler with `record_function`."""

    def __init__(self, torch, device):
        self.torch, self.device, self.done = torch, device, []

    def wrap(self, name, fn, frames_of):
        torch = self.torch

        def spanned(*args, **kwargs):
            with torch.profiler.record_function(f"span:{name}"):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.done.append((name, time.perf_counter() - t0, frames_of(args, kwargs)))
            return out

        return spanned


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(torch, device, fn):
    """fn() under torch.profiler: the device's kernels and copies, the
    spans' ranges and the whole slice's, as (name, start, end) in the
    profiler's µs."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function("span:slice"):
            fn()
            _sync(torch, device)
    kernels, spans, whole = [], [], None
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.name.startswith("span:"):  # the spans' own marks on the device's timeline
                kernels.append((e.name, e.time_range.start, e.time_range.end))
        elif e.name.startswith("span:"):
            rng = (e.time_range.start, e.time_range.end)
            if e.name == "span:slice":
                whole = rng
            else:
                spans.append((e.name[5:], *rng))
    return kernels, spans, whole


def union_us(intervals):
    """Total µs covered by (start, end) intervals, and the gaps between them."""
    iv = sorted(intervals)
    if not iv:
        return 0.0, []
    busy, gaps = 0.0, []
    lo, hi = iv[0]
    for s, e in iv[1:]:
        if s > hi:
            busy += hi - lo
            gaps.append((hi, s))
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return busy + hi - lo, gaps


def reduce_trace(kernels, spans, whole, frames):
    """The trace reduced for the metric readers and the breakdown."""
    lo, hi = whole
    inside = [k for k in kernels if k[1] >= lo and k[2] <= hi]
    busy, gaps = union_us([(s, e) for _, s, e in inside])
    by_name = {}
    for name, s, e in inside:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    labelled = []
    for s, e in gaps:
        mid = (s + e) / 2
        label = next((n for n, a, b in spans if a <= mid <= b), "host")
        labelled.append((label, (e - s) / 1e6))
    labelled.sort(key=lambda g: -g[1])
    return SimpleNamespace(kernels=inside, spans=spans, slice_s=(hi - lo) / 1e6,
                           busy_s=busy / 1e6, frames=frames, kernel_s=by_name,
                           gaps=labelled)


def kernels_in(trace, span_name):
    """Device kernels that start inside the profiled spans named `span_name`."""
    ranges = [(a, b) for n, a, b in trace.spans if n == span_name]
    return [k for k in trace.kernels if any(a <= k[1] <= b for a, b in ranges)]


def family_seconds(trace, include, exclude=()):
    """Device seconds of the kernels whose names hold one of `include`'s
    substrings and none of `exclude`'s."""
    return sum(s for name, s in trace.kernel_s.items()
               if any(p in name for p in include) and not any(p in name for p in exclude))


def _finite(value):
    """A compared number for the JSON line: NaN and infinities read 1e30."""
    return 1e30 if isinstance(value, float) and not math.isfinite(value) else value


def run_cell(bench, cell_name, seed, seconds, trace, device, roots=(HERE,), control=False,
             t_start=None):
    """Set up, measure and check one cell on `device`. Returns the result
    line's object, every number the check computed, and the run's
    figures for the earlier lines (window, calls, counters)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    ctx = SimpleNamespace(
        seed=seed, device=torch.device(device), control=control, roots=roots,
        cell=cell, spec=load_json("workloads", cell_name, roots),
        config=load_json("configs", cell["config"], roots),
        traffic=load_json("traffic", cell["traffic"], roots), log=log)
    entry = load_module("entries", ctx.spec["entry"], roots)
    with contextlib.redirect_stdout(sys.stderr):
        live = entry.setup(ctx)
    _sync(torch, ctx.device)
    spans = Spans(torch, ctx.device)
    if trace:
        live.instrument(spans)
    if ctx.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx.device)

    latencies = []
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    t_end = t_window
    while True:
        t0 = time.perf_counter()
        live.call(len(latencies))
        _sync(torch, ctx.device)
        t_end = time.perf_counter()
        latencies.append(t_end - t0)
        if t_end - t_window >= seconds:
            break
    window_s = t_end - t_window
    calls = len(latencies)
    frames = calls * live.frames_per_call
    window_spans = list(spans.done)

    traced = None
    if trace:
        n = int(ctx.spec["traced_calls"])
        first = calls

        def traced_calls():
            for i in range(first, first + n):
                live.call(i)
            _sync(torch, ctx.device)

        kernels, prof_spans, whole = _profile(torch, ctx.device, traced_calls)
        traced = reduce_trace(kernels, prof_spans, whole, n * live.frames_per_call)
    peak = (torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0)

    t_check = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        numbers = live.check()
    check_s = time.perf_counter() - t_check
    compared = {k: {"value": _finite(numbers.get(k)), "limit": v}
                for k, v in ctx.spec["checks"].items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in compared.values())

    metrics = {}
    if not trace:
        window = SimpleNamespace(latencies=latencies, frames=frames, window_s=window_s,
                                 setup_s=setup_s, calls=calls)
        for m in bench["end_to_end"]:
            if cell_name in m.get("workloads", [cell_name]):
                value = load_module("metrics", m["name"], roots).read(window)
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": calls, "failed": 0}
    extra = {"window_s": window_s, "calls": calls, "frames": frames, "check_s": check_s,
             "clip_ms_p50": quantile(latencies, 0.5) * 1e3,
             "clip_ms": [round(x * 1e3, 3) for x in latencies[:8]],
             **live.counters()}
    if trace:
        data = SimpleNamespace(trace=traced, window_spans=window_spans, peak_bytes=peak,
                               device_kind=kind, work=live.work(),
                               kernels_in=lambda name: kernels_in(traced, name),
                               family_seconds=lambda inc, exc=(): family_seconds(traced, inc, exc))
        for m in bench["per_layer"]:
            if cell_name not in m.get("workloads", [cell_name]):
                continue
            value = load_module("metrics", m["name"], roots).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.slice_s
        result["breakdown"] = {
            "device_ops": [[n[:200], s] for n, s in
                           sorted(traced.kernel_s.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[n, s] for n, s in traced.gaps[:10]]}
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = compared
    return result, numbers, extra


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the cell's control (a lower precision) in place of the "
                        "program, to read where its check fails")
    args = p.parse_args(argv)
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        log(f"benchmark: no cell named {args.workload!r}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"benchmark: the cell needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    result, numbers, extra = run_cell(bench, args.workload, args.seed, args.seconds,
                                      args.trace, "cuda", control=args.control, t_start=t_start)
    found = forbidden_modules()
    if found:
        log(f"benchmark: the run loaded {found}; nothing of JAX or the JAX package may load")
        return 3
    log("numbers: " + json.dumps(numbers))
    log("run: " + json.dumps(extra))
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
