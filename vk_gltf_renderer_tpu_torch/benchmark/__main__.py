"""Benchmark harness CLI of the port (reference
vk_gltf_renderer_tpu/benchmark/__main__.py; upstream
utils/benchmark/benchmark.py, benchmark_runner.py, benchmark_results.py;
workflow: docs/benchmarking.md).

    python -m vk_gltf_renderer_tpu_torch.benchmark headless --scene X [--spp 1 5] [--device cuda] ...
    python -m vk_gltf_renderer_tpu_torch.benchmark run matrix.cfg [--device cuda]
    python -m vk_gltf_renderer_tpu_torch.benchmark compare old.csv new.csv

`headless` runs the port's headless CLI in-process for each spp, parses the
BENCHMARK_JSON record, appends to a CSV. `run` executes a .cfg sequencer
file (each line = extra CLI flags, the ParameterSequencer analog).
`compare` flags regressions: >threshold% frame time or >64 MB device
memory (docs/benchmarking.md:134-137). Each row's peak_bytes is the card's
allocator peak over that row's run alone (0 on the CPU).
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

CSV_FIELDS = [
    "timestamp",
    "scene",
    "width",
    "height",
    "spp",
    "frames",
    "ms_per_frame",
    "throughput_MSps",
    "Mrays_per_sec",
    "triangles",
    "max_depth",
    "env",
    "renderer",
    "peak_bytes",
]


def _run_headless(argv, device) -> dict | None:
    import torch

    from ..device import resolve_device
    from ..headless import main as headless_main
    from ..utils.profiler import device_memory_stats

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = headless_main(argv + ["--device", str(dev)])
    out = buf.getvalue()
    sys.stdout.write(out)
    if rc != 0:
        return None
    for line in out.splitlines():
        if line.startswith("BENCHMARK_JSON "):
            rec = json.loads(line.split(" ", 1)[1])
            rec["peak_bytes"] = device_memory_stats(dev)["peak_bytes_in_use"]
            return rec
    return None


def _append_rows(path, rows) -> None:
    out = Path(path)
    exists = out.exists()
    with out.open("a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_FIELDS, extrasaction="ignore")
        if not exists:
            w.writeheader()
        for r in rows:
            w.writerow(r)
    print(f"wrote {len(rows)} rows -> {out}")


def cmd_headless(args) -> int:
    rows = []
    for spp in args.spp:
        argv = [
            "--headless", "--scenefile", args.scene,
            "--size", str(args.size[0]), str(args.size[1]),
            "--frames", str(args.frames), "--maxFrames", str(args.frames),
            "--ptSamples", str(spp), "--renderSystem", str(args.renderSystem),
            "--envSystem", str(args.envSystem),
        ]
        if args.hdr:
            argv += ["--hdrfile", args.hdr]
        rec = _run_headless(argv, args.device)
        if rec is None:
            print(f"FAILED spp={spp}", file=sys.stderr)
            return 1
        rec["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        rows.append(rec)
    _append_rows(args.output, rows)
    return 0


def cmd_run(args) -> int:
    """Sequencer: each non-comment line of the .cfg is extra CLI flags
    (ParameterSequencer semantics, docs/benchmarking.md:116-122)."""
    cfg = Path(args.config)
    base = ["--headless"]
    rows = []
    for ln, line in enumerate(cfg.read_text().splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        argv = base + line.split()
        print(f"--- [{ln}] {' '.join(argv)}")
        rec = _run_headless(argv, args.device)
        if rec is None:
            print(f"sequence line {ln} FAILED", file=sys.stderr)
            return 1
        rec["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        rows.append(rec)
    if args.output:
        _append_rows(args.output, rows)
    return 0


def cmd_compare(args) -> int:
    """Build-vs-build regression compare (benchmark_results.py compare_csv;
    thresholds docs/benchmarking.md:134-137)."""

    def load(p):
        # key on the FULL config — height/depth/env changes must not alias
        # rows (reference keys every registered parameter of the sequence)
        with open(p, newline="") as f:
            keyf = ("scene", "spp", "width", "height", "max_depth", "env", "renderer")
            return {tuple(r.get(k, "") for k in keyf): r for r in csv.DictReader(f)}

    old = load(args.old)
    new = load(args.new)
    regressions = []
    for key, n in new.items():
        o = old.get(key)
        if not o:
            continue
        try:
            dt = (float(n["ms_per_frame"]) - float(o["ms_per_frame"])) / max(float(o["ms_per_frame"]), 1e-9) * 100
        except (KeyError, ValueError):
            continue
        dm = (int(n.get("peak_bytes", 0) or 0) - int(o.get("peak_bytes", 0) or 0)) / (1024 * 1024)
        status = "OK"
        if dt > args.threshold:
            status = f"REGRESSION time +{dt:.1f}%"
            regressions.append(key)
        elif dm > args.mem_threshold_mb:
            status = f"REGRESSION mem +{dm:.0f} MB"
            regressions.append(key)
        print(f"{key}: {float(o['ms_per_frame']):.2f} -> {float(n['ms_per_frame']):.2f} ms ({dt:+.1f}%), mem {dm:+.0f} MB  [{status}]")
    if regressions:
        print(f"{len(regressions)} regression(s)", file=sys.stderr)
        return 1
    print("no regressions")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vk_gltf_renderer_tpu_torch.benchmark")
    sub = p.add_subparsers(dest="cmd", required=True)

    h = sub.add_parser("headless", help="timed headless runs -> CSV")
    h.add_argument("--scene", required=True)
    h.add_argument("--hdr", default=None)
    h.add_argument("--size", type=int, nargs=2, default=[1920, 1080])
    h.add_argument("--frames", type=int, default=20)
    h.add_argument("--spp", type=int, nargs="+", default=[1])
    h.add_argument("--renderSystem", type=int, default=0)
    h.add_argument("--envSystem", type=int, default=0)
    h.add_argument("--output", default="headless_results.csv")
    h.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    h.set_defaults(fn=cmd_headless)

    r = sub.add_parser("run", help="run a .cfg sequencer file")
    r.add_argument("config")
    r.add_argument("--output", default=None)
    r.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    r.set_defaults(fn=cmd_run)

    c = sub.add_parser("compare", help="regression compare two CSVs")
    c.add_argument("old")
    c.add_argument("new")
    c.add_argument("--threshold", type=float, default=5.0, help="frame-time %% regression gate")
    c.add_argument("--mem-threshold-mb", type=float, default=64.0)
    c.set_defaults(fn=cmd_compare)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
