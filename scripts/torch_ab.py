#!/usr/bin/env python3
"""Compare two trees of the PyTorch port on a 64 MiB Rovio cell, on one GPU.

    python3 scripts/torch_ab.py PARENT_DIR . . PARENT_DIR [--reps 3] [--codec tcomp32] [--out FILE]

(`--device cpu --mib 1` rehearses it without a GPU; its device times are 0.)

Each positional argument is the root of a checkout of this repo (one that
holds `src/repro_torch`); the trees run in the order given, each in a fresh
process that imports that tree's `repro_torch` and builds its kernels, so
alternate them (parent, change, change, parent). Every process measures the
same way, with the code of this script, not of the tree: `--reps` timed
roundtrips of `JobSpec(codec=...)` (tcomp32 by default, or tdic32; 4
lanes, 8 KiB micro-batches), or with `--codec heavy` of the heavy tier
`JobSpec(codec="delta_leb128", entropy="rans", egress=True)` (its parse
decodes the rANS blob on the card), on 64 MiB of Rovio (seed 7), each step
on the host clock, then one pass of each
direction under `torch.profiler` for the device's busy time. It prints one
JSON line per roundtrip, then one JSON line per tree with the median, min
and max of every metric over all its roundtrips. The trees must produce the
same wire bytes, and every roundtrip must be exact.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def device_busy_ms(fn, dev) -> float:
    """Device time of every kernel, copy and set `fn` runs, summed over the
    trace's device-side events (a torch op's own entry also carries its
    kernels' time, so summing over all entries would count them twice)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA) / 1e3


def child(tree: str, reps: int, device: str, mib: int, codec: str) -> None:
    """Measure one tree: `reps` roundtrips, then the profiled passes."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch
    from repro_torch.api import JobSpec
    from repro_torch.core import bits
    from repro_torch.core.pipeline import CompressionPipeline, DecompressionPipeline
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_ab: no CUDA device is available")
        build.library()
    values = make_dataset("rovio", n_tuples=(mib << 20) // 16, seed=7).stream()
    spec = (JobSpec(codec="delta_leb128", entropy="rans", egress=True) if codec == "heavy"
            else JobSpec(codec=codec))
    pipe = CompressionPipeline(spec, device=dev)
    decomp = DecompressionPipeline(spec, device=dev)
    decomp.ingest(pipe.compress_to_frame(values[: 8 * pipe.block_tuples]).to_bytes())
    for rep in range(reps):
        t = {}
        t0 = time.perf_counter()
        shaped = pipe.shape_blocks(values)
        t["shape_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = pipe.execute(shaped, collect_payload=True)
        t["execute_s"] = time.perf_counter() - t0
        t["execute_loop_s"] = res.wall_s
        t0 = time.perf_counter()
        wire = pipe.frame_from(shaped, res).to_bytes()
        t["frame_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        parsed = bits.parse_frame(wire, dev)
        t["parse_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dec = decomp.decompress(parsed)
        t["decompress_s"] = time.perf_counter() - t0
        t["decompress_device_loop_s"] = dec.wall_s
        if not np.array_equal(dec.values, values):
            raise AssertionError(f"{tree}: the roundtrip is not exact")
        t["compress_s"] = t["shape_s"] + t["execute_s"] + t["frame_s"]
        t["decode_s"] = t["parse_s"] + t["decompress_s"]
        row = {"tree": tree, "rep": rep, "wire_bytes": len(wire), **t}
        if rep == reps - 1:
            row["busy_compress_ms"] = device_busy_ms(
                lambda: pipe.frame_from(shaped, pipe.execute(shaped, collect_payload=True)), dev)
            row["busy_decompress_ms"] = device_busy_ms(lambda: decomp.ingest(wire), dev)
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="tree roots, in run order")
    ap.add_argument("--reps", type=int, default=3, help="timed roundtrips per process")
    ap.add_argument("--out", help="also append every JSON line to this file")
    ap.add_argument("--device", default="cuda", help="torch device of the runs")
    ap.add_argument("--mib", type=int, default=64, help="stream size in MiB")
    ap.add_argument("--codec", default="tcomp32", choices=("tcomp32", "tdic32", "heavy"),
                    help="the cell's lossless codec, or the heavy tier")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.reps, args.device, args.mib, args.codec)
        return 0
    rows = []
    for tree in args.trees:
        out = subprocess.run(
            [sys.executable, __file__, tree, "--child", tree, "--reps", str(args.reps),
             "--device", args.device, "--mib", str(args.mib), "--codec", args.codec],
            capture_output=True, text=True, timeout=600,
        )
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            raise SystemExit(f"torch_ab: the run of {tree} failed (exit {out.returncode})")
        rows += [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    if len({r["wire_bytes"] for r in rows}) != 1:
        raise AssertionError("the trees wrote different wire bytes")
    lines = [json.dumps(r) for r in rows]
    for tree in dict.fromkeys(args.trees):
        mine = [r for r in rows if r["tree"] == tree]
        summary = {"tree": tree, "roundtrips": len(mine)}
        for key in dict.fromkeys(k for r in mine for k in r):
            if key in ("tree", "rep", "wire_bytes"):
                continue
            got = [r[key] for r in mine if key in r]
            summary[key] = {"median": statistics.median(got), "min": min(got), "max": max(got)}
        lines.append(json.dumps({"summary": summary}))
    for ln in lines:
        print(ln, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
