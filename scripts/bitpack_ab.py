#!/usr/bin/env python3
"""Time B1/B2 (`pack_blocks`, `unpack_blocks`) of this tree against the same
C entry points built from another tree, on the same inputs, on one GPU.

    python3 scripts/bitpack_ab.py OTHER_DIR [--iters 100] [--rounds 2] [--out FILE]

OTHER_DIR is the root of another checkout of this repo (the parent commit,
say, unpacked with `git archive` into a directory `.gitignore` lists). Its
`src/repro_torch/kernels/build.py`, loaded on its own, builds that tree's
library into OTHER_DIR/build/; this tree's kernels run through
`repro_torch.kernels.ops`. The inputs are chip_smoke.py's timing-phase
inputs: the tcomp32 path's first fused chunk of 64 MiB of Rovio (seed 7),
128 blocks x 2,048 symbols, OW 4,098. Each round times this tree, the
other, the other, this tree, each with `chip_smoke.time_ms` (CUDA events
over `--iters` launches queued behind a device sleep); the two trees'
outputs must be equal bit for bit. Prints one JSON line per timing and a
last line with each kernel's median per tree (ms), next to the card's name
and power limit as nvidia-smi reports them.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import FULL_BYTES, CompressionPipeline, JobSpec, bits, make_dataset, ops  # noqa: E402


def load_build(tree: Path):
    """The other tree's `kernels/build.py` as a module of its own (it
    imports only the standard library), so its library builds from its
    sources into its own build directory."""
    spec = importlib.util.spec_from_file_location(
        "other_build", tree / "src" / "repro_torch" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def path_chunk(dev):
    """(codes, bitlen, symbols, out_words) of the tcomp32 path's first chunk."""
    values = make_dataset("rovio", n_tuples=FULL_BYTES // 16, seed=7).stream()
    pipe = CompressionPipeline(JobSpec(), device=dev)
    shaped = pipe.shape_blocks(values[: pipe.plan.scan_chunk * pipe.block_tuples])
    blocks = bits.u32_tensor(shaped.blocks, dev)
    _, enc = pipe.codec.encode_blocks(pipe.init_state(), blocks)
    c, s = blocks.shape[0], pipe.block_tuples
    return enc.codes.reshape(c * s, 2).contiguous(), enc.bitlen.reshape(c * s).contiguous(), s, 2 * s + 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bitpack_ab: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    other = load_build(args.other.resolve())
    lib = other.library()
    codes, blen, s, ow = path_chunk(dev)
    nb = blen.shape[0] // s
    stream = torch.cuda.current_stream(dev).cuda_stream

    def other_pack():
        words = torch.empty((nb, ow), dtype=torch.int32, device=dev)
        nbits = torch.empty((nb,), dtype=torch.int32, device=dev)
        other.check(lib.repro_pack_blocks(codes.data_ptr(), blen.data_ptr(), nb, s, ow,
                                          words.data_ptr(), nbits.data_ptr(), stream), "pack_blocks")
        return words, nbits

    words, nbits = ops.pack_blocks(codes, blen, block=s, out_words=ow)

    def other_unpack():
        out = torch.empty((nb * s, 2), dtype=torch.int32, device=dev)
        other.check(lib.repro_unpack_blocks(words.data_ptr(), nb, ow, blen.data_ptr(), s,
                                            out.data_ptr(), stream), "unpack_blocks")
        return out

    fns = {
        ("pack_blocks", "this"): lambda: ops.pack_blocks(codes, blen, block=s, out_words=ow),
        ("pack_blocks", "other"): other_pack,
        ("unpack_blocks", "this"): lambda: ops.unpack_blocks(words, blen),
        ("unpack_blocks", "other"): other_unpack,
    }
    for kernel in ("pack_blocks", "unpack_blocks"):
        a, b = fns[(kernel, "this")](), fns[(kernel, "other")]()
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{kernel}: the two trees' outputs differ")
    cycles = chip_smoke.sleep_cycles_per_ms()
    times = {key: [] for key in fns}
    lines = []
    for r in range(args.rounds):
        for kernel in ("pack_blocks", "unpack_blocks"):
            for tree in ("this", "other", "other", "this"):
                ms, host_ms = chip_smoke.time_ms(fns[(kernel, tree)], args.iters, cycles)
                times[(kernel, tree)].append(ms)
                lines.append({"round": r, "kernel": kernel, "tree": tree, "ms": ms, "host_ms": host_ms})
                print(json.dumps(lines[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    summary = {"card": smi.splitlines()[0], "other": str(args.other), "iters": args.iters,
               "median_ms": {f"{k}/{t}": statistics.median(v) for (k, t), v in times.items()}}
    print(json.dumps(summary), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines + [summary]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
