#!/usr/bin/env python3
"""Time B1/B2/B3 (`pack_blocks`, `unpack_blocks`, `compact_blocks`) and B8's
section form (`rans_section_encode`) of this tree against another tree's, on
the same inputs, on one GPU.

    python3 scripts/bitpack_ab.py OTHER_DIR [--iters 100] [--rounds 2]
        [--kernels pack_blocks,unpack_blocks,compact_blocks,rans_section_encode] [--out FILE]

OTHER_DIR is the root of another checkout of this repo (the parent commit,
say, unpacked with `git archive` into a directory `.gitignore` lists). Its
`src/repro_torch/kernels/build.py`, loaded on its own, builds that tree's
library into OTHER_DIR/build/; this tree's kernels run through
`repro_torch.kernels.ops`. The inputs are chip_smoke.py's timing-phase
inputs: B1-B3 on the tcomp32 path's first fused chunk of 64 MiB of Rovio
(seed 7), 128 blocks x 2,048 symbols, OW 4,098; B8 on the heavy tier's
payload section (the 64 MiB delta_leb128 frame's raw payload, ~34.6 MB),
its table built once for both. B3 is timed kernel against kernel: both
sides allocate `total` with `torch.empty` (a wrapper that zero-fills it
first adds a launch). The other tree's side of B8 is its own
section form (`repro_rans_section_walk`/`_copy`) where it has one, else the
route the entropy stage took before the section form: the bytes widened
into the (C, 512, 8) int32 grid and its mask, the contract kernel
`repro_rans_encode` from the other tree's library, and `assemble_stream`
(whose `int(...)` of the stream length synchronises). Each round times this tree, the other,
the other, this tree, each with `chip_smoke.time_ms` (CUDA events over
`--iters` calls queued behind a device sleep; the B8 route, which
synchronises, unqueued, so its time includes the host's gaps) and, for B8,
`chip_smoke.device_busy_ms` (profiler device time of one call, and per
kernel). The two trees' outputs must be equal bit for bit (B8: states,
counts and the packed stream). Prints one JSON line per timing and a last
line with each median per tree (ms), next to the card's name and power
limit as nvidia-smi reports them.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import FULL_BYTES, CompressionPipeline, JobSpec, bits, entropy, make_dataset, ops  # noqa: E402
from repro_torch.kernels import rans  # noqa: E402

KERNELS = ("pack_blocks", "unpack_blocks", "compact_blocks", "rans_section_encode")


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


def heavy_section(dev) -> torch.Tensor:
    """The heavy tier's payload section bytes (uint8) on the card."""
    values = make_dataset("rovio", n_tuples=FULL_BYTES // 16, seed=7).stream()
    frame = CompressionPipeline(JobSpec(codec="delta_leb128", entropy="rans", egress=True),
                                device=dev).compress_to_frame(values)
    return torch.from_numpy(np.ascontiguousarray(frame.payload, np.uint32).view(np.uint8)).to(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bitpack_ab: no CUDA device is available", file=sys.stderr)
        return 1
    kernels = [k for k in args.kernels.split(",") if k]
    unknown = sorted(set(kernels) - set(KERNELS))
    if unknown:
        raise SystemExit(f"unknown kernels {unknown}; choose from {KERNELS}")
    dev = torch.device("cuda")
    other = load_build(args.other.resolve())
    lib = other.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    fns = {}
    if {"pack_blocks", "unpack_blocks", "compact_blocks"} & set(kernels):
        codes, blen, s, ow = path_chunk(dev)
        nb = blen.shape[0] // s
        words, nbits = ops.pack_blocks(codes, blen, block=s, out_words=ow)

        def other_pack():
            w = torch.empty((nb, ow), dtype=torch.int32, device=dev)
            n = torch.empty((nb,), dtype=torch.int32, device=dev)
            other.check(lib.repro_pack_blocks(codes.data_ptr(), blen.data_ptr(), nb, s, ow,
                                              w.data_ptr(), n.data_ptr(), stream), "pack_blocks")
            return w, n

        def other_unpack():
            out = torch.empty((nb * s, 2), dtype=torch.int32, device=dev)
            other.check(lib.repro_unpack_blocks(words.data_ptr(), nb, ow, blen.data_ptr(), s,
                                                out.data_ptr(), stream), "unpack_blocks")
            return out

        def other_compact():  # kernel against kernel: both write `total`, neither zero-fills it
            payload = torch.empty((nb * ow,), dtype=torch.int32, device=dev)
            total = torch.empty((1,), dtype=torch.int32, device=dev)
            other.check(lib.repro_compact_blocks(words.data_ptr(), nbits.data_ptr(), nb, ow,
                                                 payload.data_ptr(), total.data_ptr(), stream),
                        "compact_blocks")
            return payload, total[0]

        fns["pack_blocks"] = (lambda: ops.pack_blocks(codes, blen, block=s, out_words=ow), other_pack)
        fns["unpack_blocks"] = (lambda: ops.unpack_blocks(words, blen), other_unpack)
        fns["compact_blocks"] = (lambda: ops.compact_blocks(words, nbits), other_compact)
    if "rans_section_encode" in kernels:
        data = heavy_section(dev)
        freqs = entropy.quantize_freqs(torch.bincount(data, minlength=256)).to(torch.int32)
        cum = bits._i32(rans.cum_freqs(freqs))

        def other_route():  # the grid, the contract kernel, the assembly
            syms, mask = rans.chunk_grid(data)
            c = syms.shape[0]
            states = torch.empty((c, rans.N_LANES), dtype=torch.int32, device=dev)
            flags, vals = torch.empty_like(syms), torch.empty_like(syms)
            other.check(lib.repro_rans_encode(syms.data_ptr(), mask.view(torch.uint8).data_ptr(),
                                              freqs.data_ptr(), cum.data_ptr(), c, rans.ROWS,
                                              states.data_ptr(), flags.data_ptr(), vals.data_ptr(),
                                              stream), "rans_encode")
            stream_, counts = rans.assemble_stream(flags, vals)
            return states, counts, stream_

        def other_section():  # the other tree's own section form, same C interface
            n, c = data.numel(), -(-data.numel() // rans.CHUNK_BYTES)
            states = torch.empty((c, rans.N_LANES), dtype=torch.int32, device=dev)
            counts = torch.empty_like(states)
            counts64 = torch.empty((c * rans.N_LANES,), dtype=torch.int64, device=dev)
            scratch = torch.empty((c * rans.N_LANES, rans.ROWS), dtype=torch.int16, device=dev)
            words_ = torch.empty((rans.section_words(n),), dtype=torch.int32, device=dev)
            other.check(lib.repro_rans_section_walk(data.data_ptr(), n, freqs.data_ptr(),
                                                    states.data_ptr(), counts.data_ptr(),
                                                    counts64.data_ptr(), scratch.data_ptr(), stream),
                        "rans_section_walk")
            ends = torch.cumsum(counts64, 0)
            other.check(lib.repro_rans_section_copy(scratch.data_ptr(), counts.data_ptr(), ends.data_ptr(),
                                                    c * rans.N_LANES, words_.data_ptr(), stream),
                        "rans_section_copy")
            return states, counts, words_, ends[-1]

        # a tree without the section form (the parent) runs the route it replaced
        has_section = hasattr(lib, "repro_rans_section_walk")
        fns["rans_section_encode"] = (lambda: ops.rans_section_encode(data, freqs),
                                      other_section if has_section else other_route)
    for kernel in kernels:
        a, b = fns[kernel][0](), fns[kernel][1]()
        if kernel == "rans_section_encode":
            a = chip_smoke.section_result(a)[:3]
            b = chip_smoke.section_result(b)[:3] if has_section else (b[0], b[1], rans.packed_words(b[2]))
        a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{kernel}: the two trees' outputs differ")
    cycles = chip_smoke.sleep_cycles_per_ms()
    times = {}
    lines = []
    for r in range(args.rounds):
        for kernel in kernels:
            for tree in ("this", "other", "other", "this"):
                fn = fns[kernel][0 if tree == "this" else 1]
                queued = not (kernel == "rans_section_encode" and tree == "other" and not has_section)
                ms, host_ms = chip_smoke.time_ms(fn, args.iters, cycles, queued=queued)
                line = {"round": r, "kernel": kernel, "tree": tree, "ms": ms, "host_ms": host_ms,
                        "queued": queued}
                times.setdefault((kernel, tree, "ms"), []).append(ms)
                if kernel == "rans_section_encode":
                    busy, top, _ = chip_smoke.device_busy_ms(fn, top=8)
                    line["busy_ms"], line["busy_top"] = busy, top
                    times.setdefault((kernel, tree, "busy_ms"), []).append(busy)
                lines.append(line)
                print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    summary = {"card": smi.splitlines()[0], "other": str(args.other), "iters": args.iters,
               "median_ms": {f"{k}/{t}/{m}": statistics.median(v) for (k, t, m), v in times.items()}}
    print(json.dumps(summary), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines + [summary]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
