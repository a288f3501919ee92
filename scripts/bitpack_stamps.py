#!/usr/bin/env python3
"""Where B1/B2/B3's, B1-with-B4's and B8's and B9's section-form time goes
(`pack_blocks`, `unpack_blocks`, `compact_blocks`, `pack_blocks_meta7`,
`rans_section_encode`'s walk kernel and `rans_section_decode`), from stamps
in an instrumented copy of the kernels, on one GPU.

    python3 scripts/bitpack_stamps.py [--out FILE]

It copies this tree's `src/` into `build/stamps/src` (a directory
`.gitignore` lists), puts stamps into that copy of `csrc/bitpack.cu`,
`csrc/bitunpack.cu`, `csrc/frame_compact.cu` and `csrc/rans_section.cu` at
fixed lines of their code (it fails if a line is missing), builds it, and
runs each kernel once, warm, on chip_smoke.py's timing-phase inputs (B1-B4:
the tcomp32 path's first fused chunk of 64 MiB of Rovio, seed 7: 128
blocks x 2,048 symbols, OW 4,098; B8 and B9: the heavy tier's payload
section of the same stream). Thread 0 of every CTA writes `%globaltimer`
(ns) at entry and exit and `clock64()` (SM cycles) at the phase boundaries:
  B1, and B1 with B4 fused in (`csrc/rans_section_decode.cu` aside, one
      stamp array per source): entry, lengths in (the register scan; with
      B4, its metadata stores issued), block scan done, ORs done (after the
      barrier), row stores issued;
  B2: entry, lengths in, block scan done, row staged (after the barrier),
      codes stored;
  B3: entry, counts in and scanned (the warp's `all` used), live copy
      issued, zero fill issued;
  B8 walk: entry, table built, then for each quarter chunk
      (rows 384-511 first) the quarter staged and every lane's walk of the
      quarter before it done (a barrier each), every lane's last walk done
      (a barrier), thread 0's last quad, state and count stored;
  B9 section decode: entry (the first quads' copies issued), table built (a
      barrier), the first quads landed, then thread 0's warp's rows 0-127,
      128-255, 256-383 and 384-511 walked (tiles stored), the rest (a ragged
      last chunk) done. A CTA whose thread 0 walks fewer rows (the last
      chunk's) leaves stamps of an earlier launch and is left out.
A phase that ends at a barrier is the slowest thread's; one that does not
is thread 0's. Prints one JSON line per kernel: the median and max over the
CTAs of each phase's cycles, the CTAs' start spread and the span from the
first entry to the last exit (ns), and the card's name and power limit as
nvidia-smi reports them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "stamps"

STAMP_DEFS = """
#define STAMP_SLOTS 10
__device__ long long {name}[1024 * STAMP_SLOTS];
#define STAMP(i) do {{ if (threadIdx.x == 0 && blockIdx.x < 1024) {{ long long t_; \\
  if ((i) == 0 || (i) == STAMP_SLOTS - 1) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
  else t_ = clock64(); {name}[blockIdx.x * STAMP_SLOTS + (i)] = t_; }} }} while (0)
extern "C" int {name}_read(void* dst) {{
  return static_cast<int>(cudaMemcpyFromSymbol(dst, {name}, sizeof({name})));
}}
"""

#: the stamp after the register scan waits for the lengths: an instruction
#: that reads the scan's sum comes first
LENGTHS_IN = '    asm volatile("mov.b32 %0, %0;" : "+r"(sum));\n    STAMP(2);\n'

#: source -> (stamp array, [(line to find, line to put in its place)])
PATCHES = {
    "bitpack.cu": ("g_pack_stamps", [
        ("  int carry = 0;\n  for (int base = 0; base < symbols; base += kRound) {",
         "  STAMP(0); STAMP(1);\n  int carry = 0;\n  for (int base = 0; base < symbols; base += kRound) {"),
        ("    int round_total;\n    const int off = carry + repro::block_exclusive_scan",
         LENGTHS_IN + "    int round_total;\n    const int off = carry + repro::block_exclusive_scan"),
        ("    const int off = carry + repro::block_exclusive_scan<kThreads>(sum, warp_sums, &round_total);\n",
         "    const int off = carry + repro::block_exclusive_scan<kThreads>(sum, warp_sums, &round_total);\n"
         "    STAMP(3);\n"),
        ("  __syncthreads();\n\n  // quad q holds", "  __syncthreads();\n  STAMP(4);\n\n  // quad q holds"),
        ("  if (threadIdx.x == 0) nbits[blk] = carry;\n}",
         "  if (threadIdx.x == 0) nbits[blk] = carry;\n  STAMP(5); STAMP(9);\n}"),
    ]),
    "bitunpack.cu": ("g_unpack_stamps", [
        ("  const bool prefetched = threadIdx.x < nq;", "  STAMP(0); STAMP(1);\n  const bool prefetched = threadIdx.x < nq;"),
        ("    int round_total;\n    const int off = carry + repro::block_exclusive_scan",
         LENGTHS_IN + "    int round_total;\n    const int off = carry + repro::block_exclusive_scan"),
        ("    const int off = carry + repro::block_exclusive_scan<kThreads>(sum, warp_sums, &round_total);\n",
         "    const int off = carry + repro::block_exclusive_scan<kThreads>(sum, warp_sums, &round_total);\n"
         "    STAMP(3);\n"),
        ("    __syncthreads();\n\n    // pairs of symbols", "    __syncthreads();\n    STAMP(4);\n\n    // pairs of symbols"),
        ("      }\n    }\n  }\n}\n", "      }\n    }\n  }\n  STAMP(5); STAMP(9);\n}\n"),
    ]),
    "frame_compact.cu": ("g_compact_stamps", [
        ("  const int blk = blockIdx.x, t = threadIdx.x, lane = t & 31;\n",
         "  const int blk = blockIdx.x, t = threadIdx.x, lane = t & 31;\n  STAMP(0); STAMP(1);\n"),
        ("  // live words that land", '  asm volatile("mov.b64 %0, %0;" : "+l"(all));\n  STAMP(2);\n'
         "  // live words that land"),
        ("  // zeros on [all, cap)", "  STAMP(3);\n  // zeros on [all, cap)"),
        ("  if (blk == 0 && t == 0) *total_out = static_cast<int>(all);\n}",
         "  STAMP(4);\n  if (blk == 0 && t == 0) *total_out = static_cast<int>(all);\n  STAMP(9);\n}"),
    ]),
    "rans_section.cu": ("g_section_stamps", [
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n  STAMP(0); STAMP(1);\n"),
        ("  tab[tid] = make_uint4(", "  STAMP(2);\n  tab[tid] = make_uint4("),
        ("    __syncthreads();\n    const int hi = ", "    __syncthreads();\n    STAMP(6 - part);\n"
         "    const int hi = "),
        ("  if (g >= n_streams) return;\n  if (cnt & 7) {", "  STAMP(7);\n  if (g >= n_streams) return;\n"
         "  if (cnt & 7) {"),
        ("  counts64[g] = cnt;\n}", "  counts64[g] = cnt;\n  STAMP(8); STAMP(9);\n}"),
    ]),
}
PATCHES["rans_section_decode.cu"] = ("g_decode_stamps", [
    ("  const int lane = threadIdx.x & 31, j = lane & 7;\n",
     "  const int lane = threadIdx.x & 31, j = lane & 7;\n  STAMP(0); STAMP(1);\n"),
    ("  build_table(freqs, tab, fr, cu, warp_max);\n", "  build_table(freqs, tab, fr, cu, warp_max);\n  STAMP(2);\n"),
    ("  d.val = ring[d.r];\n", "  d.val = ring[d.r];\n  STAMP(3);\n"),
    ("    rows16<false>(d, t0, rows, tab, ring, s, col, piece, out, dst0, n, vec_out);\n",
     "    rows16<false>(d, t0, rows, tab, ring, s, col, piece, out, dst0, n, vec_out);\n"
     "    if (((t0 + kTileRows) & 127) == 0) STAMP(3 + ((t0 + kTileRows) >> 7));\n"),
    ("    rows16<true>(d, t0, rows, tab, ring, s, col, piece, out, dst0, n, vec_out);\n  }\n}",
     "    rows16<true>(d, t0, rows, tab, ring, s, col, piece, out, dst0, n, vec_out);\n  }\n"
     "  STAMP(8); STAMP(9);\n}"),
])
PHASES = {
    "pack_blocks": ("lengths_in", "scan", "ors_and_barrier", "row_stores"),
    "pack_blocks_meta7": ("lengths_in_and_meta", "scan", "ors_and_barrier", "row_stores"),
    "unpack_blocks": ("lengths_in", "scan", "staging_and_barrier", "extract_and_stores"),
    "compact_blocks": ("counts_and_scan", "copy_issued", "fill_issued"),
    "rans_section_encode": ("table", "quarter3_staged", "walk3_and_quarter2", "walk2_and_quarter1",
                            "walk1_and_quarter0", "walk0", "last_quad_and_state"),
    "rans_section_decode": ("table", "first_quads", "rows_0_127", "rows_128_255", "rows_256_383",
                            "rows_384_511", "ragged_rest"),
}


def instrument() -> Path:
    """The instrumented copy's `src/`; its sources differ only by the stamps."""
    src = COPY / "src"
    if src.exists():
        shutil.rmtree(src)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = src / "repro_torch" / "csrc"
    for name, (array, edits) in PATCHES.items():
        text = (csrc / name).read_text()
        anchor = '#include "common.cuh"\n'
        text = text.replace(anchor, anchor + STAMP_DEFS.format(name=array), 1)
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the line to instrument is not there once: {old!r}")
            text = text.replace(old, new)
        (csrc / name).write_text(text)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    sys.path.insert(0, str(instrument()))
    import numpy as np
    import torch

    from repro_torch.api import JobSpec
    from repro_torch.core import bits, entropy
    from repro_torch.core.pipeline import CompressionPipeline
    from repro_torch.data import make_dataset
    from repro_torch.kernels import build, ops

    if not torch.cuda.is_available():
        print("bitpack_stamps: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib = build.library()
    values = make_dataset("rovio", n_tuples=(64 << 20) // 16, seed=7).stream()
    pipe = CompressionPipeline(JobSpec(), device=dev)
    shaped = pipe.shape_blocks(values[: pipe.plan.scan_chunk * pipe.block_tuples])
    blocks = bits.u32_tensor(shaped.blocks, dev)
    _, enc = pipe.codec.encode_blocks(pipe.init_state(), blocks)
    c, s = blocks.shape[0], pipe.block_tuples
    codes, blen = enc.codes.reshape(c * s, 2).contiguous(), enc.bitlen.reshape(c * s).contiguous()
    words, nbits = ops.pack_blocks(codes, blen, block=s, out_words=2 * s + 2)
    frame = CompressionPipeline(JobSpec(codec="delta_leb128", entropy="rans", egress=True),
                                device=dev).compress_to_frame(values)
    section = torch.from_numpy(np.ascontiguousarray(frame.payload, np.uint32).view(np.uint8)).to(dev)
    freqs = entropy.quantize_freqs(torch.bincount(section, minlength=256)).to(torch.int32)
    d_states, d_counts, d_words, d_total = ops.rans_section_encode(section, freqs)
    e = int(d_total)
    dec_args = (d_words[: (e + 1) // 2], e, freqs, d_states, d_counts, section.numel())
    runs = {
        "pack_blocks": (lambda: ops.pack_blocks(codes, blen, block=s, out_words=2 * s + 2), "g_pack_stamps"),
        "unpack_blocks": (lambda: ops.unpack_blocks(words, blen), "g_unpack_stamps"),
        "compact_blocks": (lambda: ops.compact_blocks(words, nbits), "g_compact_stamps"),
        "pack_blocks_meta7": (lambda: ops.pack_blocks_meta7(codes, blen, block=s, out_words=2 * s + 2),
                              "g_pack_stamps"),
        "rans_section_encode": (lambda: ops.rans_section_encode(section, freqs), "g_section_stamps"),
        "rans_section_decode": (lambda: ops.rans_section_decode(*dec_args), "g_decode_stamps"),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    lines = []
    for kernel, (fn, array) in runs.items():
        for _ in range(3):  # warm: the last launch's stamps are read
            fn()
        torch.cuda.synchronize()
        stamps = np.zeros((1024, 10), np.int64)
        reader = getattr(lib, f"{array}_read")
        reader.argtypes = [ctypes.c_void_p]
        build.check(reader(stamps.ctypes.data), f"{array}_read")
        k = len(PHASES[kernel])
        # the CTAs of the launch (at most 1,024) whose phase stamps all come from it
        st = stamps[(stamps[:, 0] != 0) & (np.diff(stamps[:, 1:k + 2], axis=1) >= 0).all(axis=1)]
        cycles = np.diff(st[:, 1:k + 2], axis=1)
        line = {
            "kernel": kernel, "card": card, "ctas": int(st.shape[0]),
            "cycles_median": {p: float(statistics.median(cycles[:, i])) for i, p in enumerate(PHASES[kernel])},
            "cycles_max": {p: int(cycles[:, i].max()) for i, p in enumerate(PHASES[kernel])},
            "cta_cycles_median": float(statistics.median(st[:, k + 1] - st[:, 1])),
            "start_spread_ns": int(st[:, 0].max() - st[:, 0].min()),
            "span_ns": int(st[:, 9].max() - st[:, 0].min()),
            "cta_ns_median": float(statistics.median(st[:, 9] - st[:, 0])),
        }
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
