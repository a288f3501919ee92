#!/usr/bin/env python3
"""Time B1/B2/B3 (`pack_blocks`, `unpack_blocks`, `compact_blocks`), B1 with
B4 fused in (`pack_blocks_meta7`), and B8's and B9's section forms
(`rans_section_encode`, `rans_section_decode`) of this tree against another
tree's, on the same inputs, on one GPU.

    python3 scripts/bitpack_ab.py OTHER_DIR [--iters 100] [--rounds 2]
        [--kernels pack_blocks,...,rans_section_decode_route] [--out FILE]

OTHER_DIR is the root of another checkout of this repo (the parent commit,
say, unpacked with `git archive` into a directory `.gitignore` lists). Its
`src/repro_torch/kernels/build.py`, loaded on its own, builds that tree's
library into OTHER_DIR/build/; this tree's kernels run through
`repro_torch.kernels.ops`. The inputs are chip_smoke.py's timing-phase
inputs: B1-B4 on the tcomp32 path's first fused chunk of 64 MiB of Rovio
(seed 7), 128 blocks x 2,048 symbols, OW 4,098; B8 and B9 on the heavy
tier's payload section (the 64 MiB delta_leb128 frame's raw payload, ~34.6
MB), its table built once for all. B3 is timed kernel against kernel: both
sides allocate `total` with `torch.empty` (a wrapper that zero-fills it
first adds a launch). The other tree's side of each kernel is its own form
of it where its library has one, else what the path ran before:
  * `pack_blocks_meta7`: its `repro_pack_blocks` and `repro_pack_meta7_blocks`,
    two launches;
  * `rans_section_encode`: the bytes widened into the (C, 512, 8) int32 grid
    and its mask, the contract kernel `repro_rans_encode` and
    `assemble_stream` (whose `int(...)` of the stream length synchronises);
  * `rans_section_decode`: the contract kernel `repro_rans_decode` alone, on
    the int32 stream, lane offsets and mask made beforehand (this tree's
    side includes its `torch.cumsum`);
  * `rans_section_decode_route`, the decode from host words to host bytes:
    this tree's `entropy._decode_device` (two uploads, the section form, the
    fetch of n bytes) against the route it replaced (the u16s unpacked on the
    host and uploaded one per int32, the offsets, the byte mask, the contract
    kernel's int32 grid narrowed to bytes, the fetch), or the other tree's
    section form between the same uploads and fetch.
Each round times this tree, the other, the other, this tree, each with
`chip_smoke.time_ms` (CUDA events over `--iters` calls queued behind a
device sleep; what synchronises, unqueued, so its time includes the host's
gaps) and, for B8 and B9, `chip_smoke.device_busy_ms` (profiler device time
of one call, and per kernel). The two trees' outputs must be equal bit for
bit. Prints one JSON line per timing and a last line with each median per
tree (ms), next to the card's name and power limit as nvidia-smi reports
them.
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

KERNELS = ("pack_blocks", "unpack_blocks", "compact_blocks", "pack_blocks_meta7", "rans_section_encode",
           "rans_section_decode", "rans_section_decode_route")
#: what synchronises, and so is timed unqueued: the routes through the host
UNQUEUED = ("rans_section_decode_route",)


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
    if {"pack_blocks", "unpack_blocks", "compact_blocks", "pack_blocks_meta7"} & set(kernels):
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

        def other_pack_meta7():  # its fused form, or B1 then B4
            w = torch.empty((nb, ow), dtype=torch.int32, device=dev)
            n = torch.empty((nb,), dtype=torch.int32, device=dev)
            meta = torch.empty((nb, 7 * s // 32), dtype=torch.int32, device=dev)
            if hasattr(lib, "repro_pack_blocks_meta7"):
                other.check(lib.repro_pack_blocks_meta7(codes.data_ptr(), blen.data_ptr(), nb, s, ow,
                                                        w.data_ptr(), n.data_ptr(), meta.data_ptr(), stream),
                            "pack_blocks_meta7")
            else:
                other.check(lib.repro_pack_blocks(codes.data_ptr(), blen.data_ptr(), nb, s, ow,
                                                  w.data_ptr(), n.data_ptr(), stream), "pack_blocks")
                other.check(lib.repro_pack_meta7_blocks(blen.data_ptr(), nb, s, 7 * s // 32,
                                                        meta.data_ptr(), stream), "pack_meta7_blocks")
            return w, n, meta

        fns["pack_blocks"] = (lambda: ops.pack_blocks(codes, blen, block=s, out_words=ow), other_pack)
        fns["pack_blocks_meta7"] = (lambda: ops.pack_blocks_meta7(codes, blen, block=s, out_words=ow),
                                    other_pack_meta7)
        fns["unpack_blocks"] = (lambda: ops.unpack_blocks(words, blen), other_unpack)
        fns["compact_blocks"] = (lambda: ops.compact_blocks(words, nbits), other_compact)
    if {"rans_section_encode", "rans_section_decode", "rans_section_decode_route"} & set(kernels):
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

        # B9: the section's parts as the entropy stage holds them
        d_states, d_counts, d_words, d_total = ops.rans_section_encode(data, freqs)
        e, n, c = int(d_total), data.numel(), d_states.shape[0]
        d_words = d_words[: (e + 1) // 2]
        dec_args = (d_words, e, freqs, d_states, d_counts, n)
        host = (bits.u32_numpy(d_words), e, bits.u32_numpy(freqs), bits.u32_numpy(d_states),
                bits.u32_numpy(d_counts), n)
        cap = rans.decode_cap(c)
        has_decode = hasattr(lib, "repro_rans_section_decode")

        def other_decode_kernel(words_, states_, counts_, freqs_):  # its section form, or the contract kernel
            if has_decode:
                out = torch.empty((n,), dtype=torch.uint8, device=dev)
                ends = torch.cumsum(counts_.reshape(-1), 0, dtype=torch.int32)
                other.check(lib.repro_rans_section_decode(words_.data_ptr(), e, cap, freqs_.data_ptr(),
                                                          states_.data_ptr(), counts_.data_ptr(),
                                                          ends.data_ptr(), n, out.data_ptr(), stream),
                            "rans_section_decode")
                return out
            stream16 = bits.u32_tensor(chip_smoke.contract_stream(bits.u32_numpy(words_), e), dev)
            return contract_kernel(stream16, states_, rans.lane_offsets(counts_), chip_smoke.byte_mask(c, n, dev),
                                   freqs_)

        # the contract kernel's tables, made once (the wrapper's torch ops per
        # call would overflow the launch queue behind the timing's sleep)
        cum_c, lut_c = bits._i32(rans.cum_freqs(freqs)), rans.slot_table(freqs).to(torch.int32)

        def contract_kernel(stream16, states_, off, mask, freqs_):
            syms = torch.empty(mask.shape, dtype=torch.int32, device=dev)
            other.check(lib.repro_rans_decode(stream16.data_ptr(), stream16.numel(), cap, freqs_.data_ptr(),
                                              cum_c.data_ptr(), lut_c.data_ptr(), states_.data_ptr(),
                                              off.data_ptr(), mask.view(torch.uint8).data_ptr(), c,
                                              rans.ROWS, syms.data_ptr(), stream), "rans_decode")
            return syms

        if has_decode:
            other_dec = lambda: other_decode_kernel(d_words, d_states, d_counts, freqs)  # noqa: E731
        else:  # the contract kernel alone, its int32 inputs made beforehand
            pre = (bits.u32_tensor(chip_smoke.contract_stream(host[0], e), dev), d_states,
                   rans.lane_offsets(d_counts), chip_smoke.byte_mask(c, n, dev), freqs)
            other_dec = lambda: contract_kernel(*pre)  # noqa: E731

        def other_route():  # host words to host bytes
            if not has_decode:
                return chip_smoke.contract_decode_route(*host, dev)
            small = torch.from_numpy(np.concatenate([host[2].view(np.int32), host[3].view(np.int32).reshape(-1),
                                                     host[4].view(np.int32).reshape(-1)])).to(dev)
            tab, st, cnt = small.split([256, 8 * c, 8 * c])
            out = other_decode_kernel(bits.u32_tensor(host[0], dev), st.view(c, 8), cnt.view(c, 8), tab)
            return out.cpu().numpy()

        fns["rans_section_decode"] = (lambda: ops.rans_section_decode(*dec_args), other_dec)
        fns["rans_section_decode_route"] = (lambda: entropy._decode_device(*host, dev), other_route)
    for kernel in kernels:
        a, b = fns[kernel][0](), fns[kernel][1]()
        if kernel == "rans_section_encode":
            a = chip_smoke.section_result(a)[:3]
            b = chip_smoke.section_result(b)[:3] if has_section else (b[0], b[1], rans.packed_words(b[2]))
        if kernel == "rans_section_decode" and not has_decode:  # the contract kernel's int32 grid
            b = b.reshape(-1)[: a.numel()].to(torch.uint8)
        if kernel == "rans_section_decode_route":
            a, b = torch.from_numpy(a), torch.from_numpy(b)
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
                queued = not (kernel == "rans_section_encode" and tree == "other" and not has_section
                              or kernel in UNQUEUED)
                iters = args.iters if queued else max(3, args.iters // 20)
                ms, host_ms = chip_smoke.time_ms(fn, iters, cycles, queued=queued)
                line = {"round": r, "kernel": kernel, "tree": tree, "ms": ms, "host_ms": host_ms,
                        "queued": queued}
                times.setdefault((kernel, tree, "ms"), []).append(ms)
                if kernel.startswith("rans_section"):
                    busy, top, _, _ = chip_smoke.device_busy_ms(fn, top=8)
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
