#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line:
  1. build   — compile the CUDA kernels of src/repro_torch/csrc with nvcc;
  2. kernels — hold each kernel bit-exact against its plain PyTorch version
               on the card, at the main path's shapes (128 blocks x 2048
               symbols, OW 4098, bitlens including 0 and 64), on a ragged
               tail block and on the kernel contract pack_blocks(block=256);
               time kernel and plain version with CUDA events;
  3. path    — for raw32, tcomp32, leb128 and delta_leb128, compress the
               paper's evaluation volume (932,800 bytes of Rovio, seed 7) on
               the card: the frame bytes must equal the CPU path's, `ingest`
               on the card must return the input exactly, one codec runs with
               integrity="crc32c", and every kernel's launch count must rise;
  4. full    — the main path at full size: JobSpec() (tcomp32, 4 lanes, 8 KiB
               micro-batches, 128-block chunks) on a 64 MiB Rovio stream,
               compressed and decoded on the card; the roundtrip must be exact.
               The kernel launch counts are set to 0 just before this phase
               and read just after it.
Then one JSON line of per-kernel numbers, the card's name and power limit as
nvidia-smi reports them, and a last JSON line with the device.

Any failure is an uncaught exception and a non-zero exit. Without a CUDA
device the script exits non-zero before printing any result. It imports
nothing of jax or of the reference package `repro`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.api import JobSpec  # noqa: E402
from repro_torch.core import bits  # noqa: E402
from repro_torch.core.pipeline import CompressionPipeline, DecompressionPipeline  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402

#: H100 SXM device-memory rate (NVIDIA data sheet), for the byte bound
HBM_BYTES_PER_S = 3.35e12
#: the paper's evaluation volume (repro data/datasets.py PAPER_EVAL_BYTES)
EVAL_BYTES = 932800
FULL_BYTES = 64 << 20
SLICE_CODECS = ("raw32", "tcomp32", "leb128", "delta_leb128")
#: kernel -> (CUDA source, the Pallas kernel it replaces)
KERNELS = {
    "pack_blocks": ("src/repro_torch/csrc/bitpack.cu", "src/repro/kernels/bitpack.py:55"),
    "unpack_blocks": ("src/repro_torch/csrc/bitunpack.cu", "src/repro/kernels/bitunpack.py:61"),
    "compact_blocks": ("src/repro_torch/csrc/frame_compact.cu", "src/repro/kernels/frame_compact.py:54"),
    "pack_meta7_blocks": ("src/repro_torch/csrc/frame_compact.cu", "src/repro/kernels/frame_compact.py:100"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sleep_cycles_per_ms() -> float:
    """Device clock cycles per millisecond, for `torch.cuda._sleep`."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    return 1e7 / start.elapsed_time(end)


def time_ms(fn, iters: int, cycles_per_ms: float):
    """(device ms, host ms) per call of `fn`, warm.

    Device time: CUDA events around `iters` calls that queue back to back
    behind a device sleep long enough to cover their enqueue, so the host's
    launch cost (argument checks, allocation, ctypes) is not counted. Host
    time: one call's wall clock up to a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    sleep_ms = 2.0 * iters * host_ms + 5.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if enqueue_ms >= sleep_ms:
        raise AssertionError(f"enqueue took {enqueue_ms:.3f} ms, past the {sleep_ms:.3f} ms sleep")
    return start.elapsed_time(end) / iters, host_ms


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over uint32 words held as int32 bit patterns."""
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((bits._u(a) - bits._u(b)).abs().max().item())


def random_symbols(gen: torch.Generator, n_blocks: int, symbols: int, dev):
    """Codes masked to their bit lengths, bitlens 0..64 with 0 and 64 present
    and two all-zero blocks (zero-width blocks must stay transparent)."""
    codes = torch.randint(-2**31, 2**31, (n_blocks * symbols, 2), generator=gen, dtype=torch.int64)
    blen = torch.randint(0, 65, (n_blocks * symbols,), generator=gen, dtype=torch.int64)
    blen[0], blen[1] = 0, 64
    if n_blocks > 7:
        blen.view(n_blocks, symbols)[3] = 0
        blen.view(n_blocks, symbols)[7] = 0
    c = codes & bits.M32
    c0 = c[:, 0] & bits.mask_bits(blen.clamp(max=32))
    c1 = c[:, 1] & bits.mask_bits((blen - 32).clamp(min=0))
    masked = bits._i32(torch.stack([c0, c1], dim=1))
    return masked.to(dev), blen.to(torch.int32).to(dev)


def check_kernels(dev) -> dict:
    """Bit-exact kernel-vs-plain checks; returns the max error per kernel."""
    gen = torch.Generator().manual_seed(11)
    err = {k: 0 for k in KERNELS}
    cases = [
        ("slice", 128, 2048, 2 * 2048 + 2),  # 128 blocks x 2048 symbols, OW 4098
        ("ragged_tail", 1, 4 * 444, 2 * 4 * 444 + 2),  # the eval volume's tail
        ("contract", 16, 256, None),  # the Pallas kernel's pack_blocks(block=256)
    ]
    for name, nb, s, ow in cases:
        codes, blen = random_symbols(gen, nb, s, dev)
        words, nbits = ops.pack_blocks(codes, blen, block=s, out_words=ow)
        w_ref, n_ref = ref.pack_blocks_ref(codes, blen, s, ow)
        err["pack_blocks"] = max(err["pack_blocks"], max_abs_err(words, w_ref), max_abs_err(nbits, n_ref))
        back = ops.unpack_blocks(words, blen)
        e = max(max_abs_err(back, ref.unpack_blocks_ref(words, blen)), max_abs_err(back, codes))
        err["unpack_blocks"] = max(err["unpack_blocks"], e)
        pay, tot = ops.compact_blocks(words, nbits)
        p_ref, t_ref = ref.compact_blocks_ref(words, nbits)
        err["compact_blocks"] = max(err["compact_blocks"], max_abs_err(pay, p_ref), abs(int(tot) - int(t_ref)))
        m = ops.pack_meta7_blocks(blen.view(nb, s))
        err["pack_meta7_blocks"] = max(err["pack_meta7_blocks"], max_abs_err(m, ref.pack_meta7_ref(blen.view(nb, s))))
        torch.cuda.synchronize()
    return err


def time_kernels(dev, values: np.ndarray) -> dict:
    """Kernel and plain-version times at the main path's shapes, on the main
    path's own data: the first fused chunk (128 blocks) of the tcomp32
    Rovio stream. Returns per kernel (ms, plain_ms, bound_ms, host_ms,
    plain_host_ms)."""
    pipe = CompressionPipeline(JobSpec(), device=dev)
    chunk = pipe.plan.scan_chunk
    shaped = pipe.shape_blocks(values[: chunk * pipe.block_tuples])
    blocks = bits.u32_tensor(shaped.blocks, dev)
    _, enc = pipe.codec.encode_blocks(pipe.init_state(), blocks)
    c, s = blocks.shape[0], pipe.block_tuples
    ow = 2 * s + 2
    blen = enc.bitlen.reshape(c * s).contiguous()
    codes = enc.codes.reshape(c * s, 2).contiguous()
    words, nbits = ops.pack_blocks(codes, blen, block=s, out_words=ow)
    live = int(((nbits.to(torch.int64) + 31) // 32).sum())
    mw = (7 * s + 31) // 32
    blen2 = blen.view(c, s)
    plan = {
        "pack_blocks": (
            lambda: ops.pack_blocks(codes, blen, block=s, out_words=ow),
            lambda: ref.pack_blocks_ref(codes, blen, s, ow),
            c * s * 12 + c * ow * 4 + c * 4,
        ),
        "unpack_blocks": (
            lambda: ops.unpack_blocks(words, blen),
            lambda: ref.unpack_blocks_ref(words, blen),
            live * 4 + c * s * 4 + c * s * 8,
        ),
        "compact_blocks": (
            lambda: ops.compact_blocks(words, nbits),
            lambda: ref.compact_blocks_ref(words, nbits),
            live * 4 + c * 4 + c * ow * 4 + 4,
        ),
        "pack_meta7_blocks": (
            lambda: ops.pack_meta7_blocks(blen2),
            lambda: ref.pack_meta7_ref(blen2),
            c * s * 4 + c * mw * 4,
        ),
    }
    cpm = sleep_cycles_per_ms()
    out = {}
    for name, (kern, plain, nbytes) in plan.items():
        ms, host_ms = time_ms(kern, 100, cpm)
        plain_ms, plain_host_ms = time_ms(plain, 10, cpm)
        out[name] = (ms, plain_ms, nbytes / HBM_BYTES_PER_S * 1e3, host_ms, plain_host_ms)
    return out


def run_path(dev) -> None:
    """Phase 3: the eval volume through every slice codec, card vs CPU."""
    values = make_dataset("rovio", n_tuples=EVAL_BYTES // 16, seed=7).stream()
    assert values.size == EVAL_BYTES // 4
    before = ops.launch_counts()
    for codec in SLICE_CODECS:
        spec = JobSpec(codec=codec, integrity="crc32c" if codec == "delta_leb128" else None)
        gpu = CompressionPipeline(spec, device=dev).compress_to_frame(values).to_bytes()
        cpu = CompressionPipeline(spec, device="cpu").compress_to_frame(values).to_bytes()
        if gpu != cpu:
            raise AssertionError(f"{codec}: card frame differs from the CPU path's frame")
        back = DecompressionPipeline(spec, device=dev).ingest(gpu)
        if not np.array_equal(back.values, values):
            raise AssertionError(f"{codec}: ingest on the card did not return the input")
        emit({"phase": "path", "codec": codec, "integrity": spec.integrity,
              "tuples": int(values.size), "wire_bytes": len(gpu),
              "ratio": values.nbytes / len(gpu), "frame_equals_cpu": True, "exact": True})
    after = ops.launch_counts()
    stale = [k for k in after if after[k] <= before[k]]
    if stale:
        raise AssertionError(f"the path did not launch: {stale}")


def device_busy_ms(fn) -> float:
    """Device time of every kernel `fn` runs, summed from a profiler trace
    (None if the trace holds no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / 1e3 if total_us > 0 else None


def run_full(dev) -> dict:
    """Phase 4: JobSpec() tcomp32 on 64 MiB of Rovio, compress + decode,
    timed step by step on the host clock; then one profiled pass of each
    direction for the device's busy time."""
    values = make_dataset("rovio", n_tuples=FULL_BYTES // 16, seed=7).stream()
    spec = JobSpec()
    pipe = CompressionPipeline(spec, device=dev)
    decomp = DecompressionPipeline(spec, device=dev)
    pipe.compress_to_frame(values[: 8 * pipe.block_tuples])  # warm the allocator
    torch.cuda.synchronize()
    ops.reset_launches()
    t = {}
    t0 = time.perf_counter()
    shaped = pipe.shape_blocks(values)
    t["shape_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = pipe.execute(shaped, collect_payload=True)
    t["execute_s"] = time.perf_counter() - t0
    t["execute_loop_s"] = res.wall_s  # chunk loop + egress fetches + metadata splice
    t0 = time.perf_counter()
    frame = pipe.frame_from(shaped, res)
    t["frame_from_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wire = frame.to_bytes()
    t["to_bytes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = bits.parse_frame(wire)
    t["parse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = decomp.decompress(parsed)
    t["decompress_s"] = time.perf_counter() - t0
    t["decompress_device_loop_s"] = dec.wall_s  # unpack + decode chunks, synced
    launches = ops.launch_counts()
    if not np.array_equal(dec.values, values):
        raise AssertionError("64 MiB tcomp32 roundtrip is not exact")
    comp_s = t["shape_s"] + t["execute_s"] + t["frame_from_s"] + t["to_bytes_s"]
    dec_s = t["parse_s"] + t["decompress_s"]
    busy_c = device_busy_ms(lambda: pipe.execute(shaped, collect_payload=True))
    busy_d = device_busy_ms(lambda: decomp.decompress(parsed))
    emit({
        "phase": "full", "codec": spec.codec, "input_bytes": int(values.nbytes),
        "blocks": int(len(shaped.blocks)), "chunks": len(pipe._chunks(len(shaped.blocks))),
        "wire_bytes": len(wire), "ratio": values.nbytes / len(wire),
        "compress_s": comp_s, "compress_MBps": values.nbytes / 1e6 / comp_s,
        "decompress_s": dec_s, "decompress_MBps": values.nbytes / 1e6 / dec_s,
        "d2h_bytes": res.compacted.d2h_bytes,
        "steps": t, "device_busy_ms": {"execute": busy_c, "decompress": busy_d},
        "exact": True, "launches": launches,
    })
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.library()
    regs = [ln.strip() for ln in build.build_log().splitlines() if "registers" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": regs,
          "torch": torch.__version__, "cuda": torch.version.cuda, "numpy": np.__version__})

    err = check_kernels(dev)
    bad = {k: v for k, v in err.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    full_values = make_dataset("rovio", n_tuples=FULL_BYTES // 16, seed=7).stream()
    times = time_kernels(dev, full_values)
    emit({"phase": "kernels", "bit_exact": True, "kernels": {
        k: {"kernel_ms": t[0], "plain_ms": t[1], "bound_ms": t[2], "host_ms": t[3],
            "plain_host_ms": t[4]}
        for k, t in times.items()
    }})

    run_path(dev)
    launches = run_full(dev)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"the main path did not launch: {missing}")

    emit({"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err[name],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": times[name][2], "bound_by": "bytes", "library_ms": None,
            "host_ms": times[name][3],
        }
        for name, (src, replaces) in KERNELS.items()
    ]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
