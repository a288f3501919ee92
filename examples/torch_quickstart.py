"""Quickstart on the PyTorch port: CStream in five minutes — through the
unified job API (`repro_torch.cstream`), on a CUDA card unless told
otherwise. The twin of `examples/quickstart.py`: the same steps and the
same printed lines.

1. Declare a JobSpec, negotiate it, and drive a stream through the ONE
   handle surface (pick any of the ten codecs, any parallelization
   strategy; `repro_torch.cstream` is the stable entry point).
2. Let the planner navigate the Fig-4 solution space for you.
3. Use the same codecs on an LM serving path (quantized KV cache).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch import cstream
from repro_torch.core import kvcache
from repro_torch.core.planner import Constraints, choose, enumerate_solutions
from repro_torch.data.datasets import make_dataset
from repro_torch.data.stream import rate_for_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="where the pipelines and kernels run")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    # --- 1. compress a stream -------------------------------------------
    ecg = make_dataset("ecg", n_tuples=1 << 16)
    stream = ecg.stream()

    spec = cstream.JobSpec(
        codec="adpcm", lanes=4, egress=True, arrival_rate_tps=rate_for_dataset(1)
    )
    plan = cstream.negotiate(spec.calibrated(stream[:4096]), device=dev)
    print(f"[0] negotiated: {plan.cap.name} (Table 1 {plan.cap.paper_name}, "
          f"wire id {plan.cap.wire_id}), block {plan.block_tuples} tuples, "
          f"scan chunk {plan.execution.scan_chunk}")

    with cstream.open(spec, sample=stream[:4096], device=dev) as handle:
        handle.push(stream)
        handle.flush()
        report = handle.report()
    fid = report.fidelity
    print(f"[1] ADPCM on ECG: ratio {report.ratio:.2f}x, "
          f"{report.n_tuples * 4 / 1e6 / report.wall_s:.1f} MB/s, "
          f"NRMSE {100 * fid.nrmse:.2f}% (frame: {report.wire_bytes} wire bytes)")

    # --- 2. plan like Fig 4 ----------------------------------------------
    cons = Constraints(min_ratio=6.0, max_nrmse=0.05, max_energy_j_per_mb=1.5)
    points = enumerate_solutions(stream, rate_for_dataset(1), cons, device=dev)
    best = choose(points, cons)
    if best is not None:
        print(f"[2] planner picked {best.config.codec} "
              f"(ratio {best.ratio:.2f}, nrmse {100*best.nrmse:.1f}%, "
              f"{best.energy_j_per_mb:.2f} J/MB) — the paper's point A is PLA")

    # --- 3. the same codec family on an LM KV cache ----------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    k = torch.randn((1, 256, 4, 64), generator=gen, device=dev)
    codes, scales = kvcache.quantize_block(k)
    khat = kvcache.dequantize_block(codes, scales, dtype=torch.float32)
    rel = float(torch.linalg.norm(khat - k) / torch.linalg.norm(k))
    print(f"[3] NUQ KV cache: {k.numel()*2/(codes.numel() + scales.numel()*4):.2f}x vs bf16, "
          f"value error {100*rel:.1f}%")


if __name__ == "__main__":
    main()
