"""Edge deployment planner on the PyTorch port — the paper's Fig 4 case
study end to end, each candidate measured on a CUDA card unless told
otherwise. The twin of `examples/edge_planner.py`: the same arguments and
printed lines.

Given a dataset, an arrival rate, and user constraints (min compression
ratio, max NRMSE, energy budget), sweep the co-design space (codec x
execution x state x scheduling x core allocation) and print the frontier,
the chosen point A, and the careless point B for contrast.

Run:  PYTHONPATH=src python examples/torch_edge_planner.py [--dataset ecg] [--device cpu]
"""
import argparse

from repro_torch.configs.cstream_edge import SOLUTION_A, SOLUTION_B
from repro_torch.core.planner import Constraints, choose, enumerate_solutions, evaluate
from repro_torch.data.datasets import make_dataset
from repro_torch.data.stream import rate_for_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="ecg")
    ap.add_argument("--min-ratio", type=float, default=6.0)
    ap.add_argument("--max-nrmse", type=float, default=0.05)
    ap.add_argument("--energy-budget", type=float, default=1.5, help="J/MB")
    ap.add_argument("--device", default="cuda", help="where each candidate's pipelines run")
    args = ap.parse_args(argv)

    ds = make_dataset(args.dataset, n_tuples=1 << 16)
    stream = ds.stream()
    rate = rate_for_dataset(ds.words_per_tuple)

    cons = Constraints(
        min_ratio=args.min_ratio,
        max_nrmse=args.max_nrmse,
        max_energy_j_per_mb=args.energy_budget,
    )
    points = enumerate_solutions(stream, rate, cons, device=args.device)
    print(f"solution space on {args.dataset!r} ({len(points)} candidates):")
    for p in sorted(points, key=lambda p: -p.ratio):
        feas = "*" if p.feasible(cons) else " "
        print(f"  {feas} {p.config.codec:14s} ratio={p.ratio:5.2f} "
              f"nrmse={100*p.nrmse:5.2f}% thpt={p.throughput_mbps:7.1f}MB/s "
              f"E={p.energy_j_per_mb:6.2f}J/MB lat={1e3*p.latency_s:6.2f}ms")

    best = choose(points, cons)
    print(f"\nplanner's point A: {best.config.codec if best else 'infeasible'}")

    a = evaluate(SOLUTION_A, stream, rate, device=args.device)
    b = evaluate(SOLUTION_B, stream, rate, device=args.device)
    print(f"paper point A (PLA, co-designed):  ratio={a.ratio:.2f} "
          f"thpt={a.throughput_mbps:.1f} E={a.energy_j_per_mb:.2f}J/MB lat={1e3*a.latency_s:.2f}ms")
    print(f"paper point B (careless Tdic32):   ratio={b.ratio:.2f} "
          f"thpt={b.throughput_mbps:.1f} E={b.energy_j_per_mb:.2f}J/MB lat={1e3*b.latency_s:.2f}ms")
    print(f"A vs B: {a.ratio/b.ratio:.1f}x ratio, {a.throughput_mbps/b.throughput_mbps:.1f}x throughput, "
          f"{100*(1-a.latency_s/b.latency_s):.0f}% latency cut, "
          f"{100*(1-a.energy_j_per_mb/b.energy_j_per_mb):.0f}% energy cut")


if __name__ == "__main__":
    main()
