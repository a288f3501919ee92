"""Multi-pod dry run: one device's program of every (arch x shape x mesh)
cell (port of `repro/launch/dryrun.py`).

For each cell this:
  1. builds the production mesh (`launch/mesh.py`, 16x16 or 2x16x16 slots
     on the `meta` device) and the arch's sharding policy,
  2. runs the real train, prefill or serve step of the port on `meta`
     stand-ins of the cell's feeds (`configs.input_specs`) and of its
     parameters, optimizer state and cache held as `Sharded` by their
     specs: shapes only, nothing allocated or computed. Tensor parallelism
     runs one program per data shard over its model group
     (`partition.Group`); every group does the same work on its shard, so
     the first alone runs (`partition.only_lead_group`),
  3. counts the first slot's ops (`launch/hlo_analysis.py:
     analyze_program`): the per-device flops, HBM bytes, transcendentals
     and collectives, and the three roofline terms against `H100_SXM`
     (data-sheet peaks), into experiments/dryrun/<cell>.json.

`memory.argument_size_in_bytes` and `output_size_in_bytes` are exact, from
the placements of the step's arguments and results on one device;
`temp_size_in_bytes` is the peak of the live tensors the slot's ops create
and `peak_memory_in_bytes` adds the arguments: the eager program's, not a
compiler's. Every family's model axis is split (tensor parallelism); the
SSD chunk loop of a prefill runs one chunk on `meta`, counted once per
chunk (`models/ssd.py`).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape decode_32k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch import compat
from repro_torch.configs import arch_ids, get_arch, input_specs
from repro_torch.launch.hlo_analysis import ProgramCounter, CollectiveStats, roofline
from repro_torch.launch.mesh import logical_mapping, make_production_mesh
from repro_torch.launch.steps import (TrainStepConfig, make_prefill_step, make_serve_step, make_train_step,
                                      pick_microbatches)
from repro_torch.models import partition
from repro_torch.models.transformer import Transformer, init_decode_cache
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime.sharding import Placement, Sharded, batch_specs, param_specs, physical_specs

META = torch.device("meta")


@dataclasses.dataclass
class CellResult:
    record: dict


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _shard_bytes(mesh, spec, shape, dtype: torch.dtype) -> int:
    """Bytes of one slot's shard of a tensor of `shape` placed by `spec`."""
    local = Placement(mesh, tuple(spec)).shard_shape(shape)
    return math.prod(local) * torch.empty((), dtype=dtype).element_size()


def _meta_sharded(mesh, spec, shape, dtype: torch.dtype) -> Sharded:
    """A `Sharded` on `meta` whose slots share one stand-in shard."""
    pl = Placement(mesh, tuple(spec))
    t = torch.empty(pl.shard_shape(shape), dtype=dtype, device=META)
    return Sharded([t] * mesh.size, pl, tuple(shape))


def _batch_bytes(mesh, cfg, kind: str, feeds: dict, data_ok: bool, mb: int = 1) -> int:
    specs = physical_specs(batch_specs(cfg, kind, data_ok))
    total = 0
    for k, t in feeds.items():
        spec = specs[k] if mb == 1 else (None,) + tuple(specs[k])
        total += _shard_bytes(mesh, spec, t.shape, t.dtype)
    return total


def _cache_bytes(cache: dict) -> int:
    """One slot's bytes of a decode cache: the first shard of each leaf,
    rings and recurrent states (every slot's is alike), and `pos` as the
    reference's int32."""
    def leaves(node: dict) -> int:
        total = 0
        for k, v in node.items():
            if isinstance(v, dict):
                total += leaves(v)
            elif k != "pos":
                t = v.shards[0] if isinstance(v, Sharded) else v
                total += t.numel() * t.element_size()
        return total

    return 4 + leaves(cache)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, kv_quant: Optional[bool] = None,
             serve_params: str = "serve", microbatches: Optional[int] = None,
             attention: str = "pairs") -> CellResult:
    """One cell's record (see the module's docstring); `attention` is the
    counter's rule for B10's flops (`hlo_analysis.ProgramCounter`)."""
    spec = get_arch(arch_id)
    shape = next(s for s in spec.shapes if s.name == shape_name)
    base = {"arch": arch_id, "shape": shape_name, "mesh": _mesh_name(multi_pod)}
    if spec.skips and shape_name in spec.skips:
        return CellResult({**base, "status": "skipped", "reason": spec.skips[shape_name]})
    cfg = spec.model
    if kv_quant is not None:
        cfg = dataclasses.replace(cfg, kv_quant=kv_quant)

    mesh = make_production_mesh(multi_pod=multi_pod)
    mapping = logical_mapping(multi_pod)
    chips = mesh.size
    names = mesh.axis_names
    data_total = mesh.shape[names.index("data")] * (mesh.shape[names.index("pod")] if "pod" in names else 1)
    b, s = shape.global_batch, shape.seq_len
    data_ok = b % data_total == 0
    rec = {**base, "kind": shape.kind, "chips": chips, "global_batch": b, "seq_len": s,
           "kv_quant": cfg.kv_quant, "status": "ok"}
    feeds = input_specs(dataclasses.replace(spec, model=cfg), shape)

    with partition.logical_axes(mapping), partition.set_mesh(mesh), partition.only_lead_group(), \
            torch.no_grad() if shape.kind != "train" else torch.enable_grad():
        t0 = time.perf_counter()
        if shape.kind == "train":
            mb = microbatches or pick_microbatches(cfg, b, s, data_total)
            rec["microbatches"] = mb
            pspecs = physical_specs(param_specs(cfg, "train"))
            shapes = {k: tuple(p.shape) for k, p in Transformer(cfg, META, cfg.param_dtype).named_parameters()}
            params = {k: _meta_sharded(mesh, pspecs[k], shapes[k], torch.float32) for k in shapes}
            opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                             m={k: _meta_sharded(mesh, pspecs[k], shapes[k], torch.float32) for k in shapes},
                             v={k: _meta_sharded(mesh, pspecs[k], shapes[k], torch.float32) for k in shapes})
            batch = feeds if mb == 1 else {k: t.reshape((mb, t.shape[0] // mb) + tuple(t.shape[1:]))
                                           for k, t in feeds.items()}
            _, train_step = make_train_step(cfg, AdamWConfig(), TrainStepConfig(microbatches=mb), mesh=mesh,
                                            param_pspecs=pspecs, device=META)
            state = sum(_shard_bytes(mesh, pspecs[k], shapes[k], torch.float32) for k in shapes)
            rec["memory"] = {"argument_size_in_bytes": 3 * state + 4 + _batch_bytes(mesh, cfg, "train", batch,
                                                                                     data_ok, mb),
                             "output_size_in_bytes": 3 * state + 4 + 4 * 4}
            run = lambda: train_step(params, opt, batch)  # noqa: E731
        else:
            pspecs = physical_specs(param_specs(cfg, serve_params))
            model = Transformer(cfg, META)
            dt = model._store.compute
            weights = sum(_shard_bytes(mesh, pspecs[k], p.shape, dt) for k, p in model.named_parameters())
            rows = b // data_total if data_ok else b
            if shape.kind == "prefill":
                prefill_step = make_prefill_step(cfg, cache_seq_len=s)
                cache = init_decode_cache(cfg, b, s, device=META)
                logits = rows * (cfg.padded_vocab // partition.model_width(mesh)) * dt.itemsize
                rec["memory"] = {"argument_size_in_bytes": weights + _batch_bytes(mesh, cfg, "prefill", feeds,
                                                                                   data_ok),
                                 "output_size_in_bytes": _cache_bytes(cache) + logits}
                del cache
                run = lambda: prefill_step(model, feeds["inputs"])  # noqa: E731
            else:
                serve_step = make_serve_step(cfg)
                cache = init_decode_cache(cfg, b, s, device=META)
                cb = _cache_bytes(cache)
                rec["memory"] = {"argument_size_in_bytes": weights + cb + _batch_bytes(mesh, cfg, "decode", feeds,
                                                                                        data_ok),
                                 "output_size_in_bytes": cb + rows * 4}
                run = lambda: serve_step(model, cache, feeds["inputs_t"])  # noqa: E731
        with ProgramCounter(slot=0, attention=attention) as pc:
            run()
        rec["run_s"] = round(time.perf_counter() - t0, 2)
    rec["memory"]["temp_size_in_bytes"] = int(pc.peak)
    rec["memory"]["peak_memory_in_bytes"] = int(pc.peak) + rec["memory"]["argument_size_in_bytes"]
    rec["memory"]["note"] = "arguments and outputs from the placements; temp: the eager program's live peak"
    cost, coll = pc.cost, CollectiveStats(pc.cost.collectives)
    rec["cost"] = {"flops_per_device": cost.flops, "hbm_bytes_per_device": cost.bytes,
                   "transcendentals_per_device": cost.transcendentals}
    rec["collectives"] = coll.to_json()
    terms = roofline(cost, coll, chips)
    rec["roofline"] = terms.to_json()
    rec["roofline"]["chip"] = "H100_SXM (data-sheet peaks)"
    rec["attention_rule"] = attention
    # model flops (6ND train / 2ND per generated token)
    n_params = cfg.param_count(active_only=True)
    tokens = b * (s if shape.kind in ("train", "prefill") else 1)
    mf = (6 if shape.kind == "train" else 2) * n_params * tokens
    rec["model_flops"] = float(mf)
    rec["useful_flops_frac"] = mf / terms.flops_global if terms.flops_global else None
    return CellResult(rec)


def summary(out_dir: str) -> str:
    """A markdown table of the records under `out_dir`: one row per (arch,
    mesh), one cell per shape: flops, HBM bytes and collective operand
    bytes per device; the compute, memory and collective terms (s); the
    dominant term."""
    recs, shapes = {}, []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                r = json.load(f)
            if r["status"] == "ok":
                recs.setdefault((r["arch"], r["mesh"]), {})[r["shape"]] = r
                if r["shape"] not in shapes:
                    shapes.append(r["shape"])
    order = [s for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k") if s in shapes]

    def cell(r) -> str:
        if r is None:
            return "-"
        t = r["roofline"]
        return (f"{r['cost']['flops_per_device']:.3g} F, {r['cost']['hbm_bytes_per_device']:.3g} B, "
                f"{r['collectives']['operand_bytes']:.3g} C; {t['compute_s']:.3g} / {t['memory_s']:.3g} / "
                f"{t['collective_s']:.3g} s, {t['dominant']}")

    rows = ["| arch | mesh | " + " | ".join(order) + " |", "|---|---|" + "---|" * len(order)]
    for (arch, mesh), by_shape in sorted(recs.items()):
        rows.append(f"| {arch} | {mesh} | " + " | ".join(cell(by_shape.get(s)) for s in order) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--kv-quant", default=None, choices=[None, "on", "off"])
    ap.add_argument("--serve-params", default="serve", choices=["serve", "train"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--summary", action="store_true",
                    help="print a markdown table of the records under --out and exit")
    args = ap.parse_args(argv)

    if args.summary:
        print(summary(args.out))
        return

    if args.list:
        for aid in arch_ids():
            spec = get_arch(aid)
            print(aid, [s.name for s in spec.shapes], "skips:", spec.skips or {})
        return

    cells = []
    archs = arch_ids() if (args.all or not args.arch) else [args.arch]
    for aid in archs:
        spec = get_arch(aid)
        shapes = [s.name for s in spec.shapes] if (args.all or not args.shape) else [args.shape]
        for sn in shapes:
            for mp in {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]:
                cells.append((aid, sn, mp))

    os.makedirs(args.out, exist_ok=True)
    kvq = None if args.kv_quant is None else (args.kv_quant == "on")
    for aid, sn, mp in cells:
        name = f"{aid}__{sn}__{'multipod' if mp else 'pod'}{args.tag}"
        print(f"=== {name}", flush=True)
        compat.reset_wire()
        try:
            res = run_cell(aid, sn, mp, kv_quant=kvq, serve_params=args.serve_params,
                           microbatches=args.microbatches)
        except Exception:
            res = CellResult({"arch": aid, "shape": sn, "mesh": _mesh_name(mp), "status": "error",
                              "traceback": traceback.format_exc()})
        with open(os.path.join(args.out, name + ".json"), "w") as f:
            json.dump(res.record, f, indent=1)
        status = res.record["status"]
        if status == "ok":
            r = res.record["roofline"]
            print(f"    ok run={res.record['run_s']}s dominant={r['dominant']} compute={r['compute_s']:.2e}s "
                  f"memory={r['memory_s']:.2e}s coll={r['collective_s']:.2e}s", flush=True)
        else:
            print(f"    {status}: {res.record.get('reason', '')[:120]}"
                  f"{res.record.get('traceback', '')[-400:]}", flush=True)


if __name__ == "__main__":
    main()
