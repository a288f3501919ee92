"""The port's dry run (`launch/dryrun.py`).

1. Against the reference's `run_cell` on a (data 2, model 4) mesh and
   qwen3-1.7b's reduced config at three reduced shapes (train 4 x 64,
   prefill and decode 4 x 512). The reference runs in a subprocess with 8
   forced host devices, its mesh built with Auto axes (jax 0.9.0's default
   Explicit axes make its `partition.hint` assert); the port's on 8 `meta`
   slots. `argument_size_in_bytes` is equal. Flops per device are within
   10 %, B10 counted by the "blocks" rule (every (query, key) pair, as the
   reference's HLO counts the dots of its blocked scan; measured: train
   +2.7 %, prefill equal, decode -9.4 %: the reference's partitioner
   computes every kv head's K/V on every device, the port only the heads
   a slot contributes).
2. The same for the ssm and hybrid families: mamba2-1.3b's reduced config
   and recurrentgemma-9b's with its window widened to 512 (the ring's
   four 128-slot scale groups split over the 4 model slots; the reduced
   64-slot window's one group cannot, in the reference as in the port), at
   the same shapes. `argument_size_in_bytes` is equal; flops per device
   within 10 % (measured: mamba2 train -3.2 %, prefill +1.2 %, decode
   equal; recurrentgemma train +1.1 %, prefill and decode equal. The
   mamba2 gaps: the port forms the SSD's four-operand contractions as
   pairwise products, the reference as one einsum that XLA orders its
   own way).
3. Production cells on `meta` end "ok": qwen3-1.7b decode_32k on 16x16,
   deepseek-coder-33b train_4k on 2x16x16 (56 heads: they straddle the 16
   model slots), qwen3-moe-30b-a3b prefill_32k on 16x16 (8 experts a
   slot), mamba2-1.3b prefill_32k on 16x16 (4 SSD heads and 272 conv
   channels a slot; the chunk loop counted from one chunk) and
   recurrentgemma-9b train_4k on 2x16x16 (one query head and 256 RG-LRU
   channels a slot); about 6, 36, 4, 5 and 16 s here.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.runtime.elastic import make_mesh

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

SHAPES = (ShapeSpec("train_4k", "train", 64, 4), ShapeSpec("prefill_32k", "prefill", 512, 4),
          ShapeSpec("decode_32k", "decode", 512, 4))
#: each arch's reduced config: (arch, overrides of `reduced()`)
REDUCED = {"qwen3-1.7b": {}, "mamba2-1.3b": {}, "recurrentgemma-9b": {"local_window": 512}}

_REF = r'''
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
assert len(jax.devices()) == 8
from jax.sharding import AxisType
from repro.configs import get_arch
from repro.configs.base import ShapeSpec
from repro.launch import dryrun
shapes = tuple(ShapeSpec(*s) for s in json.loads(sys.argv[1]))
reduced = json.loads(sys.argv[2])
dryrun.get_arch = lambda a: dataclasses.replace(get_arch(a), model=get_arch(a).model.reduced(**reduced[a]),
                                                shapes=shapes, skips=None)
dryrun.make_production_mesh = lambda multi_pod=False: jax.make_mesh((2, 4), ("data", "model"),
                                                                    axis_types=(AxisType.Auto,) * 2)
out = {}
for arch in reduced:
    for s in shapes:
        r = dryrun.run_cell(arch, s.name, False).record
        out[arch + "/" + s.name] = {"argument_size_in_bytes": r["memory"]["argument_size_in_bytes"],
                                    "flops": r["cost"]["flops_per_device"], "status": r["status"]}
print("REF-DRYRUN " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [os.path.join(os.path.dirname(__file__), "..", "src"), env.get("PYTHONPATH", "")] if p)
    arg = json.dumps([dataclasses.astuple(s) for s in SHAPES])
    proc = subprocess.run([sys.executable, "-c", _REF, arg, json.dumps(REDUCED)], env=env, capture_output=True,
                          text=True, timeout=600)
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REF-DRYRUN ")]
    assert proc.returncode == 0 and line, proc.stdout + proc.stderr
    return json.loads(line[0][len("REF-DRYRUN "):])


def _reduced_cell(arch, shape, monkeypatch):
    spec = get_arch(arch)
    monkeypatch.setattr(dryrun, "get_arch", lambda a: dataclasses.replace(
        spec, model=spec.model.reduced(**REDUCED[arch]), shapes=SHAPES, skips=None))
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: make_mesh((2, 4), ("data", "model"), devices=["meta"] * 8))
    return dryrun.run_cell(arch, shape, False, attention="blocks").record


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
def test_reduced_cells_match_the_reference(ref, shape, monkeypatch):
    rec = _reduced_cell("qwen3-1.7b", shape, monkeypatch)
    want = ref["qwen3-1.7b/" + shape]
    assert rec["status"] == want["status"] == "ok"
    assert rec["memory"]["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    assert abs(rec["cost"]["flops_per_device"] / want["flops"] - 1.0) <= 0.10
    assert rec["collectives"]["operand_bytes"] > 0 and rec["roofline"]["dominant"] in ("compute", "memory",
                                                                                        "collective")


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b"])
def test_reduced_recurrent_cells_match_the_reference(ref, arch, shape, monkeypatch):
    rec = _reduced_cell(arch, shape, monkeypatch)
    want = ref[arch + "/" + shape]
    assert rec["status"] == want["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    gap = rec["cost"]["flops_per_device"] / want["flops"] - 1.0
    assert abs(gap) <= 0.10, gap
    assert rec["collectives"]["per_op"]["all-reduce"]["count"] > 0


@pytest.mark.parametrize("arch,shape,multi_pod", [("qwen3-1.7b", "decode_32k", False),
                                                   ("deepseek-coder-33b", "train_4k", True),
                                                   ("qwen3-moe-30b-a3b", "prefill_32k", False),
                                                   ("mamba2-1.3b", "prefill_32k", False),
                                                   ("recurrentgemma-9b", "train_4k", True)])
def test_production_cells_end_ok(arch, shape, multi_pod):
    rec = dryrun.run_cell(arch, shape, multi_pod).record
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == (512 if multi_pod else 256)
    cost = rec["cost"]
    assert cost["flops_per_device"] > 0 and cost["hbm_bytes_per_device"] > 0
    assert rec["collectives"]["per_op"]["all-reduce"]["count"] > 0
    assert 0 < rec["useful_flops_frac"] <= 1.5
    assert rec["memory"]["argument_size_in_bytes"] > 0
    if shape == "train_4k":  # FSDP gathers over the data axes, and the heads re-cut around attention
        assert rec["collectives"]["per_op"]["all-gather"]["count"] > 0


def test_skips_stay_skips():
    rec = dryrun.run_cell("qwen3-1.7b", "long_500k", False).record
    assert rec["status"] == "skipped"


def test_cli_writes_a_record(tmp_path):
    dryrun.main(["--arch", "qwen3-1.7b", "--shape", "long_500k", "--mesh", "pod", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen3-1.7b__long_500k__pod.json").read_text())
    assert rec["status"] == "skipped"


def test_summary_tabulates_the_records(tmp_path):
    """`--summary`: one row per (arch, mesh), one cell per shape."""
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", False).record
    (tmp_path / "a.json").write_text(json.dumps(rec))
    (tmp_path / "b.json").write_text(json.dumps(dryrun.run_cell("qwen3-1.7b", "long_500k", False).record))
    rows = dryrun.summary(str(tmp_path)).splitlines()
    assert rows[0] == "| arch | mesh | decode_32k |" and len(rows) == 3
    assert rows[2].startswith("| qwen3-1.7b | 16x16 | ") and rows[2].endswith(f"{rec['roofline']['dominant']} |")
