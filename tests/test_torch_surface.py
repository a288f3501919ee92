"""The port is whole: every public name of the reference has a counterpart.

The reference's modules are read with `ast` (nothing of jax is imported):
every public top-level function and class of each `.py` under
`src/repro/`, and each public method (properties included) of those
classes. Each must either exist under the same name in the mirrored module
of `src/repro_torch/` (imported here: the port imports no jax), or stand
in `EXCEPTIONS`, which names it and says what stands in its place:

  * `("port", "<module.py> <qualified name>")`: its counterpart in the port
    under another name or in another module, which the test imports and
    finds;
  * `("none", "<reason>")`: it has no counterpart, and why: TPU-only (a TPU
    chip model, a VMEM budget) or XLA's HLO text.

An entry is a reviewed decision, not a way round the test: every entry
must name a real public name of the reference, and a "port" entry's
target must exist.
"""
import ast
import importlib
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1] / "src"
REF = ROOT / "repro"

EXCEPTIONS = {
    # the Pallas kernels' public functions: the port's wrappers in `ops`,
    # which launch the Hopper kernel on the card and run `kernels/ref.py`'s
    # plain version on the CPU
    "kernels/bitpack.py pack_blocks": ("port", "kernels/ops.py pack_blocks"),
    "kernels/bitunpack.py unpack_blocks": ("port", "kernels/ops.py unpack_blocks"),
    "kernels/frame_compact.py compact_blocks": ("port", "kernels/ops.py compact_blocks"),
    "kernels/frame_compact.py pack_meta7_blocks": ("port", "kernels/ops.py pack_meta7_blocks"),
    "kernels/dict_hash.py probe": ("port", "kernels/ops.py dict_probe"),
    "kernels/delta_nuq.py encode": ("port", "kernels/ops.py adpcm_encode"),
    "kernels/delta_nuq.py decode": ("port", "kernels/ops.py adpcm_decode"),
    "kernels/rans.py encode_rows": ("port", "kernels/ops.py rans_encode"),
    "kernels/rans.py decode_rows": ("port", "kernels/ops.py rans_decode"),
    "kernels/flash_attn.py flash_fwd": ("port", "kernels/ops.py flash_attention_fwd"),
    "kernels/ops.py pack_meta7": ("port", "kernels/ops.py pack_meta7_blocks"),
    # the jnp forms of the rANS rows: the plain torch versions that are the
    # CPU path and the kernels' oracle
    "core/entropy.py encode_rows": ("port", "kernels/ref.py rans_encode_ref"),
    "core/entropy.py decode_rows": ("port", "kernels/ref.py rans_decode_ref"),
    # per-module parameter initializers, folded into one initializer of the
    # whole model (weights cross from the reference by `models/convert.py`)
    "models/layers.py init_dense": ("port", "models/transformer.py init_params"),
    "models/layers.py init_swiglu": ("port", "models/transformer.py init_params"),
    "models/layers.py init_attention": ("port", "models/transformer.py init_params"),
    "models/moe.py init_moe": ("port", "models/transformer.py init_params"),
    "models/rglru.py init_rglru": ("port", "models/transformer.py init_params"),
    "models/ssd.py init_mamba2": ("port", "models/transformer.py init_params"),
    # the ssm's conv tail is made with the rest of the decode cache
    "models/ssd.py init_conv_tail": ("port", "models/transformer.py init_decode_cache"),
    # the dry run's counts: a dispatch mode over the eager program in place
    # of a parse of XLA's HLO text
    "launch/hlo_analysis.py analyze_hlo": ("port", "launch/hlo_analysis.py analyze_program"),
    "launch/hlo_analysis.py Instr": ("none", "XLA's HLO text: one parsed HLO instruction"),
    "launch/hlo_analysis.py HloModuleCost": ("none", "XLA's HLO text: the cost of a parsed HLO module"),
    "launch/hlo_analysis.py HloModuleCost.comp_cost": ("none", "XLA's HLO text: one HLO computation's cost"),
    "launch/hlo_analysis.py HloModuleCost.total": ("none", "XLA's HLO text: the entry computation's cost"),
    "launch/hlo_analysis.py collective_stats": ("none", "XLA's HLO text: the collectives of an HLO module; "
                                                        "analyze_program counts the port's"),
    # TPU-only
    "core/energy.py TpuChip": ("none", "TPU-only: a TPU chip model (the port's chip model is GpuChip)"),
    "core/energy.py V5E": ("none", "TPU-only: the TPU v5e instance of TpuChip (the port's is H100_SXM)"),
    "core/energy.py tpu_energy_j": ("none", "TPU-only: energy from a TPU chip model's power"),
    "core/strategies.py vmem_aware_block_tuples": ("none", "TPU-only: a block size from a TPU's VMEM budget"),
}


def _module(rel: str) -> str:
    parts = rel[:-3].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["repro_torch"] + parts)


def _public_names():
    """{(module path, qualified name)} of the reference, and the top-level
    assignments beside them (which only an exception may name)."""
    names, assigned = [], set()
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                if node.name.startswith("_"):
                    continue
                names.append((rel, node.name))
                if isinstance(node, ast.ClassDef):
                    names.extend((rel, f"{node.name}.{m.name}") for m in node.body
                                 if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                                 and not m.name.startswith("_"))
            elif isinstance(node, ast.Assign):
                assigned.update((rel, t.id) for t in node.targets if isinstance(t, ast.Name))
    return names, assigned


NAMES, ASSIGNED = _public_names()


def _find(rel: str, qual: str):
    obj = importlib.import_module(_module(rel))
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def test_the_reference_walk_finds_its_modules():
    """The walk reads the whole reference: the codecs, the kernels, the LM
    stack and the runtime all give names."""
    modules = {rel for rel, _ in NAMES}
    assert {"core/algorithms/base.py", "core/pipeline.py", "kernels/ops.py", "models/transformer.py",
            "runtime/server.py", "api.py"} <= modules
    assert len(NAMES) > 500


def test_each_public_name_of_the_reference_has_a_counterpart():
    missing = []
    for rel, qual in NAMES:
        key = f"{rel} {qual}"
        if key in EXCEPTIONS:
            kind, what = EXCEPTIONS[key]
            if kind == "port":
                target_rel, target = what.split(" ")
                _find(target_rel, target)  # raises if the named counterpart is gone
            else:
                assert kind == "none" and what, key
            continue
        try:
            _find(rel, qual)
        except (ImportError, AttributeError):
            missing.append(f"{key} (not in {_module(rel)})")
    assert not missing, "no counterpart and no entry in EXCEPTIONS:\n" + "\n".join(missing)


def test_each_exception_names_a_public_name_of_the_reference_the_port_lacks():
    """No entry names what the reference does not have, or what the port
    already carries under the same name."""
    stale = []
    for key in EXCEPTIONS:
        rel, qual = key.split(" ")
        if (rel, qual) not in NAMES and (rel, qual) not in ASSIGNED:
            stale.append(f"{key}: not a public name of the reference")
            continue
        try:
            _find(rel, qual)
        except (ImportError, AttributeError):
            continue
        stale.append(f"{key}: in the port under its own name")
    assert not stale, "\n".join(stale)
