"""The port stands alone: importing every module of `repro_torch`,
`chip_smoke` and the examples' PyTorch twins (`examples/torch_*.py`;
neither run) loads neither jax nor the reference package, and an entry point given no device on a host without a GPU (the
pipelines, the LM `serve`) raises instead of falling back to the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, {src!r})
sys.path.insert(0, {root!r})
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
import chip_smoke  # noqa: F401  (imported, not run)
import importlib.util, pathlib
for path in sorted(pathlib.Path({root!r}, "examples").glob("torch_*.py")):
    spec = importlib.util.spec_from_file_location("example_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))  # main() is not called
    print("TWIN", path.name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", leaked)
print("IMPORTED", sorted(m for m in sys.modules if m.startswith("repro_torch")))
import torch
from repro_torch.api import JobSpec
from repro_torch.core.pipeline import CompressionPipeline, DecompressionPipeline
if not torch.cuda.is_available():
    for cls in (CompressionPipeline, DecompressionPipeline):
        try:
            cls(JobSpec())
        except RuntimeError as exc:
            print("RAISED", type(exc).__name__, "device='cpu'" in str(exc))
        else:
            print("NO-RAISE", cls.__name__)
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve
    try:
        serve(get_arch("qwen3-1.7b").model.reduced(), batch=1, prompt_len=4, gen=1)
    except RuntimeError as exc:
        print("SERVE-REFUSED", type(exc).__name__, "device='cpu'" in str(exc))
    else:
        print("SERVE-RAN without a device")
"""


def _run_probe():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # the probe sets its own path: src only
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.fixture(scope="module")
def probe_output():
    return _run_probe()


def test_port_and_chip_smoke_import_neither_jax_nor_repro(probe_output):
    assert "LEAKED []" in probe_output, probe_output


def test_the_mesh_modules_are_probed(probe_output):
    """The mesh machinery's modules, the port's own `compat.py` among them,
    are imported by the probe and so held to it."""
    line = next(ln for ln in probe_output.splitlines() if ln.startswith("IMPORTED"))
    for mod in ("repro_torch.compat", "repro_torch.models.partition", "repro_torch.runtime.sharding",
                "repro_torch.launch.mesh", "repro_torch.runtime.elastic"):
        assert repr(mod) in line, mod


def test_the_dry_run_modules_are_probed(probe_output):
    """The dry run, its program analysis and the H100 chip model are
    imported by the probe and so held to it."""
    line = next(ln for ln in probe_output.splitlines() if ln.startswith("IMPORTED"))
    for mod in ("repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis", "repro_torch.core.energy",
                "repro_torch.configs.base"):
        assert repr(mod) in line, mod


def test_the_example_twins_are_probed(probe_output):
    """The five twins of the reference's examples are imported by the probe
    and so held to it."""
    twins = [ln.split()[1] for ln in probe_output.splitlines() if ln.startswith("TWIN")]
    assert twins == [f"torch_{n}.py" for n in ("edge_planner", "multipod_tour", "quickstart", "serve_lm",
                                                "train_lm")]


def test_no_device_on_a_cpu_only_host_raises(probe_output):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the no-device default is CUDA here")
    assert probe_output.count("RAISED RuntimeError True") == 2, probe_output
    assert "NO-RAISE" not in probe_output


def test_serve_without_a_device_on_a_cpu_only_host_raises(probe_output):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the no-device default is CUDA here")
    assert "SERVE-REFUSED RuntimeError True" in probe_output, probe_output
    assert "SERVE-RAN" not in probe_output


def test_chip_smoke_refuses_to_run_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(ROOT),
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
