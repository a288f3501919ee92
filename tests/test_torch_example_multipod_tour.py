"""`examples/torch_multipod_tour.py` on the CPU (8 mesh slots on the CPU)
against `examples/multipod_tour.py` (8 forced host devices).

Steps [1] and [2] are held to what the reference prints: the sharded
tdic32's warmed-up ratios (1.72 private, 1.73 shared) and the compressed
pod sync's max error (3.33e-04). Step [3] is held to what the reference
means: an 8-slot mesh re-meshed onto 4 (`plan_mesh`'s lm profile:
{'data': 1, 'model': 4}) with the data intact. The reference does not
reach it under jax 0.9.0: `ElasticSession.resize(4)` calls
`make_mesh_for` (`src/repro/runtime/elastic.py:113`), whose
`compat.make_mesh` (`src/repro/compat.py:61-66`) reshapes the device list
to (1, 4) before `jax.make_mesh`, and dies with "ValueError: Number of
devices 1 must be >= the product of mesh_shape (1, 4)". The same root as
the reference's red fleet drill (ROADMAP); the reference stays unedited,
so its lines [1] and [2] are read whatever its exit code."""
import pytest
import torch

from torch_example_runs import run_pair, run_twin

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

SHARDED = r"^\[1\] sharded tdic32 \({state} state\): warmed-up ratio ([\d.]+) across (\d+) devices$"
SYNC = r"^\[2\] compressed pod gradient sync: max err (\S+) "
REMESH = "[3] elastic remesh 8->4 devices: mesh {'data': 1, 'model': 4}, data intact: True"


@pytest.fixture(scope="module")
def printed():
    ref, twin = run_pair("multipod_tour", xla_flags="--xla_force_host_platform_device_count=8")
    assert twin.returncode == 0, twin.stderr[-2000:]
    return ref, twin


@pytest.mark.parametrize("state,want", [("private", "1.72"), ("shared", "1.73")])
def test_sharded_ratio_equals_the_reference(printed, state, want):
    ref, twin = printed
    pat = SHARDED.format(state=state)
    assert twin.line(pat).groups() == ref.line(pat).groups() == (want, "8")


def test_pod_sync_error_equals_the_reference(printed):
    ref, twin = printed
    assert twin.line(SYNC).group(1) == ref.line(SYNC).group(1) == "3.33e-04"


def test_remesh_keeps_the_data(printed):
    _, twin = printed
    assert REMESH in twin.stdout.splitlines()
    assert twin.stdout.splitlines()[0] == "devices: 8"


def test_the_twin_defaults_to_the_card():
    """Without --device the slots name the card: on a host without one the
    tour stops before its first step."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default runs there")
    got = run_twin("multipod_tour")
    assert got.returncode != 0
    assert "[1]" not in got.stdout
