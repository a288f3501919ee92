"""`examples/torch_quickstart.py` on the CPU against `examples/quickstart.py`:
the negotiated codec, block and scan chunk, the ADPCM handle's ratio, wire
bytes and NRMSE, the planner's pick with its ratio and NRMSE, and the NUQ
cache's ratio, as both print them. Not compared: MB/s and J/MB (host
walls), and the cache's value error (step [3] draws its keys from a
`torch.Generator` in the twin, from `jax.random` in the reference).

The planner's energy per MB is the modeled power over host walls, so its
budget (1.5 J/MB) is met or not by how busy the host is: on a loaded CPU
the twin's first PLA candidate, which pays a one-time set-up inside its
wall, can miss it and the twin then prints no pick. The pick is held
through the port's own planner on the same stream with the budget lifted
(ratio and NRMSE are the host-free criteria), and the twin's printed pick
wherever it printed one."""
import pytest
import torch

from repro_torch.core.planner import Constraints, choose, enumerate_solutions
from repro_torch.data.datasets import make_dataset
from repro_torch.data.stream import rate_for_dataset

from torch_example_runs import run_pair

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

NEGOTIATED = r"^\[0\] negotiated: (\S+) \(Table 1 (.+), wire id (\d+)\), block (\d+) tuples, scan chunk (\d+)$"
HANDLE = r"^\[1\] ADPCM on ECG: ratio ([\d.]+)x, [\d.]+ MB/s, NRMSE ([\d.]+)% \(frame: (\d+) wire bytes\)$"
PLANNER = r"^\[2\] planner picked (\S+) \(ratio ([\d.]+), nrmse ([\d.]+)%, [\d.]+ J/MB\)"
CACHE = r"^\[3\] NUQ KV cache: ([\d.]+)x vs bf16, value error ([\d.]+)%$"


@pytest.fixture(scope="module")
def printed():
    ref, twin = run_pair("quickstart")
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert twin.returncode == 0, twin.stderr[-2000:]
    return ref, twin


@pytest.mark.parametrize("pattern", [NEGOTIATED, HANDLE], ids=["negotiated", "handle"])
def test_printed_values_equal_the_reference(printed, pattern):
    ref, twin = printed
    assert twin.line(pattern).groups() == ref.line(pattern).groups()


def test_planner_pick_equals_the_reference(printed):
    ref, twin = printed
    stream = make_dataset("ecg", n_tuples=1 << 16).stream()
    cons = Constraints(min_ratio=6.0, max_nrmse=0.05)
    best = choose(enumerate_solutions(stream, rate_for_dataset(1), cons, device="cpu"), cons)
    want = ref.line(PLANNER).groups()
    assert (best.config.codec, f"{best.ratio:.2f}", f"{100 * best.nrmse:.1f}") == want == ("pla", "6.30", "0.5")
    if "[2]" in twin.stdout:
        assert twin.line(PLANNER).groups() == want


def test_cache_ratio_equals_the_reference(printed):
    ref, twin = printed
    assert twin.line(CACHE).group(1) == ref.line(CACHE).group(1) == "2.00"
    assert 0 < float(twin.line(CACHE).group(2)) < 5


def test_the_twin_prints_the_reference_lines_in_order(printed):
    ref, twin = printed
    tags = [ln.split("]")[0] for ln in twin.stdout.splitlines() if ln.startswith("[")]
    assert [ln.split("]")[0] for ln in ref.stdout.splitlines() if ln.startswith("[")] == ["[0", "[1", "[2", "[3"]
    assert tags in (["[0", "[1", "[2", "[3"], ["[0", "[1", "[3"])
