"""`examples/torch_edge_planner.py` on the CPU against
`examples/edge_planner.py` at their defaults (ECG, 65,536 tuples): the
count of candidates, each candidate's codec, ratio and NRMSE in the
frontier's order, and the paper's points A and B's ratios, as both print
them. Not compared: throughput, energy and latency, which the planner
takes from host walls, nor so the planner's pick, whose energy budget
reads them (on the CPU the twin's first candidate pays the process's
one-time set-up inside its wall)."""
import pytest
import torch

from torch_example_runs import run_pair

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

HEADER = r"^solution space on '(\w+)' \((\d+) candidates\):$"
ROW = r"^  [* ] (\S+) +ratio= *([\d.]+) nrmse= *([\d.]+)% "
POINT = r"^paper point {tag} \(.+\): +ratio=([\d.]+) "


@pytest.fixture(scope="module")
def printed():
    ref, twin = run_pair("edge_planner")
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert twin.returncode == 0, twin.stderr[-2000:]
    return ref, twin


def rows(p) -> list:
    import re

    return [re.search(ROW, ln).groups() for ln in p.stdout.splitlines() if re.search(ROW, ln)]


def test_candidate_count_equals_the_reference(printed):
    ref, twin = printed
    assert twin.line(HEADER).groups() == ref.line(HEADER).groups()


def test_each_candidate_ratio_and_nrmse_equal_the_reference(printed):
    ref, twin = printed
    assert rows(twin) == rows(ref)
    assert len(rows(twin)) == int(twin.line(HEADER).group(2))


@pytest.mark.parametrize("tag", ["A", "B"])
def test_paper_points_ratio_equals_the_reference(printed, tag):
    ref, twin = printed
    pat = POINT.format(tag=tag)
    assert twin.line(pat).group(1) == ref.line(pat).group(1)


def test_a_against_b_ratio_equals_the_reference(printed):
    ref, twin = printed
    pat = r"^A vs B: ([\d.]+)x ratio, "
    assert twin.line(pat).group(1) == ref.line(pat).group(1)
