"""`examples/torch_train_lm.py --small --steps 8 --fail-at 4` on the CPU
against `examples/train_lm.py` with the same arguments: the header (model,
parameter count, steps, batch), one restart from the injected fault, the
run's last step, the loss falling, and the feed's compression (the same
Zipf tokens through the same delta_leb128 codec), as both print them. Not
compared: the losses themselves (the twin's initial weights come from a
`torch.Generator`, the reference's from `jax.random`) and tok/s."""
import pytest
import torch

from torch_example_runs import run_pair

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

ARGS = ("--small", "--steps", "8", "--fail-at", "4")
HEADER = r"^training (\S+): ([\d.]+)M params, (\d+) steps @ batch (\d+) x seq (\d+)$"
LOSS = r"^loss ([\d.]+) -> ([\d.]+) over (\d+) steps$"
TAIL = r"^throughput \d+ tok/s; feed compression ([\d.]+)x; restarts (\d+) \(injected\), stragglers flagged (\d+)$"


@pytest.fixture(scope="module")
def printed():
    ref, twin = run_pair("train_lm", ARGS)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert twin.returncode == 0, twin.stderr[-2000:]
    return ref, twin


def test_header_equals_the_reference(printed):
    ref, twin = printed
    assert twin.line(HEADER).groups() == ref.line(HEADER).groups()
    assert twin.line(HEADER).group(1) == "qwen3-10m"


def test_one_restart_and_the_feed_ratio_equal_the_reference(printed):
    ref, twin = printed
    assert twin.line(TAIL).groups()[:2] == ref.line(TAIL).groups()[:2]
    assert twin.line(TAIL).group(2) == "1"


def test_loss_fell_over_the_same_steps(printed):
    ref, twin = printed
    first, last, steps = twin.line(LOSS).groups()
    assert float(last) < float(first)
    assert steps == ref.line(LOSS).group(3) == "8"
