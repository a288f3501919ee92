"""`examples/torch_serve_lm.py` on the CPU against `examples/serve_lm.py` at
their smallest batch and generation (`--batch 1 --gen 10`: qwen3-1.7b's
reduced config, 1 x 128 + 10; the defaults are 4 x 128 + 48): each cache's
bytes and the NUQ cache's ratio to the raw one, as both print them. Not
compared: tok/s and prefill ms (host walls) and the sample tokens (the
twin's weights come from a `torch.Generator`, the reference's from
`jax.random`)."""
import pytest
import torch

from torch_example_runs import run_pair

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores

CACHE = r"^{kind} cache: +[\d.]+ tok/s decode, prefill +[\d.]+ ms, cache ([\d.]+) MB(.*)$"


@pytest.fixture(scope="module")
def printed():
    ref, twin = run_pair("serve_lm", ("--batch", "1", "--gen", "10"))
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert twin.returncode == 0, twin.stderr[-2000:]
    return ref, twin


@pytest.mark.parametrize("kind", ["NUQ-quantized", r"raw bf16 +"], ids=["nuq", "raw"])
def test_cache_bytes_and_ratio_equal_the_reference(printed, kind):
    ref, twin = printed
    pat = CACHE.format(kind=kind)
    assert twin.line(pat).groups() == ref.line(pat).groups()


def test_nuq_cache_is_half_the_raw_one(printed):
    _, twin = printed
    assert "(2.00x smaller than raw)" in twin.line(CACHE.format(kind="NUQ-quantized")).group(2)


def test_sample_tokens_are_printed_for_both_caches(printed):
    _, twin = printed
    lines = [ln for ln in twin.stdout.splitlines() if ln.startswith("  sample tokens: [")]
    assert len(lines) == 2 and all(len(ln.split(",")) == 10 for ln in lines)
