"""chip_smoke's `helpers` phase on the card: `Codec.roundtrip` of raw32 and
every codec of Table 1 on a slice of the eval volume against the CPU path,
`Encoded.total_bits`, a card compress's `block_payloads()` against the CPU
path's, `init_cache` on the card with its `cache_bytes`, and one B1+B4
launch timed by `metrics.timed`. Marked `cuda`; it skips without a GPU and
imports neither jax nor the reference (the CPU parity with the reference is
tests/test_torch_helpers.py's)."""
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.cuda
def test_helpers_phase_on_the_card():
    """The card, or skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    chip_smoke.build.library()
    counts = chip_smoke.run_helpers(torch.device("cuda"))
    assert counts["pack_blocks_meta7"] > 0 and counts["adpcm_lane_encode"] > 0 and counts["dict_probe"] > 0
