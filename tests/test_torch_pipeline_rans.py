"""The port's executors with the rANS stage (`entropy="rans"`) against the
reference, on the CPU: `tests/test_torch_pipeline.py`'s frame, roundtrip
and egress cases for every configuration with the stage (`RANS`), in a
file of their own so that the two halves run on two workers. What each
case holds is said there."""
import pytest
import torch

from test_torch_pipeline import (CRC, LOSSLESS, MODES, RANS, SLICE3, frames_case, legacy_case,
                                 roundtrip_lossless_case, roundtrip_lossy_case)

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores


@pytest.mark.parametrize("integrity", CRC)
@pytest.mark.parametrize("length_idx", range(7))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("codec", RANS)
def test_frames_byte_identical_and_cross_decode(codec, mode, length_idx, integrity):
    frames_case(codec, mode, length_idx, integrity)


@pytest.mark.parametrize("integrity", CRC)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("codec", tuple(c for c in LOSSLESS if c in RANS))
def test_run_roundtrip_is_lossless(codec, mode, integrity):
    roundtrip_lossless_case(codec, mode, integrity)


@pytest.mark.parametrize("integrity", CRC)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("codec", tuple(c for c in SLICE3 if c in RANS))
def test_run_roundtrip_of_lossy_codecs_holds_error_bound(codec, mode, integrity):
    roundtrip_lossy_case(codec, mode, integrity)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("codec", RANS)
def test_legacy_collection_matches_compacted_egress(codec, mode):
    legacy_case(codec, mode)
