"""Gang execution and the serving runtime on the card: each gang chunk and
each wave is one launch of each kernel for all its members, and the gang's
frames equal the solo frames on the card and the CPU path's (the tdic32
shared-state merge stays inside each session). The tests are marked `cuda`
and skip without a GPU; they import neither jax nor the reference, so
`pytest -m cuda` runs where jax is absent (the CPU parity with the
reference is tests/test_torch_gang.py's)."""
import numpy as np
import pytest
import torch

from repro_torch import cstream
from repro_torch.core.pipeline import CompressionPipeline
from repro_torch.data.stream import rate_for_dataset, zipf_timestamps
from repro_torch.kernels import ops

GEOM = dict(lanes=4, micro_batch_bytes=1024, scan_chunk=4)
#: name -> (JobSpec fields, the codec's chunk kernel or None)
JOBS = {
    "tcomp32": (dict(codec="tcomp32"), None),
    "tdic32": (dict(codec="tdic32"), "dict_chunk_encode"),
    "tdic32-shared": (dict(codec="tdic32", state="shared"), None),
    "adpcm": (dict(codec="adpcm"), "adpcm_lane_encode"),
}


@pytest.fixture
def cuda():
    """The card, or skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _streams(n_members: int, n: int):
    rng = np.random.default_rng(5)
    walk = np.cumsum(rng.integers(-40, 41, (n_members, n)), axis=1) + 20_000
    return [np.clip(w, 0, None).astype(np.uint32) % 7919 for w in walk]


def _counts(fn):
    torch.cuda.synchronize()
    ops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return ops.launch_counts(), out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(JOBS))
def test_cuda_gang_chunk_is_one_launch_per_kernel(cuda, name):
    """Five members of 3,000 tuples (blocks of 256: two chunks of four, one of
    three, a ragged tail): each chunk launches B1+B4 and B3 once for all
    five, the codec's chunk kernel once (tdic32 shared walks its blocks on
    B5's probe, one launch per block for all members), the tail B1 once
    and its encode once (tdic32 on the probe, adpcm on B6). Frames equal
    the solo card frames and the CPU path's."""
    fields, kernel = JOBS[name]
    streams = _streams(5, 3000)
    spec = cstream.JobSpec(**fields, **GEOM)
    if fields["codec"] == "adpcm":
        spec = spec.calibrated(streams[0])
    counts, res = _counts(lambda: cstream.gang_compress(spec, streams, emit_frames=True, device=cuda))
    pipe = CompressionPipeline(spec, device="cpu")
    shaped = pipe.shape_blocks(streams[0])
    n_chunks = len(pipe._chunks(len(shaped.blocks)))
    want = {"pack_blocks_meta7": n_chunks, "compact_blocks": n_chunks, "pack_blocks": 1}
    if name == "adpcm":
        want[kernel] = n_chunks + 1
    elif name == "tdic32":
        want.update({kernel: n_chunks, "dict_probe": 1})
    elif name == "tdic32-shared":
        want["dict_probe"] = len(shaped.blocks) + 1
    assert {k: counts[k] for k in want} == want
    assert res.dispatches == n_chunks + 1
    card = [r.frame.to_bytes() for r in res.results]
    cpu = cstream.gang_compress(spec, streams, emit_frames=True, device="cpu")
    assert card == [r.frame.to_bytes() for r in cpu.results]
    solo = CompressionPipeline(spec, device=cuda)
    assert [solo.compress_to_frame(v).to_bytes() for v in streams] == card


@pytest.mark.cuda
def test_cuda_gang_step_shared_merge_stays_in_session(cuda):
    """A wave of tdic32 under the shared-state strategy on the card: each
    member's state after the wave equals its solo step's, lane for lane."""
    spec = cstream.JobSpec(codec="tdic32", state="shared", **GEOM)
    pipe = CompressionPipeline(spec, device=cuda)
    lanes, b = spec.lanes, pipe.block_tuples // spec.lanes
    vals = _streams(3, 2 * pipe.block_tuples)
    states = [pipe.init_state() for _ in vals]
    for step in range(2):
        blocks = torch.stack([
            torch.from_numpy(v[step * lanes * b: (step + 1) * lanes * b].view(np.int32).reshape(lanes, b))
            for v in vals]).to(cuda)
        masks = torch.ones(blocks.shape, dtype=torch.bool, device=cuda)
        folded, words, nbits, _, _ = pipe.gang_step(pipe.stack_states(states), blocks, masks, meta7=True)
        for i, st in enumerate(states):
            solo_state, solo_words, solo_bits, _ = pipe.masked_step_meta7(st, blocks[i], masks[i])
            got = pipe.unstack_state(folded, i)
            for key in got:
                assert torch.equal(got[key], solo_state[key]), key
            assert int(nbits[i]) == int(solo_bits)
            assert torch.equal(words[i], solo_words)
        states = [pipe.unstack_state(folded, i) for i in range(len(vals))]


@pytest.mark.cuda
def test_cuda_server_wave_is_one_launch_per_kernel(cuda):
    """Six tdic32 topics on a gang Dispatcher on the card: one B1+B4 and one
    B5 probe per wave or solo flush, records and frames equal to the solo
    server's on the card."""
    rate = rate_for_dataset(1)
    feeds = {f"t{i}": (v, zipf_timestamps(v.size, rate, zipf_factor=0.7, seed=i))
             for i, v in enumerate(_streams(6, 5000))}

    def replay(gang):
        d = cstream.Dispatcher(gang=gang, device=cuda)
        for t, (v, ts) in feeds.items():
            d.open(cstream.JobSpec(codec="tdic32", egress=True, flush_tuples=1024), topic=t).push(v, ts)
        counts, rep = _counts(d.run)
        return d, rep, counts

    g, g_rep, g_counts = replay(True)
    s, _, _ = replay(False)
    (stats,) = g_rep.dispatch_stats.values()
    assert stats.n_waves >= 1
    assert g_counts["pack_blocks_meta7"] == g_counts["dict_probe"] == stats.n_waves + stats.n_solo
    for t in feeds:
        assert [f.key() for f in g.sessions[t].flushes] == [f.key() for f in s.sessions[t].flushes]
        assert g.sessions[t].egress_frame().to_bytes() == s.sessions[t].egress_frame().to_bytes()
        assert g_rep.sessions[t].fidelity.bit_exact
