"""The port's compressed token feed (`repro_torch.data.pipeline`) against
the reference's (`repro.data.pipeline`): the same Zipf stream, the same
wire (packed words, uint8 bit lengths and tail, byte for byte), the same
`FeedStats` bytes, and batches that decode exactly (B2's plain version
and the codec's decode on the CPU); the reference's own checks
(`tests/test_pipeline.py`) mirrored."""
import numpy as np
import pytest
import torch

from repro.data import pipeline as rp
from repro_torch.data import pipeline as tp
from repro_torch.kernels import ops

torch.set_num_threads(1)  # one intra-op thread: the suite's workers share the host's cores


def test_zipf_stream_equals_reference():
    a, b = rp.zipf_token_stream(1000, 3, 17, seed=4), tp.zipf_token_stream(1000, 3, 17, seed=4)
    for _ in range(3):
        np.testing.assert_array_equal(next(a), next(b))


@pytest.mark.parametrize("codec,vocab,batch,seq,lanes", [
    ("delta_leb128", 151936, 4, 1024, 8),
    ("delta_leb128", 1000, 4, 63, 8),
    ("delta_leb128", 50000, 3, 10, 4),  # a tail that fills no lane
    ("leb128", 301, 2, 15, 8),
    ("tcomp32", 50000, 2, 40, 8),
])
def test_wire_and_stats_equal_reference(codec, vocab, batch, seq, lanes):
    """`_pack` of the same token blocks: words, bit lengths and tail byte
    for byte, and the stats' raw and wire bytes."""
    rfeed = rp.CompressedFeed(iter(()), codec=codec, lanes=lanes)
    tfeed = tp.CompressedFeed(iter(()), codec=codec, lanes=lanes, device="cpu")
    src = rp.zipf_token_stream(vocab, batch, seq, seed=9)
    for _ in range(3):
        tokens = next(src)
        (rpay, rshape), (tpay, tshape) = rfeed._pack(tokens), tfeed._pack(tokens)
        assert rshape == tshape
        for key in ("words", "bitlen", "tail"):
            r, t = np.asarray(rpay[key]), tpay[key]
            assert r.nbytes == t.nbytes and r.tobytes() == t.tobytes(), key
    assert (tfeed.stats.raw_bytes, tfeed.stats.wire_bytes, tfeed.stats.batches) == \
        (rfeed.stats.raw_bytes, rfeed.stats.wire_bytes, rfeed.stats.batches)
    assert tfeed.stats.ratio == rfeed.stats.ratio


@pytest.mark.parametrize("vocab,batch,seq", [(1000, 4, 63), (151936, 4, 1024), (50000, 3, 10)])
def test_feed_roundtrip_exact(vocab, batch, seq):
    src = tp.zipf_token_stream(vocab_size=vocab, batch=batch, seq=seq, seed=0)
    ref_src = rp.zipf_token_stream(vocab_size=vocab, batch=batch, seq=seq, seed=0)
    feed = tp.CompressedFeed(src, codec="delta_leb128", lanes=8, device="cpu").start()
    try:
        for _ in range(3):
            batch_t = feed.next_batch()
            want = next(ref_src)
            got = np.concatenate([batch_t["inputs"].numpy(), batch_t["labels"].numpy()[:, -1:]], axis=1)
            np.testing.assert_array_equal(got, want)
            assert batch_t["inputs"].dtype == torch.int32
    finally:
        feed.stop()


def test_feed_compresses_zipf_tokens():
    feed = tp.CompressedFeed(tp.zipf_token_stream(50000, 8, 127, seed=1), codec="delta_leb128",
                             device="cpu").start()
    try:
        for _ in range(3):
            feed.next_batch()
        assert feed.stats.ratio > 1.3, feed.stats
    finally:
        feed.stop()


def test_feed_labels_shifted_by_one():
    feed = tp.CompressedFeed(tp.zipf_token_stream(301, 2, 15, seed=2), device="cpu").start()
    try:
        b = feed.next_batch()
        np.testing.assert_array_equal(b["inputs"].numpy()[:, 1:], b["labels"].numpy()[:, :-1])
    finally:
        feed.stop()


def test_device_decode_reads_the_stream_through_b2(monkeypatch):
    """The decode unpacks the whole stream as one block through
    `ops.unpack_blocks` (B2; its plain version on the CPU)."""
    calls = []
    orig = ops.unpack_blocks
    monkeypatch.setattr(ops, "unpack_blocks", lambda w, b, block=None: calls.append((tuple(w.shape), block))
                        or orig(w, b, block))
    feed = tp.CompressedFeed(tp.zipf_token_stream(1000, 4, 63, seed=3), lanes=8, device="cpu").start()
    try:
        feed.next_batch()
        feed.next_batch()
    finally:
        feed.stop()
    assert len(calls) == 2 and all(shape[0] == 1 and block == 256 for shape, block in calls)


def test_feed_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.CompressedFeed(tp.zipf_token_stream(10, 1, 3))


def test_stop_joins_the_packing_thread():
    feed = tp.CompressedFeed(tp.zipf_token_stream(100, 2, 7), prefetch=1, device="cpu").start()
    feed.next_batch()
    feed.stop()
    assert not feed._thread.is_alive()
