"""Host->device compressed token feed (port of `repro/data/pipeline.py`;
DESIGN.md §3).

LM token batches as a CStream input stream: the host packs each batch
with a lossless codec (Delta-LEB128 by default) into a dense bitstream and
ships the packed words, the per-symbol bit lengths (uint8) and the
unpacked tail to the trainer's device, which decodes them: kernel B2
(`ops.unpack_blocks`) reads the codes out of the words, then the codec's
`decode` runs there. So the host-to-device copy carries compressed bytes. A
background thread packs `prefetch` batches ahead, so that packing overlaps
the train step.

Packing stays on the host, as the reference's docstring intends: codec
`encode` and `bits.pack_bits` on CPU tensors. The device decode unpacks the
whole contiguous stream as one block of `lanes * per_lane` symbols, the
stream `bits.unpack_symbols` reads: B2 stages a block's live words in
dynamic shared memory (`csrc/bitunpack.cu`), (words + 6) / 4 * 16 bytes
beside ~8.3 KB of its own, within the H100's 227 KB a block, so a batch
may pack into at most ~56,000 words; a larger one is refused at launch
(at batch 4 x seq 1,025, Delta-LEB128 packs ~1,550 words of Zipf tokens
over qwen3's vocabulary). On the CPU, B2's plain version runs.

The token source is a Zipf LM stream (`zipf_token_stream`, numpy, the
reference's generator).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core import bits
from repro_torch.core.algorithms import make_codec
from repro_torch.core.algorithms.base import Encoded
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels import ops


def zipf_token_stream(vocab_size: int, batch: int, seq: int, seed: int = 0,
                      a: float = 1.3) -> Iterator[np.ndarray]:
    """Endless (batch, seq+1) int32 token blocks with a Zipf unigram dist."""
    rng = np.random.default_rng(seed)
    while True:
        x = rng.zipf(a, size=(batch, seq + 1)).astype(np.int64)
        yield (x % vocab_size).astype(np.int32)


@dataclasses.dataclass
class FeedStats:
    raw_bytes: int = 0
    wire_bytes: int = 0
    batches: int = 0

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(self.wire_bytes, 1)


class CompressedFeed:
    """Wraps a host token iterator with codec-packed transfer + prefetch;
    batches land on `device` (CUDA when None)."""

    def __init__(self, source: Iterator[np.ndarray], codec: str = "delta_leb128", lanes: int = 8,
                 prefetch: int = 2, device: DeviceLike = None):
        self.source = source
        self.codec = make_codec(codec)
        self.lanes = lanes
        self.stats = FeedStats()
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)

    # ---------------------------------------------------------------- host --
    def _pack(self, tokens: np.ndarray):
        flat = tokens.reshape(-1).astype(np.uint32)
        per_lane = flat.size // self.lanes
        x = torch.from_numpy(flat[: per_lane * self.lanes].view(np.int32).reshape(self.lanes, per_lane))
        cpu = torch.device("cpu")
        _, enc = self.codec.encode(self.codec.init_state(self.lanes, cpu), x)
        words, total_bits, _ = bits.pack_bits(enc.codes.reshape(-1, 2), enc.bitlen.reshape(-1),
                                              int(flat.size * 2 + 2))
        used = (int(total_bits) + 31) // 32
        # host->device payload: packed words + per-symbol bit lengths (counted
        # raw, as the reference counts them) + the tail that fills no lane
        payload = {
            "words": words[:used].numpy().copy(),
            "bitlen": enc.bitlen.to(torch.uint8).numpy(),
            "tail": flat[per_lane * self.lanes:],
        }
        self.stats.raw_bytes += flat.nbytes
        self.stats.wire_bytes += sum(payload[k].nbytes for k in ("words", "bitlen", "tail"))
        self.stats.batches += 1
        return payload, tokens.shape

    def _work(self) -> None:
        for tokens in self.source:
            if self._stop.is_set():
                return
            item = self._pack(tokens)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.05)
                    break
                except queue.Full:
                    continue

    # -------------------------------------------------------------- device --
    def _decode(self, words: torch.Tensor, bitlen: torch.Tensor, tail: torch.Tensor,
                per_lane: int) -> torch.Tensor:
        """The stream's tokens, uint32 words as int32, on the device: B2
        over the whole stream as one block, then the codec's decode."""
        n = self.lanes * per_lane
        bl = bitlen.reshape(-1).to(torch.int32)
        if n and words.numel():
            codes = ops.unpack_blocks(words[None], bl, block=n)
        else:
            codes = torch.zeros((n, 2), dtype=torch.int32, device=words.device)
        enc = Encoded(codes=codes.reshape(self.lanes, per_lane, 2), bitlen=bl.reshape(self.lanes, per_lane))
        _, vals = self.codec.decode(self.codec.init_state(self.lanes, words.device), enc)
        return torch.cat([vals.reshape(-1), tail])

    def start(self) -> "CompressedFeed":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the packing thread and wait for it (a thread left running
        torch ops at interpreter exit aborts the process)."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()
        while not self._q.empty():
            self._q.get_nowait()

    def next_batch(self) -> Dict[str, torch.Tensor]:
        """{"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}, int32 on the
        device."""
        payload, shape = self._q.get()
        dev = self.device
        words = torch.from_numpy(payload["words"]).to(dev)
        bitlen = torch.from_numpy(payload["bitlen"]).to(dev)
        tail = torch.from_numpy(payload["tail"].view(np.int32)).to(dev)
        n = int(np.prod(shape))
        per_lane = (n - tail.numel()) // self.lanes
        toks = self._decode(words, bitlen, tail, per_lane)[:n].reshape(shape)
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
