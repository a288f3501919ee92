"""RLE: lossless value-state run-length encoding (port of
`repro/core/algorithms/rle.py`; paper Table 1, [30]).

Each lane's state holds the value and pending count of the run still open
when the previous micro-batch ended. A run that spans blocks is emitted
once, with its full count; the trailing run of a stream is emitted by
`flush()` into the frame's flush mini-block.

Symbols are emitted at run-START slots: the slot where a new run begins
carries the (value, count) of the run that just closed, so the encoder
stays shape-stable. A block's tuples can therefore be covered by symbols of
later blocks, and RLE decodes the whole symbol stream at once
(`meta.scope == 'stream'`): one expansion by cumsum of the counts and a
batched `searchsorted`. Runs are found with `torch.cummax` over run starts.
Symbol: 32-bit value + 16-bit count (48 bits); runs longer than CAP split at
the cap, emitted where the count saturates (never a run-start slot).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.algorithms.base import Codec, CodecMeta, Encoded, register

CAP = 65535


@register("rle")
class RLE(Codec):
    meta = CodecMeta(
        "rle", lossy=False, stateful=True, state_kind="value", aligned=True,
        scope="stream", maskable=False,
    )
    state_dtypes = {"val": np.dtype(np.uint32), "cnt": np.dtype(np.int32)}

    def init_state(self, lanes: int, device: torch.device):
        # cnt == 0 <=> no open run (cnt is kept mod CAP: a run that closed
        # exactly at the cap was fully emitted and carries nothing)
        return {
            "val": torch.zeros((lanes,), dtype=torch.int32, device=device),
            "cnt": torch.zeros((lanes,), dtype=torch.int32, device=device),
        }

    def encode(self, state: Any, x: torch.Tensor) -> Tuple[Any, Encoded]:
        x = x.to(torch.int32)
        lanes, b = x.shape
        idx = torch.arange(b, device=x.device).expand(lanes, b)
        prev = torch.cat([state["val"][:, None], x[:, :-1]], dim=1)
        cnt = state["cnt"].to(torch.int64)
        cont0 = (cnt > 0) & (x[:, 0] == state["val"])  # head merges the carry
        new_run = x != prev
        new_run[:, 0] = ~cont0
        # start == -1 marks the carry-merged head run
        start = torch.cummax(torch.where(new_run, idx, -1), dim=1).values
        c_in = torch.where(cont0, cnt, 0)
        count_so_far = idx - start + torch.where(start < 0, c_in[:, None], 1)
        pend = count_so_far % CAP
        pending_before = torch.cat([cnt[:, None], pend[:, :-1]], dim=1)
        # run-start slots carry the close of the previous run (suppressed if
        # a cap split already emitted everything); cap splits emit in place
        emit_close = new_run & (pending_before > 0)
        emit_cap = pend == 0
        value = torch.where(emit_cap, x, prev)
        count = torch.where(emit_cap, CAP, pending_before).to(torch.int32)
        blen = torch.where(emit_cap | emit_close, 48, 0).to(torch.int32)
        new_state = {"val": x[:, -1], "cnt": pend[:, -1].to(torch.int32)}
        return new_state, Encoded(torch.stack([value, count], dim=-1), blen)

    def flush(self, state: Any) -> Optional[Encoded]:
        """Close the trailing open run: one (value, count) slot per lane."""
        blen = torch.where(state["cnt"] > 0, 48, 0).to(torch.int32)[:, None]
        codes = torch.stack([state["val"][:, None], state["cnt"][:, None]], dim=-1)
        return Encoded(codes, blen)

    def decode(self, state: Any, enc: Encoded) -> Tuple[Any, torch.Tensor]:
        """Expand the symbol stream; returns one value per symbol SLOT.

        The valid reconstruction is the prefix of length sum(counts) per
        lane (the caller trims); slots past the covered range repeat the
        last symbol's value. Stream scope: pass the whole stream's symbols
        (including `flush`'s) in one call."""
        lanes, s = enc.bitlen.shape
        counts = torch.where(enc.bitlen > 0, enc.codes[..., 1].to(torch.int64), 0)
        ends = torch.cumsum(counts, dim=1)
        slots = torch.arange(s, device=ends.device).expand(lanes, s).contiguous()
        j = torch.searchsorted(ends, slots, right=True).clamp(0, max(s - 1, 0))
        return state, enc.codes[..., 0].gather(1, j)
