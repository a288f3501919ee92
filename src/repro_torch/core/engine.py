"""CStreamEngine — deprecated shim over the job API (port of
`repro/core/engine.py`; DESIGN.md §12).

The engine converts its `EngineConfig` (+ optional calibration sample) into
a resolved `JobSpec` via `JobSpec.from_engine_config`, negotiates the same
`Plan` the job API would, and delegates every run to the same
`run_compress` / `run_gang_compress` / `run_roundtrip` that `StreamHandle`
and `gang_compress` use, so the shim is bit-identical to the new surface by
construction.

Migration (see DESIGN.md §12 for the full table):

    CStreamEngine(cfg, sample).compress(v)   -> cstream.open(spec).push(v).flush()
    CStreamEngine(cfg, sample).roundtrip(v)  -> cstream.open(spec.replace(egress=True)) ...
    CStreamEngine(cfg).gang_compress(vs)     -> cstream.gang_compress(spec, vs)

The engine runs on `device` (CUDA when None, or raise). `sharded_compress_fn`
is the scale-out step over a device mesh (`runtime/elastic.py`): each mesh
slot encodes and packs its own lane group on its own device.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.api import (  # noqa: F401  (canonical homes are repro_torch.api / cstream)
    CompressResult,
    GangCompressResult,
    RoundtripResult,
    queueing_delay_s,
)
from repro_torch.core import bits
from repro_torch.core.algorithms import make_codec
from repro_torch.core.device import DeviceLike, on_device
from repro_torch.core.pipeline import (
    CompressionPipeline,
    DecompressionPipeline,
    lww_select,
    merge_shared_dictionary,
)
from repro_torch.core.strategies import (  # noqa: F401  (re-exported for callers)
    EngineConfig,
    ExecutionStrategy,
    SchedulingStrategy,
    StateStrategy,
    block_costs,
    schedule_blocks,
)
from repro_torch.kernels import ops

# the merge's older private name, kept for callers of the reference's alias
_merge_shared_dictionary = merge_shared_dictionary


class CStreamEngine:
    """Deprecated: declare a `repro_torch.cstream.JobSpec` and
    `cstream.open` it. Construction negotiates the equivalent JobSpec/Plan,
    and every method body is the shared api-layer runner."""

    def __init__(
        self,
        config: EngineConfig,
        sample: Optional[np.ndarray] = None,
        device: DeviceLike = None,
    ):
        api.warn_deprecated_shim("CStreamEngine", "cstream.open(JobSpec(...))")
        self.config = config
        self.spec = api.JobSpec.from_engine_config(config, sample=sample)
        self.plan = api.negotiate(self.spec, device=device)
        self.device = self.plan.device
        self.pipeline = CompressionPipeline(
            config, codec=self.plan.codec, plan=self.plan.execution, device=self.device
        )
        self.codec = self.pipeline.codec
        self._step = self.pipeline.step
        self._decompressor: Optional[DecompressionPipeline] = None

    @property
    def decompressor(self) -> DecompressionPipeline:
        """Lazily built egress executor sharing this engine's codec."""
        if self._decompressor is None:
            self._decompressor = DecompressionPipeline(
                self.config, codec=self.codec, plan=self.plan.execution, device=self.device
            )
        return self._decompressor

    # ------------------------------------------------------------- shaping
    def _block_tuples(self) -> int:
        return self.pipeline.block_tuples

    def _blocks(self, values: np.ndarray) -> np.ndarray:
        """Full blocks of the stream (legacy view; tail handling lives in
        `pipeline.shape_blocks`)."""
        return self.pipeline.shape_blocks(values).blocks

    # ------------------------------------------------------------- compress
    def compress(
        self,
        values: np.ndarray,
        arrival_rate_tps: Optional[float] = None,
        max_blocks: Optional[int] = None,
        breakdown: bool = False,
        emit_frame: bool = False,
    ) -> CompressResult:
        """Compress a stream; with `emit_frame=True` the result additionally
        carries the self-describing wire-format `bits.Frame`."""
        return api.run_compress(
            self.pipeline,
            self.spec,
            values,
            arrival_rate_tps=arrival_rate_tps,
            max_blocks=max_blocks,
            breakdown=breakdown,
            emit_frame=emit_frame,
        )

    # ----------------------------------------------------------------- gang
    def gang_compress(
        self,
        streams: List[np.ndarray],
        emit_frames: bool = False,
    ) -> GangCompressResult:
        """Compress S independent streams through gang-batched launches
        (`api.run_gang_compress`, DESIGN.md §11)."""
        if not streams:
            raise ValueError("gang_compress needs at least one stream")
        return api.run_gang_compress(
            self.pipeline, self.spec, streams, emit_frames=emit_frames
        )

    # --------------------------------------------------------------- egress
    def decompress(self, frame: bits.Frame) -> np.ndarray:
        """Reconstruct a framed bitstream."""
        return self.decompressor.decompress(frame).values

    def roundtrip(
        self,
        values: np.ndarray,
        arrival_rate_tps: Optional[float] = None,
        max_blocks: Optional[int] = None,
    ) -> RoundtripResult:
        """Compress to the wire frame, decode it back, check fidelity."""
        return api.run_roundtrip(
            self.pipeline,
            self.decompressor,
            self.spec,
            values,
            arrival_rate_tps=arrival_rate_tps,
            max_blocks=max_blocks,
        )

    # -------------------------------------------------- lossy fidelity check
    def roundtrip_nrmse(self, values: np.ndarray) -> float:
        """NRMSE through the framed wire roundtrip (0.0 when bit-exact)."""
        return self.roundtrip(values).fidelity.nrmse


def sharded_compress_fn(
    codec_name: str,
    mesh: Any,
    axis: str = "data",
    shared_state: bool = False,
    **codec_kwargs: Any,
) -> Callable[[Any, torch.Tensor], tuple]:
    """A compression step distributed over a device mesh (a
    `runtime/elastic.py` `DeviceMesh` whose only axis wider than one is
    `axis`).

    The returned callable takes `(state, block)`: the per-lane state of all
    L lanes (None for a stateless codec) and a block int32[L, B]. The lanes
    split into `mesh.size` contiguous groups, group k on `mesh.devices[k]`,
    where it is encoded and packed (one B1 launch per slot, a block of
    L/size * B symbols). Private mode (default): each slot owns its lanes'
    codec state, and the only cross-slot step is the bit-count sum. Shared
    mode (dictionary codecs): each slot merges its lanes' tables, then the
    slots' merged rows meet in one `lww_select` (ties to the lowest slot),
    the result and the slots' newest clock go back to every lane of every
    slot. Returns (state, words int32[size * OW], total_bits), in the
    reference's layout: state and words are the slots' rows concatenated in
    slot order, on the block's device, and total_bits is the sum."""
    names = tuple(mesh.axis_names)
    if axis not in names or mesh.size != mesh.shape[names.index(axis)]:
        raise ValueError(
            f"sharded_compress_fn splits lanes over mesh axis {axis!r}; the "
            f"mesh {dict(zip(names, mesh.shape))} must have no other axis "
            "wider than one"
        )
    codec = make_codec(codec_name, **codec_kwargs)
    slots = tuple(mesh.devices)
    merge = shared_state and codec.meta.state_kind == "dictionary"

    def step(state: Any, block: torch.Tensor):
        lanes, b = block.shape
        if lanes % len(slots):
            raise ValueError(f"{lanes} lanes do not split over the {len(slots)}-device mesh")
        local = lanes // len(slots)
        states, words, nbits = [], [], []
        for k, dev in enumerate(slots):
            rows = slice(k * local, (k + 1) * local)
            st = None if state is None else {key: v[rows].to(dev) for key, v in state.items()}
            with on_device(dev):
                st, enc = codec.encode(st, block[rows].to(dev))
                if merge:
                    st = merge_shared_dictionary(st)  # lanes within the slot
                w, nb = ops.pack_blocks(
                    enc.codes.reshape(local * b, 2).to(torch.int32).contiguous(),
                    enc.bitlen.reshape(local * b).to(torch.int32).contiguous(),
                    block=local * b, out_words=local * b * 2 + 2,
                )
            states.append(st)
            words.append(w[0])
            nbits.append(nb)
        out = block.device
        if merge:
            # cross-slot last-writer-wins over the slots' merged rows: the
            # reference's all-gather, lww_select and pmax
            table, valid, ts = lww_select(*(
                torch.stack([st[key][0].to(out) for st in states]) for key in ("table", "valid", "ts")
            ))
            clock = torch.stack([st["clock"][0].to(out) for st in states]).amax()
            ts_size = table.shape[-1]
            state = {
                "table": table.expand(lanes, ts_size).contiguous(),
                "valid": valid.expand(lanes, ts_size).contiguous(),
                "ts": ts.expand(lanes, ts_size).contiguous(),
                "clock": clock.expand(lanes).contiguous(),
            }
        elif states[0] is not None:
            state = {key: torch.cat([st[key].to(out) for st in states]) for key in states[0]}
        else:
            state = None
        total_bits = torch.cat([n.to(out) for n in nbits]).sum().to(torch.int32)
        return state, torch.cat([w.to(out) for w in words]), total_bits

    return step
