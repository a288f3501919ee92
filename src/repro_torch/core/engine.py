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
(the reference's scale-out step over a device mesh) waits for ROADMAP A9.
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from repro_torch import api
from repro_torch.api import (  # noqa: F401  (canonical homes are repro_torch.api / cstream)
    CompressResult,
    GangCompressResult,
    RoundtripResult,
    queueing_delay_s,
)
from repro_torch.core import bits
from repro_torch.core.device import DeviceLike
from repro_torch.core.pipeline import (
    CompressionPipeline,
    DecompressionPipeline,
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
):
    """The reference's compression step distributed over a device mesh
    axis (private lanes per device, or shared tables merged across devices
    every block). Not here yet: it needs the sharded fleet of ROADMAP A9."""
    raise NotImplementedError(
        "sharded_compress_fn distributes compression over a device mesh, "
        "which repro_torch does not have yet (ROADMAP A9); run it on repro"
    )
