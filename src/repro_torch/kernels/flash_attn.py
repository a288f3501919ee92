"""B10: GQA flash-attention forward on the card (port of
`repro/kernels/flash_attn.py`), by two CUDA kernels:

  * `csrc/flash_attn_tc.cu`, on Hopper's tensor cores (`wgmma`, TMA-fed
    K/V), for bf16 inputs inside `kernel_for`'s rule: bf16 q.k products
    (exact in float32) summed in float32, float32 running max, sum and p,
    and p@v as three bf16 products, p split as p_hi + p_mid + p_lo with each
    term the bf16 rounding of what the terms before it leave, into one
    float32 accumulator;
  * `csrc/flash_attn.cu`, on the f32 FMA units, for float32 inputs and
    shapes outside that rule: scores, running max, sum, p and p@v in
    float32 on inputs converted to float32.

Both take the reference's attention logit softcap c (`softcap`, None for
none): an unmasked key's scaled score s becomes c * tanhf(s / c) before the
softmax (the reference's `_chunk_attn_update`: scale, cap, mask); the
masked value stays -1e30. The cap never picks the kernel.

Both also write, when given a float32 (B, H, Sq) `lse`, each query row's
log-sum-exp m + log(max(l, 1e-30)), which the training backward reads
(`models/layers.py: FlashAttention`); `out` is the same with or without it.

`launch` and `launch_tc` run them on validated CUDA tensors;
`ops.flash_attention_fwd` is the public wrapper and chooses between them by
`kernel_for`, `ref.flash_reference` the plain version. Both keep the TPU
kernel's contract: (B, Sq, H, Dh) queries against (B, Sk, K, Dh) keys and
values, query head h paired with kv head h // (H/K), masked scores at
-1e30, the output in q's dtype, held to the dense float32 softmax within
one bf16 step (bf16) or 2e-4 (float32). Unlike the TPU kernel they take any
Sq and Sk (no tile divisibility): they mask the ragged edge themselves.

What bounds them, and the designs, are in the notes at the top of the
sources: operations (~69.5 us per call at the serving path's prefill shape
against the bf16 tensor-core peak).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

#: the widest head the kernels' register accumulators hold (both kernels
#: run a second instance for heads wider than 128: recurrentgemma's 256)
MAX_HEAD_DIM = 256
#: the widest GQA group (H / K) the tensor-core kernel takes
MAX_TC_GROUPS = 64
#: (position, query head) rows of one kv head, Sq * G, the tensor-core
#: kernel indexes in 32 bits
MAX_TC_ROWS = 2**31 - 1 - 128
#: the kernel names `kernel_for` returns (the `ops.WRAPPERS` entries that
#: count their launches)
FMA, TENSOR_CORE = "flash_attention_fwd", "flash_attention_fwd_tc"


def kernel_for(dtype: torch.dtype, head_dim: int, groups: int, aligned: bool = True,
               rows: int = 0) -> str:
    """Which kernel takes CUDA inputs of this dtype, head_dim and GQA group
    (H / K): the tensor-core kernel for bfloat16 with head_dim a multiple of
    16 up to 256, groups <= 64, 16-byte aligned tensors (TMA and its
    16-byte loads need them) and rows = Sq * groups <= MAX_TC_ROWS; the FMA
    kernel for everything else."""
    if (dtype == torch.bfloat16 and head_dim % 16 == 0 and 16 <= head_dim <= MAX_HEAD_DIM
            and 1 <= groups <= MAX_TC_GROUPS and aligned and rows <= MAX_TC_ROWS):
        return TENSOR_CORE
    return FMA


def scale(head_dim: int) -> float:
    """The TPU kernel's score scale, `1.0 / head_dim ** 0.5` as the float32
    its f32 product rounds it to."""
    return float(np.float32(1.0 / head_dim ** 0.5))


def flops(batch: int, seq_q: int, seq_k: int, heads: int, head_dim: int,
          window: Optional[int], causal: bool) -> int:
    """Floating-point operations of QK^T and PV over the unmasked
    (query, key) pairs of positions arange(seq_q) x arange(seq_k), two per
    multiply-add."""
    qp = np.arange(seq_q, dtype=np.int64)
    hi = np.minimum(qp, seq_k - 1) if causal else np.full(seq_q, seq_k - 1)
    lo = np.maximum(qp - window + 1, 0) if window is not None else np.zeros(seq_q, np.int64)
    pairs = int(np.clip(hi - lo + 1, 0, None).sum())
    return 4 * batch * heads * head_dim * pairs


def _lse_ptr(lse: Optional[torch.Tensor]) -> Optional[int]:
    return None if lse is None else lse.data_ptr()


def _cap(softcap: Optional[float]) -> float:
    """The entry points' softcap argument: 0.0 for none."""
    return 0.0 if softcap is None else float(softcap)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
           window: Optional[int], causal: bool, lse: Optional[torch.Tensor] = None,
           softcap: Optional[float] = None) -> None:
    """The FMA kernel. q (B, Sq, H, Dh), k/v (B, Sk, K, Dh), out like q:
    contiguous, one dtype (bfloat16 or float32), on one CUDA device; with
    `lse` (float32 (B, H, Sq)), each row's log-sum-exp too; `softcap` a
    finite cap > 0 or None."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    err = build.library().repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _lse_ptr(lse), b, sq, sk, h, kv, dh,
        0 if window is None else int(window), int(bool(causal)),
        int(q.dtype == torch.bfloat16), scale(dh), _cap(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention_fwd")


def launch_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
              window: Optional[int], causal: bool, lse: Optional[torch.Tensor] = None,
              softcap: Optional[float] = None) -> None:
    """The tensor-core kernel. As `launch`, for inputs `kernel_for` sends
    to it (bfloat16). Raises if the launch or a tensor map is refused
    (codes from 100000 up carry the tensor-map encoder's CUresult)."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    err = build.library().repro_flash_fwd_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _lse_ptr(lse), b, sq, sk, h, kv, dh,
        0 if window is None else int(window), int(bool(causal)), scale(dh), _cap(softcap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention_fwd_tc")


def tc_smem_bytes(head_dim: int) -> int:
    """Dynamic shared memory a tensor-core launch at this head_dim requests."""
    return int(build.library().repro_flash_fwd_tc_smem(head_dim))
