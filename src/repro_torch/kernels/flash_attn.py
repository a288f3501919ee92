"""B10: GQA flash-attention forward on the card (port of
`repro/kernels/flash_attn.py`; CUDA source `csrc/flash_attn.cu`).

`launch` runs the kernel on validated CUDA tensors; `ops.flash_attention_fwd`
is the public wrapper and `ref.flash_reference` the plain version. The
kernel keeps the TPU kernel's contract: (B, Sq, H, Dh) queries against
(B, Sk, K, Dh) keys and values, query head h paired with kv head h // (H/K),
scores, running max, sum and accumulator in float32 on inputs converted to
float32, masked scores at -1e30, the output in q's dtype. Unlike the TPU
kernel it takes any Sq and Sk (no tile divisibility): it masks the ragged
edge itself.

What bounds it, and the design, are in the note at the top of the source:
operations (~69.5 us per call at the serving path's prefill shape against
the bf16 tensor-core peak), met here on the f32 CUDA cores.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

#: the widest head the kernel's register accumulator holds
MAX_HEAD_DIM = 128


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


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
           window: Optional[int], causal: bool) -> None:
    """q (B, Sq, H, Dh), k/v (B, Sk, K, Dh), out like q: contiguous, one
    dtype (bfloat16 or float32), on one CUDA device."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    err = build.library().repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h, kv, dh,
        0 if window is None else int(window), int(bool(causal)),
        int(q.dtype == torch.bfloat16), scale(dh),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    build.check(err, "flash_attention_fwd")
