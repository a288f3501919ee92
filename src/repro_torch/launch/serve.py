"""Batched serving: prefill + greedy autoregressive decode with the
NUQ-compressed KV cache (port of `repro/launch/serve.py`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --full \
      --batch 4 --prompt-len 2048 --gen 32          # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --reduced \
      --batch 4 --prompt-len 64 --gen 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-large --full   # on the card

Weights are random, drawn from a seed (`init_params`), as in the reference.
Embedding configs (musicgen-large, pixtral-12b) take (B, S, D) prompts,
seeded bf16 normals when none are given, and feed each generated token
back as its `embed` row rounded to bfloat16, as the reference does.
On the card the prefill and decode times are taken after
`torch.cuda.synchronize()`.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import partition
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Transformer, _round_window, cache_tensors, init_params
from repro_torch.runtime.elastic import logical_mapping


@dataclasses.dataclass
class ServeRun:
    prefill_s: float
    decode_s: float
    tokens_generated: int
    decode_tok_per_s: float
    cache_bytes: int
    cache_bytes_raw_equiv: int
    tokens: np.ndarray
    #: the prefill's logits of the last prompt position (B, 1, V), and the
    #: cache after the last decode step (port-only, for parity checks)
    prefill_logits: Optional[torch.Tensor] = None
    cache: Optional[Dict[str, Any]] = None


def decode_input(model: Transformer, tok: torch.Tensor) -> torch.Tensor:
    """A decode step's input for greedy tokens (B, 1): the tokens, or for an
    embeddings model their `embed` rows (B, 1, D) rounded to bfloat16, as
    the reference's serve loop feeds them back."""
    if model.cfg.input_kind == "tokens":
        return tok
    return model.embed[tok[:, 0].long()][:, None].to(torch.bfloat16)


def serve(
    cfg: ModelConfig,
    batch: int = 4,
    prompt_len: int = 64,
    gen: int = 32,
    cache_len: Optional[int] = None,
    seed: int = 0,
    device: Union[None, str, torch.device] = None,
    params: Union[None, Transformer, Dict[str, Any]] = None,
    prompts: Union[None, np.ndarray, torch.Tensor] = None,
    mesh=None,
) -> ServeRun:
    """Prefill `batch` prompts of `prompt_len` tokens, then decode `gen`
    tokens each greedily (the first from the prefill's logits). `device`
    None means CUDA (no CPU fallback). `params`: a `Transformer` (moved to
    the device) or the reference's parameter tree as numpy leaves; None
    draws them from `seed`. `prompts` int (batch, prompt_len), or for
    `input_kind == "embeddings"` float (batch, prompt_len, d_model); None
    draws them from `seed` (bfloat16 normals for embeddings). An
    embeddings model is fed each greedy token as its `embed` row rounded to
    bfloat16 (also when the model is float32), as the reference's serve
    loop does.

    With `mesh` (a `runtime/elastic.DeviceMesh`) the prefill and decode
    run under it and the active logical mapping
    (`elastic.logical_mapping(mesh.axis_names)` outside one): the rings
    held as per-slot shards, the decode reading them through the
    distributed-LSE branch, an moe block dispatching per data shard
    (`models/transformer.py`). The weights stay whole on `device`; for the
    dense and moe families on a model axis of several slots each slot
    computes on its model shard of them (views of the whole weights, or
    copies on a slot's own device): tensor parallelism, each decode step's
    greedy token taken over the split vocab."""
    device = resolve_device(device)
    if params is None:
        model = init_params(cfg, seed, device)
    elif isinstance(params, Transformer):
        model = params.to(device)
    else:
        model = params_from_numpy(params, cfg, device)
    cache_len = cache_len or (prompt_len + gen)
    prefill_step = make_prefill_step(cfg, cache_seq_len=cache_len)
    serve_step = make_serve_step(cfg)
    tokens_in = cfg.input_kind == "tokens"
    if prompts is None:
        gen_t = torch.Generator().manual_seed(seed)
        prompts = (torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen_t) if tokens_in
                   else torch.randn((batch, prompt_len, cfg.d_model), generator=gen_t).to(torch.bfloat16))
    if not isinstance(prompts, torch.Tensor):
        prompts = torch.from_numpy(np.array(prompts))
    prompts = prompts.to(device=device, dtype=torch.int32) if tokens_in else prompts.to(device)

    ctx = contextlib.ExitStack()
    if mesh is not None:
        ctx.enter_context(partition.logical_axes(partition.current_axes()
                                                or logical_mapping(mesh.axis_names)))
        ctx.enter_context(partition.set_mesh(mesh))
    with ctx, torch.inference_mode():
        synchronize(device)
        t0 = time.perf_counter()
        cache, logits = prefill_step(model, prompts)
        synchronize(device)
        prefill_s = time.perf_counter() - t0

        tok = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, 1)
        out = [tok]
        t1 = time.perf_counter()
        for _ in range(gen - 1):
            cache, tok = serve_step(model, cache, decode_input(model, tok))
            out.append(tok)
        synchronize(device)
        decode_s = time.perf_counter() - t1
        toks = torch.cat(out, dim=1).cpu().numpy()

    # every tensor of the cache (rings and recurrent states); the
    # reference's cache also holds `pos` as an int32 scalar: 4 bytes
    cache_bytes = sum(t.numel() * t.element_size() for t in cache_tensors(cache)) + 4
    # raw bf16 cache equivalent for the same attention layers/window
    # (compression win); none for the attention-free ssm family
    raw_equiv = 0
    if cfg.family != "ssm":
        n_attn = cfg.hybrid_pattern()[0] if cfg.family == "hybrid" else cfg.n_layers
        w = _round_window(cfg.effective_kv_window(cache_len))
        raw_equiv = n_attn * batch * w * cfg.n_kv_heads * cfg.head_dim * 2 * 2
    return ServeRun(
        prefill_s=prefill_s,
        decode_s=decode_s,
        tokens_generated=batch * gen,
        decode_tok_per_s=batch * (gen - 1) / max(decode_s, 1e-9),
        cache_bytes=cache_bytes,
        cache_bytes_raw_equiv=raw_equiv,
        tokens=toks,
        prefill_logits=logits,
        cache=cache,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--raw-cache", action="store_true", help="disable NUQ KV compression")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    cfg = spec.model.reduced() if args.reduced else spec.model
    if args.raw_cache:
        cfg = dataclasses.replace(cfg, kv_quant=False)
    device = resolve_device(args.device)
    run = serve(cfg, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen, device=device)
    print(json.dumps({
        "arch": args.arch,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "prefill_s": round(run.prefill_s, 3),
        "decode_tok_per_s": round(run.decode_tok_per_s, 1),
        "cache_bytes": run.cache_bytes,
        "cache_bytes_raw_equiv": run.cache_bytes_raw_equiv,
        "kv_compression": round(run.cache_bytes_raw_equiv / max(run.cache_bytes, 1), 2)
        if run.cache_bytes_raw_equiv
        else None,
        "sample_tokens": run.tokens[0, :8].tolist(),
    }, indent=1))


if __name__ == "__main__":
    main()
