#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line per check:
  1. build   — compile the CUDA kernels of src/repro_torch/csrc with nvcc;
  2. kernels — hold each kernel bit-exact against its plain PyTorch version
               on the card. B1-B4 at the main path's shapes (128 blocks x
               2048 symbols, OW 4098, bitlens including 0 and 64), on a
               ragged tail block and on the kernel contract
               pack_blocks(block=256), B1 with B4 fused in
               (`pack_blocks_meta7`, the executor's form) wherever the block
               is a multiple of 32 symbols, also on blocks of 32, 64, 96,
               4,096 and 2,080 symbols and off a 16-byte boundary; B1/B2
               also on blocks of 333 symbols
               (the scalar loads), of 64-bit symbols, of 4,100 symbols (two
               rounds), with rows narrower than the live prefix, on tensors
               that start off a 16-byte boundary, and B2 on random words
               whose offsets run past the row; B5 (dictionary probe) with 1 and 4
               lanes of 512 tuples at idx_bits 12 and 10; B5's codec form
               (the chunk walk, encode and decode) against its plain
               versions and the per-block route (the probe and the merge in
               torch ops) on the tdic32 path's first two chunks of Rovio at
               idx_bits 12, 10 and 4 (collisions), with 4 lanes and lane 0,
               and on 7 blocks of 333 tuples per lane, each in two calls
               (state carried), two of the cases also from a state seeded
               by a dictionary trained on the same values (valid slots
               stamped 0, empty ones -1, as `TrainedDict.seed_state` gives
               them); B3 also with n of 1, 3, 128 and 300 blocks,
               OW odd and even, zero-width and full blocks, a prefix longer
               than its row and one past the array (the clipped gather),
               on inputs 0-3 words off a 16-byte boundary; B8/B9 (rANS) on
               a section whose last chunk is partial and on a constant
               stream, which never emits, and B8's section form
               (`rans_section_encode`, the one the entropy stage runs) on
               the same sections against the contract route's states,
               counts and stream, and on sections of 1, 4,095, 4,096, 4,097
               and 300,000 bytes (constant, uniform and skewed; two off a
               16-byte boundary); B9's section form
               (`rans_section_decode`, the one the entropy stage runs) on
               the same sections (two with their stream words off a
               16-byte boundary) against its plain version, the contract
               kernel's route and the bytes, and on corrupt sections
               (random lane states, counts moved between lanes, a non-zero
               odd pad half, a stream of exactly cap u16s); B6/B7
               (delta-NUQ) in the Pallas
               contract at the reference test's shapes and at S=1024,
               T=4096, and in the ADPCM codec's per-lane form (the
               speculative encode, the scan decode and the two serial
               kernels) on the first 16 blocks of ECG and on 16 blocks of
               each adversarial stream (noise, a square wave and a saw
               past the bounds, the never-converging ramp) in two calls
               (state carried), the new kernels against the serial ones on
               48 blocks of each adversarial stream, and the decode's
               kernel choice (a non-integral table; carried states outside
               the rule), each at qbits 4, 8 and 12;
  3. path    — compress the paper's evaluation volume (932,800 bytes of
               Rovio, seed 7) on the card with raw32, tcomp32, leb128,
               delta_leb128, tdic32 (frozen/private, frozen/shared, and
               exact/private on the first 16 blocks), rle, and
               delta_leb128 and tcomp32 with entropy="rans"; then the lossy
               codecs: adpcm, uaadpcm, pla and adpcm+rans on as many bytes
               of ECG (calibrated on its first 8,192 tuples), leb128_nuq and
               uanuq at their defaults on the Rovio volume. The frame bytes
               must equal the CPU path's; `ingest` on the card must return
               the input exactly (lossless) or the CPU path's decode, with
               the max-abs error within `error_bound()` where the codec has
               one (lossy); two configurations run with integrity="crc32c",
               and every kernel of a path must launch;
  4. full    — the main paths at full width on 64 MiB streams, each
               compressed and decoded on the card: on Rovio, each roundtrip
               exact, JobSpec() (tcomp32, 4 lanes, 8 KiB micro-batches,
               128-block chunks), the heavy tier JobSpec(codec=
               "delta_leb128", entropy="rans", egress=True), whose run must
               launch B8's and B9's section forms twice each (the metadata
               and payload sections) and their contract kernels never, and
               JobSpec(codec="tdic32"), whose 64 chunks must each launch
               B5's codec form once per direction and B5's probe never
               (no tail block); every codec run must launch B1 with B4
               fused in, B2 and B3 once per chunk, B4 alone never and B1
               alone only for a tail or flush block (none at 64 MiB); on
               ECG, JobSpec(codec="adpcm")
               .calibrated(sample), whose card decode is held against the
               CPU path's decode of the first 16 blocks (the CPU's per-lane
               scan is too slow for 64 MiB), and whose 64 chunks must each
               launch the speculative encode and the scan decode once. The
               kernel launch counts are set to 0 just before each run and
               read just after it; each run must launch its kernels. Then
               the codec form's new kernels against the serial ones over
               all 64 chunks of the ECG stream, state carried;
  5. api     — the job API (`repro_torch.cstream`) on the same 64 MiB
               Rovio stream, pushed as eight 8 MiB segments, each a push
               and a flush with egress (8 chunks of 128 blocks a segment):
               api/tdic32-dict, a tdic32 job seeded from a dictionary
               trained on the stream's first 262,144 values and published
               as rovio v1 in a registry under a temporary directory, hot-
               swapped to v2 (trained on the next 262,144) after the fourth
               flush, beside a cold tdic32 job over the same segments; and
               api/adaptive, a tcomp32 job on the tier ladder under a
               scripted schedule that visits every rung twice or more, then
               under the default controller. Each job's handle window (its
               pushes and flushes, with the in-memory roundtrip) and the
               collector window (every frame's wire bytes ingested by a
               pipeline of the frame's codec) have their launch counts set
               to 0 just before and read just after: B5's codec form runs
               once per chunk and direction in the handle window from the
               seeded table and once per chunk in the collector's decode,
               B5's probe never; B8's section form runs twice per heavy
               segment in the handle window and B9's twice per heavy frame
               in the collector's, the contract kernels never. Frames must
               carry their dictionary ids and rungs, every roundtrip must be
               exact, and the first two segments' frames (and the tier
               logs) must equal those of the same handles opened with
               device="cpu";
  6. gang    — gang execution and the serving runtime: each 64 MiB stream
               (Rovio for JobSpec(codec="tcomp32") and JobSpec(codec=
               "tdic32"), ECG for JobSpec(codec="adpcm") calibrated on its
               first 8,192 tuples) split into 16 contiguous 4 MiB members
               through `cstream.gang_compress(..., emit_frames=True)`: the
               16 members fold into 64 lanes, so each of the 4 gang chunks
               (128, 64, 512) is one launch of B1+B4, of B3 and of the
               codec's chunk kernel (B5's codec form, B6) for all members,
               against 64 of each for the 16 solo `run_compress` runs;
               every member's frame equals its solo card frame, members 0-1
               the CPU path's. Then `cstream.Dispatcher(gang=True)` with 16
               sessions (8 tcomp32, 8 tdic32, egress), each topic fed its
               own 4 MiB of the Rovio stream at the paper's 16 MB/s under
               zipf 0.7 bursts (512 full flushes a topic), against
               Dispatcher(gang=False): equal `FlushRecord.key()` lists and
               byte-identical frames per topic, two topics alone on a CPU
               dispatcher equal too; one B1+B4 launch per wave or solo
               flush and one B5 probe per tdic32 one. Walls on the host
               clock (gang against the solo sum; the replay's host time
               apart from the summed wave walls), signature statistics and
               device busy shares;
  7. fleet   — the sharded serving fleet (`runtime/elastic.py`,
               `gang_step(mesh=...)`): the serving cell's 16 topics through
               Dispatcher(gang=True, mesh=ElasticSession(4, profile=
               "cstream", devices=[cuda:(i % device_count)])) (on one card
               all four slots are that card): flush keys and frames equal
               the gang phase's unsharded Dispatcher(gang=True); each wave
               pads to a multiple of 4 by replicating member 0 and launches
               B1+B4 (and, for tdic32, B5's probe) once per shard, a solo
               flush once; then the chaos run on the first 1 MiB of each
               topic, slot 2 lost during wave 1 and slot 0 during wave 3
               (4 -> 3 -> 2 slots), frames equal to the unsharded gang's at
               that volume; a mixed [cuda:0, cpu] mesh over t00, t01, t08
               and t09 at 1 MiB each (two topics a signature, so waves of
               two shard one member to each slot): frames equal, every
               tensor of a shard on its slot's device, only the card's
               shard launching; and `engine.sharded_compress_fn` over 4
               slots on 16 lanes x 128 blocks of 2,048 Rovio tuples
               (tdic32 shared, tcomp32 private): the card's words, bit
               totals and state equal 4 CPU slots';
  8. flash   — B10 (flash attention forward) against its plain version (a
               dense float32 softmax) on every case of FLASH_CASES, each
               through `ops.flash_attention_fwd`, which sends bf16 with Dh %
               16 == 0 to the tensor-core kernel and the rest to the FMA
               kernel (the line names the kernel that ran): the serving
               path's prefill shape (4 x 2048, 16 query and 8 kv heads of
               128, bf16), float32 at a smaller shape, windows whose late
               rows have fully masked leading tiles, ragged Sq and Sk (Sk <
               Sq and Sk > Sq), G 1, 2, 4 and 16 (MQA), Dh 16 to 128, a
               non-causal case, bf16 at Dh 40 (the FMA kernel), and the
               moe phase's shapes (`MOE_FLASH_CASES`, each of which must run
               on the tensor-core kernel): qwen3-moe-30b-a3b's prefill (4 x
               2,048, 32 query heads over 4), a 4,096 window over 8,192
               positions at mixtral-8x7b's G 4, deepseek-coder-33b's G 7
               (56 over 8) at 1 x 512, and the dense configs' prefills of
               the moe phase, 4 x 2,048 each: deepseek-coder-33b's G 7,
               mistral-nemo-12b's G 4 (32 over 8) and phi4-mini-3.8b's G 3
               (24 over 8); and the recurrent phase's head dims above 128
               (`RECURRENT_FLASH_CASES`, ROADMAP C6): recurrentgemma-9b's
               prefill (2 x 4,096, 16 query heads over 1 of 256, window
               2,048), which must run on the tensor-core kernel, a ragged
               windowed bf16 case at Dh 256, bf16 at Dh 192, bf16 at Dh 256
               not causal, and float32 at Dh 256 (the FMA kernel); and the
               frontends phase's musicgen-large prefill (4 x 2,048, 32 query
               heads over 32 of 64: G 1), which must run on the tensor-core
               kernel.
               Tolerance: float32 2e-4 (the reference test's rtol and atol);
               bf16 output one bf16 step, |d| <= 2^-7 |plain| + 1e-6
               elementwise. For the tensor-core cases the line also counts
               the outputs a torch emulation of that kernel's numerics puts
               outside the rule with p@v taking p as one, two and three bf16
               terms (the kernel takes three). Each case also runs B10's
               form that writes each row's log-sum-exp
               (`ops.flash_attention_fwd_lse`, one launch on the counter
               of that kernel's lse form: `flash_attention_fwd_lse` for
               the tensor-core kernel, `flash_attention_fwd_lse_fma` for
               the FMA kernel): out bit for bit the plain form's, lse
               within 1e-4 + 1e-5 |plain| of the plain version's;
  9. lm      — qwen3-1.7b served through `repro_torch.launch.serve.serve`:
               first at full width and 2 layers, 2 requests x 256 tokens and
               4 generated, the same weights and prompts on the card and on
               the CPU (prefill logits, cache codes and generated tokens
               compared, tolerances in `check_lm_card_vs_cpu`); then the
               full path at all 28 layers, 4 requests x 2,048 prompt tokens
               and 32 generated each, NUQ KV cache on, with the launch counts
               set to 0 just before and read just after (B10's tensor-core
               kernel must launch once per layer, its FMA kernel never), and
               one profiled prefill and decode for the device's busy time;
  10. train  — qwen3-1.7b trained through `repro_torch.launch.train`: at
               full width and 2 layers from the same numpy weights and
               tokens on the card and on the CPU, float32 and bf16 (loss,
               every parameter's gradient and one AdamW step on those
               gradients compared, tolerances in `TRAIN_CHECK`); the
               compressed feed at the full run's 4 x 1,025 tokens (four
               batches decoded on the card equal to the source's tokens,
               and B2's codes over each batch's one block equal to its
               plain version's on the same words); the gradient
               codec (`core/gradient.py`) on 64M floats at qbits 4 and 8
               (codes, scales and dequantized values equal); `train()` at
               full width and depth, 8 steps of 4 x 1,024 tokens from the
               compressed feed, with the launch counts set to 0 just
               before and read just after (B10's lse form twice per layer
               and step, the forward and full remat's recompute; B2 once
               per step; no other form of B10), finite losses, the last
               below the first, then one profiled step for the busy share;
               and the fault drill on the reduced config (12 steps,
               checkpoints every 4 under build/, a fault at step 6: one
               restart, final step 12) with a card checkpoint loaded on
               the CPU (`like=`), leaves equal;
  11. timing — each kernel and its plain version timed with CUDA events on
               the main paths' own inputs (B6/B7's codec form: the new and
               the serial kernels on the adpcm path's first chunk, and both
               encodes on the never-converging ramp at that shape; B5's
               codec form on the tdic32 path's first chunk beside the
               per-block route it replaced; B8's section form on the heavy
               tier's payload section beside the contract kernel, held
               bit-exact there and on the metadata section too; B9's
               section form on the same section beside its contract kernel,
               with the whole decode from host words to host bytes timed
               against the contract kernel's route it replaced; B1 with B4
               fused in on the tcomp32 path's first chunk; B1 and B2 on a
               row of 49,152 symbols, the planner's LAZY block, on their
               unstaged instances: `unstaged_*` on their rows); B10 on
               the full lm path's layer-0
               q, k, v: the tensor-core kernel in bf16 and the FMA kernel on
               the same values in float32, each beside torch's
               scaled_dot_product_attention on its inputs (`library_ms`, a
               yardstick the port never calls); B10's lse forms on the
               training path's layer-0 q, k, v (4 x 1,024): the
               tensor-core kernel's in bf16 beside torch's
               `_scaled_dot_product_flash_attention` (out and lse) and the
               plain flash backward's time, the FMA kernel's in float32
               beside `_scaled_dot_product_efficient_attention`. A plain
               version of seconds a call is timed in one call after a
               warm-up, which also gives the reference output (`timed_once`);
  12. moe    — the moe family and the remaining dense configs, on a card
               the earlier phases' models have left (< 2 GB allocated),
               TF32 off: one MoEFFN at qwen3-moe-30b-a3b's full width
               (128 experts, top-8) on 2 x 512 tokens on the card and the
               CPU, float32 and bf16 (`sel` agreement, (expert, slot)
               pairs, drops, y on the agreeing tokens; MOE_CHECK); each of
               qwen3-moe-30b-a3b, mixtral-8x7b, deepseek-coder-33b,
               mistral-nemo-12b and phi4-mini-3.8b served at full width and
               2 layers on the card and the CPU (LM_CHECK's fields and
               limits; the moe configs' cache codes over the slots fed the
               same tokens, MOE_CHECK); qwen3-moe-30b-a3b at full width cut
               to 12 of its 48 layers (4 x 2,048 + 32; cut for the script's
               time) and mixtral-8x7b at full width cut to 8 of
               its 32 layers (1 x 8,192 + 32, twice its window), each as
               the lm path (launches: B10's tensor-core kernel once a
               layer, its FMA kernel never; busy shares, host ops per
               step), the dropped pairs per layer of one more prefill, and
               for mixtral the ring (the last 4,096 positions stored, each
               decode step overwriting the oldest slot); then each dense
               config at full width and 16 of its layers, 4 x 2,048 + 8, as
               the lm path; then qwen3-moe-30b-a3b trained (ROADMAP A10
               item 6): at full width and 2 layers on the card and the CPU
               from the same numpy weights and tokens, 2 x 128, float32 and
               bf16 (loss, aux loss, each layer's routing recorded in the
               forward and in full remat's recompute, dropped pairs, every
               gradient with the stacked expert leaves compared on the
               experts routed alike, one AdamW step's updates;
               MOE_TRAIN_CHECK, TRAIN_CHECK), then `train()` at full width
               and MOE_TRAIN's depth, 8 compressed steps of 4 x 1,024
               (launches: B10's lse form twice a layer and step, B2 once a
               step), and a warm, a timed and a profiled step (busy share,
               top kernels, device ms by torch op);
  13. recurrent — the ssm and hybrid families, on a card the moe phase's
               models have left: mamba2-1.3b at full width and 2 layers and
               recurrentgemma-9b at full width and 5 layers (one group and
               the tail) on the card and the CPU from the same numpy
               weights and prompts, 2 x 256 + 4, in bf16 and in float32
               (prefill logits, every state, conv tail and ring scale,
               ring codes, first tokens; limits in RECURRENT_CHECK); then
               each served through
               `serve()` at full width and depth as the lm path:
               mamba2-1.3b (48 layers) at 4 x 2,048 + 32 with no B10
               launch, recurrentgemma-9b (38 layers) at 2 x 4,096 + 32 with
               B10's tensor-core kernel once a local-attention layer (12),
               the ring holding the last 2,048 positions and each decode
               step overwriting the oldest slot; busy shares, host ops per
               step, ring and state bytes; and B10's head-dim-256 instance
               timed on recurrentgemma's layer-0 q, k, v beside its plain
               version and torch's scaled_dot_product_attention (the
               memory-efficient call with the window as a mask; the flash
               call, causal over all keys). The kernels line gains the row
               `flash_attention_fwd_tc_dh256`, that instance's launches and
               times;
  14. frontends — the embedding front ends and attention logit softcaps,
               on a card the recurrent phase's models have left: B10 with a
               logit softcap (`CAP_FLASH_CASES`: musicgen's shape, windows,
               ragged Sk, Dh 64/128/256, float32 and Dh 40 on the FMA
               kernel) in both forms against the capped plain version
               within the flash phase's tolerances, the cap moving some
               output and lse by more than 100x them; musicgen-large and
               pixtral-12b at full width and 2 layers on the card and the
               CPU, bf16 and float32, on 2 x 256 front-end prompts (seeded
               EnCodec codes through the codebook sum; seeded 16 x 16 RGB
               patches through the projection) + 4 (`FRONTEND_CHECK`); the
               capped reduced qwen3-1.7b served on both in bf16 and float32
               (B10's tensor-core and FMA kernels once a layer) and one
               float32 train step each (`SOFTCAP_CHECK`); then, as the lm
               path, musicgen-large at full width and 24 of its 48 layers
               (4 x 2,048 frame embeddings + 32, B10's tensor-core kernel 24
               times) and pixtral-12b at full width and 10 of its 40 layers
               (4 x 2,048 patch embeddings + 8, 10 times); and B10 at
               musicgen's layer 0 timed without and with a cap (in turns),
               beside SDPA (which has no cap). The kernels line gains the
               row `flash_attention_fwd_tc_softcap`, the capped instances'
               launches and times;
  15. mesh   — the mesh machinery (`models/partition.py`, `compat.py`,
               `runtime/sharding.py`, `launch/mesh.py`), every slot on the
               one card: (a) `train(mesh=...)` of qwen3-1.7b at full width
               and depth on a (pod 2, data 1, model 1) mesh, masters and
               AdamW moments sharded by `param_specs(cfg, "train")`, the
               compressed pod sync, 3 steps of 4 x 1,024 from the B2 feed
               (B10's lse form 2 x 28 x 3 times in each slot's program, B2
               once a step); (b) qwen3-1.7b at full width and depth served
               4 x 2,048 + 8 with the ring over a (data 1, model 4) mesh,
               the decode through the distributed-LSE merge; (c)
               qwen3-moe-30b-a3b at full width and 4 of its 48 layers, 4 x
               2,048 + 4 on a (data 4, model 1) mesh, the moe dispatch per
               data shard and B10 once a layer in each shard's slot
               program. Each first held card against CPU on the same mesh
               at full width and 2 layers (TRAIN_CHECK in float32 and bf16
               on each leaf's merged gradient entering the compressed sync
               and on the step's updates, LM_CHECK, MOE_CHECK).
               Lines carry step seconds, peak memory, the collectives'
               bytes (`compat.wire_bytes`) and busy shares;
  16. tp     — tensor parallelism over the model axis, every slot on the
               one card (`run_tp`): (a) qwen3-1.7b split over (data 1,
               model 4) at full depth, (b) its split training on (pod 2,
               data 1, model 2), (c) qwen3-moe's experts over (data 1,
               model 4); then the `tp_recurrent` paths
               (`run_tp_recurrent`): (d) mamba2-1.3b and (e)
               recurrentgemma-9b served split over (data 1, model 4) at
               full width and depth, (f) mamba2-1.3b's split training on
               (pod 2, data 1, model 2). Each first held card against CPU on
               the same mesh (LM_CHECK, RECURRENT_CHECK, TRAIN_CHECK,
               MOE_CHECK["route"]); B10 launched in each slot's program on
               its heads; every state and ring held as shards;
  17. tp_train — training split over (pod 1, data 1, model 4), every slot
               on the one card, no pod sync (`run_tp_train`, TP_TRAIN_SPLIT):
               recurrentgemma-9b at 3 of 38 layers (B10's lse form on its
               Dh 256 instance), qwen3-moe-30b-a3b's experts split at 3 of
               48 and mixtral-8x7b's experts' d_ff split at 1 of 32, each
               first held card against CPU on the same slots in float32
               and bf16 (`check_split_train_card_vs_cpu`: loss, aux loss,
               gradient norm, AdamW's first moment and the updates shard by
               shard, the moe routing in the forward and the recompute, the
               dropped pairs; TRAIN_CHECK, MOE_TRAIN_CHECK["sel_set"]),
               then 2 steps of `train(mesh=...)` through B2 with B10's
               launches counted per slot; the lse form at the hybrid's
               shape timed beside SDPA's flash call;
  18. examples — the PyTorch twins of the reference's five examples
               (`examples/torch_*.py`), each run in this process on the
               card at its small setting (train_lm: --small --steps 8
               --fail-at 4; the others at their defaults), its printed
               lines checked (EXAMPLES) and its launches counted:
               quickstart's adpcm handle runs B1 with B4, B3, B6 and B7,
               multipod_tour's sharded tdic32 B1 and B5, serve_lm's
               prefill B10, train_lm's feed and step B2 and B10's lse form;
  19. helpers — the reference's last public helpers on the card
               (`run_helpers`): `Codec.roundtrip` of raw32 and every codec
               of Table 1 on a slice of the eval volume (4 lanes x
               HELPERS_TUPLES; lossless: the input exactly; lossy: the CPU
               path's roundtrip, within `error_bound()`; adpcm's B6/B7 and
               tdic32's B5 launched), `Encoded.total_bits` against the
               CPU's, a card compress's `CompactedPayload.block_payloads()`
               against the CPU path's block by block, `init_cache` on the
               card and its `cache_bytes`, and one B1+B4 launch timed by
               `metrics.timed`.
Then one JSON line of per-kernel numbers, the card's name and power limit as
nvidia-smi reports them, and a last JSON line with the device.

Any failure is an uncaught exception and a non-zero exit. Without a CUDA
device the script exits non-zero before printing any result. It imports
nothing of jax or of the reference package `repro`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import cstream  # noqa: E402
from repro_torch.api import JobSpec  # noqa: E402
from repro_torch.core import bits, dictstore  # noqa: E402
from repro_torch.core.algorithms import WIRE_CODEC_NAMES, make_codec  # noqa: E402
from repro_torch.core.pipeline import CompressionPipeline, DecompressionPipeline  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.core import engine, entropy, kvcache, metrics  # noqa: E402
from repro_torch.runtime.elastic import ElasticSession  # noqa: E402
from repro_torch.runtime.fault import DeviceLossInjector  # noqa: E402
from repro_torch.kernels import build, delta_nuq, flash_attn, ops, rans, ref  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.serve import decode_input, serve  # noqa: E402
from repro_torch.models import frontends, layers, moe  # noqa: E402
from repro_torch.models.moe import MoEFFN  # noqa: E402
from repro_torch.models.params import Storage  # noqa: E402
from repro_torch.models.convert import params_to_numpy  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    _round_window, decode_greedy, decode_step, init_decode_cache, init_params, loss_fn, prefill, tp_active)
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.checkpoint.manager import tree_flatten  # noqa: E402
from repro_torch.core.gradient import GradCompressionConfig, dequantize_tensor, quantize_tensor  # noqa: E402
from repro_torch.data.pipeline import CompressedFeed, zipf_token_stream  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.launch.train import restore_state, state_like, state_tree, train  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw, apply_updates_  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch.launch.steps import TrainStepConfig  # noqa: E402
from repro_torch.models import partition  # noqa: E402
from repro_torch.runtime.elastic import make_mesh, reshard  # noqa: E402
from repro_torch.runtime.sharding import (  # noqa: E402
    Sharded, model_split, param_specs, physical_specs, slot_weight)

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W), for the bounds: the
#: device-memory rate, and the 32-bit scalar rate outside the tensor cores
#: (the sheet's float32 figure; it lists no int32 rate, and Hopper issues
#: int32 at a quarter of it, so the operations bound below is a floor);
#: B10's bf16 attention is bounded at the bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
#: the paper's evaluation volume (repro data/datasets.py PAPER_EVAL_BYTES)
EVAL_BYTES = 932800
FULL_BYTES = 64 << 20
#: tuples at the head of a stream that calibrate a lossy codec
CALIBRATION_TUPLES = 8192
#: the path phase: (name, JobSpec fields, blocks of the stream it compresses
#: or None for all, dataset); integrity is on for two of them, and the ECG
#: configurations are calibrated on the stream's first 8,192 tuples
PATH_CONFIGS = (
    ("raw32", dict(codec="raw32"), None, "rovio"),
    ("tcomp32", dict(codec="tcomp32"), None, "rovio"),
    ("leb128", dict(codec="leb128"), None, "rovio"),
    ("delta_leb128", dict(codec="delta_leb128", integrity="crc32c"), None, "rovio"),
    ("tdic32", dict(codec="tdic32"), None, "rovio"),
    ("tdic32/shared", dict(codec="tdic32", state="shared"), None, "rovio"),
    ("tdic32/exact", dict(codec="tdic32", params={"mode": "exact"}), 16, "rovio"),
    ("rle", dict(codec="rle"), None, "rovio"),
    ("delta_leb128+rans", dict(codec="delta_leb128", entropy="rans", integrity="crc32c"), None,
     "rovio"),
    ("tcomp32+rans", dict(codec="tcomp32", entropy="rans"), None, "rovio"),
    ("adpcm", dict(codec="adpcm"), None, "ecg"),
    ("uaadpcm", dict(codec="uaadpcm", params={"qbits": 8}), None, "ecg"),
    ("pla", dict(codec="pla"), None, "ecg"),
    ("adpcm+rans", dict(codec="adpcm", entropy="rans"), None, "ecg"),
    ("leb128_nuq", dict(codec="leb128_nuq"), None, "rovio"),
    ("uanuq", dict(codec="uanuq"), None, "rovio"),
)
#: the codec paths' per-chunk kernels: B1 with B4 fused in, B2 and B3
CHUNK_KERNELS = ("pack_blocks_meta7", "unpack_blocks", "compact_blocks")
#: the full phase: name -> (JobSpec, kernels its run must launch, dataset)
FULL_SPECS = {
    "tcomp32": (JobSpec(), CHUNK_KERNELS, "rovio"),
    "heavy": (
        JobSpec(codec="delta_leb128", entropy="rans", egress=True),
        CHUNK_KERNELS + ("rans_section_encode", "rans_section_decode"), "rovio",
    ),
    "tdic32": (JobSpec(codec="tdic32"), CHUNK_KERNELS + ("dict_chunk_encode", "dict_chunk_decode"), "rovio"),
    "adpcm": (JobSpec(codec="adpcm"), CHUNK_KERNELS + ("adpcm_lane_encode", "adpcm_lane_decode"), "ecg"),
}
#: kernels no path runs: B6/B7 in the Pallas contract's form, which only the
#: reference's tests call (the ADPCM codec runs their per-lane form); B8 and
#: B9 in the contract's form (the entropy stage runs their section forms);
#: B4 alone (the executor packs the 7-bit metadata in B1's launch, and its
#: blocks of a multiple of 32 symbols are the only ones it packs so); the
#: codec form's serial kernels (the serial encode is the speculative one's
#: oracle, the serial decode takes parameters outside the scan's integer
#: rule, which the ECG calibration meets); and B10's FMA kernel, which
#: takes float32 and the bf16 shapes outside the tensor-core kernel's rule
#: (the lm and train paths are bf16 at Dh 128), in both forms
OFF_PATH = ("adpcm_encode", "adpcm_decode", "adpcm_lane_encode_serial", "adpcm_lane_decode_serial",
            "rans_encode", "rans_decode", "pack_meta7_blocks", "flash_attention_fwd",
            "flash_attention_fwd_lse_fma")
#: B10's kernels, the LM paths' (the codec paths never launch them): the FMA
#: and tensor-core kernels as the serving prefill runs them, and each in the
#: form that also writes each row's log-sum-exp, which training runs (bf16:
#: the tensor-core kernel's; float32: the FMA kernel's)
LM_KERNELS = ("flash_attention_fwd", "flash_attention_fwd_tc", "flash_attention_fwd_lse",
              "flash_attention_fwd_lse_fma")
#: the kernels line's row of B10's tensor-core instance for head dims above
#: 128 (`flash_attn_tc.cu`, `Tiling<4>`): the same wrapper and counter as
#: `flash_attention_fwd_tc`; its launches are the recurrent phase's
DH256 = "flash_attention_fwd_tc_dh256"
#: the kernels line's row of B10's lse form at head dim 256 (the same
#: instance): the same wrapper and counter as `flash_attention_fwd_lse`; its
#: launches are the tp_train phase's split recurrentgemma training's
DH256_LSE = "flash_attention_fwd_lse_dh256"
#: B10's kernel -> its lse form's wrapper
LSE_FORM = {flash_attn.TENSOR_CORE: "flash_attention_fwd_lse", flash_attn.FMA: "flash_attention_fwd_lse_fma"}
#: kernels the eval paths run and the full paths do not: B5's probe, which
#: tdic32 takes for a tail block (the 64 MiB stream has none), under the
#: shared-state strategy and outside `dict_hash.chunk_kernel_for`; and B1
#: alone, which packs a tail block and rle's flush block
EVAL_ONLY = ("dict_probe", "pack_blocks")
#: kernel -> (CUDA source, the Pallas kernel it replaces)
KERNELS = {
    "pack_blocks": ("src/repro_torch/csrc/bitpack.cu", "src/repro/kernels/bitpack.py:55"),
    # B1 with B4 fused in: B4's reference site (B1's is pack_blocks')
    "pack_blocks_meta7": ("src/repro_torch/csrc/bitpack.cu", "src/repro/kernels/frame_compact.py:100"),
    "unpack_blocks": ("src/repro_torch/csrc/bitunpack.cu", "src/repro/kernels/bitunpack.py:61"),
    "compact_blocks": ("src/repro_torch/csrc/frame_compact.cu", "src/repro/kernels/frame_compact.py:54"),
    "pack_meta7_blocks": ("src/repro_torch/csrc/frame_compact.cu", "src/repro/kernels/frame_compact.py:100"),
    "dict_probe": ("src/repro_torch/csrc/dict_probe.cu", "src/repro/kernels/dict_hash.py:46"),
    "dict_chunk_encode": ("src/repro_torch/csrc/dict_chunk.cu", "src/repro/kernels/dict_hash.py:46"),
    # the codec's frozen decode, which has no Pallas twin
    "dict_chunk_decode": ("src/repro_torch/csrc/dict_chunk.cu",
                          "src/repro/core/algorithms/dictionary.py:130"),
    "rans_encode": ("src/repro_torch/csrc/rans.cu", "src/repro/kernels/rans.py:64"),
    "rans_section_encode": ("src/repro_torch/csrc/rans_section.cu", "src/repro/kernels/rans.py:64"),
    "rans_decode": ("src/repro_torch/csrc/rans.cu", "src/repro/kernels/rans.py:137"),
    "rans_section_decode": ("src/repro_torch/csrc/rans_section_decode.cu", "src/repro/kernels/rans.py:137"),
    "adpcm_encode": ("src/repro_torch/csrc/delta_nuq.cu", "src/repro/kernels/delta_nuq.py:86"),
    "adpcm_decode": ("src/repro_torch/csrc/delta_nuq.cu", "src/repro/kernels/delta_nuq.py:109"),
    "adpcm_lane_encode": ("src/repro_torch/csrc/delta_nuq.cu", "src/repro/kernels/delta_nuq.py:86"),
    "adpcm_lane_encode_serial": ("src/repro_torch/csrc/delta_nuq.cu", "src/repro/kernels/delta_nuq.py:86"),
    "adpcm_lane_decode": ("src/repro_torch/csrc/delta_nuq.cu", "src/repro/kernels/delta_nuq.py:109"),
    "adpcm_lane_decode_serial": ("src/repro_torch/csrc/delta_nuq.cu", "src/repro/kernels/delta_nuq.py:109"),
    "flash_attention_fwd": ("src/repro_torch/csrc/flash_attn.cu", "src/repro/kernels/flash_attn.py:84"),
    "flash_attention_fwd_tc": ("src/repro_torch/csrc/flash_attn_tc.cu", "src/repro/kernels/flash_attn.py:84"),
    # the training forward's forms with lse: bf16 on the tensor cores, float32 on the FMA kernel
    "flash_attention_fwd_lse": ("src/repro_torch/csrc/flash_attn_tc.cu", "src/repro/kernels/flash_attn.py:84"),
    "flash_attention_fwd_lse_fma": ("src/repro_torch/csrc/flash_attn.cu", "src/repro/kernels/flash_attn.py:84"),
}
#: B10's cases: (B, Sq, Sk, H, K, Dh, window, causal, dtype); the first is
#: the serving path's prefill shape. bf16 with Dh % 16 == 0 runs on the
#: tensor-core kernel (tiles of 128 rows and 64 keys), the rest on the FMA
#: kernel
FLASH_CASES = (
    (4, 2048, 2048, 16, 8, 128, None, True, torch.bfloat16),
    (2, 512, 512, 8, 2, 128, None, True, torch.float32),
    (2, 700, 700, 8, 4, 64, 96, True, torch.float32),  # windowed: late rows' leading tiles masked
    (1, 1000, 1000, 4, 2, 32, None, True, torch.float32),  # ragged
    (2, 300, 300, 4, 1, 128, None, True, torch.bfloat16),  # MQA
    (2, 300, 300, 4, 1, 128, 40, True, torch.float32),  # MQA, windowed
    (2, 700, 700, 8, 4, 64, 96, True, torch.bfloat16),  # Dh 64, windowed: leading tiles masked
    (2, 333, 250, 8, 2, 80, None, True, torch.bfloat16),  # ragged Sq and Sk, Sk < Sq, Dh 80
    (2, 200, 300, 8, 2, 96, 40, True, torch.bfloat16),  # Sk > Sq, windowed, Dh 96
    (1, 250, 250, 4, 4, 128, None, True, torch.bfloat16),  # G 1
    (1, 250, 250, 16, 1, 128, None, True, torch.bfloat16),  # G 16 (MQA)
    (1, 1000, 1000, 4, 2, 32, None, True, torch.bfloat16),  # Dh 32, ragged
    (1, 333, 333, 4, 2, 16, 50, True, torch.bfloat16),  # Dh 16, windowed
    (1, 190, 190, 4, 2, 128, None, False, torch.bfloat16),  # not causal
    (1, 200, 200, 4, 2, 40, None, True, torch.bfloat16),  # Dh 40: the FMA kernel in bf16
)
#: the moe phase's prefill shapes, each of which must run on the tensor-core
#: kernel: qwen3-moe-30b-a3b's (G 8); a 4,096 window over twice its length
#: at mixtral-8x7b's G 4 (8 of its 32 heads, so that the plain version's
#: dense float32 scores stay ~2 GB); deepseek-coder-33b's G 7; and the
#: dense configs' prefills of the moe phase at their own shapes:
#: deepseek-coder-33b's G 7, mistral-nemo-12b's G 4 and phi4-mini-3.8b's G 3
#: (the plain version's scores 3.8, 2.1 and 1.6 GB)
MOE_FLASH_CASES = (
    (4, 2048, 2048, 32, 4, 128, None, True, torch.bfloat16),
    (1, 8192, 8192, 8, 2, 128, 4096, True, torch.bfloat16),
    (1, 512, 512, 56, 8, 128, None, True, torch.bfloat16),
    (4, 2048, 2048, 56, 8, 128, None, True, torch.bfloat16),
    (4, 2048, 2048, 32, 8, 128, None, True, torch.bfloat16),
    (4, 2048, 2048, 24, 8, 128, None, True, torch.bfloat16),
)
FLASH_CASES += MOE_FLASH_CASES
#: the recurrent phase's shapes, at head dims above 128 (ROADMAP C6): the
#: first two, recurrentgemma-9b's prefill (2 x 4,096, 16 query heads over 1
#: of 256, window 2,048; the plain version's float32 scores 2.1 GB) and its
#: split prefill's (the tp_recurrent phase's (e): 4 of the 16 heads a model
#: slot, G 4), must run on the tensor-core kernel; a ragged, windowed bf16
#: case at Dh 256 (Sk > Sq); bf16 at Dh 192; bf16 at Dh 256, not causal;
#: float32 at Dh 256 (the FMA kernel)
RECURRENT_FLASH_CASES = (
    (2, 4096, 4096, 16, 1, 256, 2048, True, torch.bfloat16),
    (2, 4096, 4096, 4, 1, 256, 2048, True, torch.bfloat16),  # its split prefill: 4 heads a slot, G 4
    (4, 1024, 1024, 4, 1, 256, 2048, True, torch.bfloat16),  # its split training's slot: 4 heads, G 4
    (2, 333, 400, 8, 2, 256, 100, True, torch.bfloat16),
    (1, 500, 500, 8, 2, 192, None, True, torch.bfloat16),
    (1, 190, 190, 4, 2, 256, None, False, torch.bfloat16),
    (1, 600, 600, 4, 1, 256, 256, True, torch.float32),
)
FLASH_CASES += RECURRENT_FLASH_CASES
#: the frontends phase's prefill shape, musicgen-large's (4 x 2,048, 32
#: query heads over 32 of 64: G 1 at Dh 64, 8,192 rows a kv head; the plain
#: version's float32 scores 2.1 GB), which must run on the tensor-core kernel
FRONTEND_FLASH_CASES = ((4, 2048, 2048, 32, 32, 64, None, True, torch.bfloat16),)
FLASH_CASES += FRONTEND_FLASH_CASES
FLASH_F32_TOL = 2e-4
#: B10's log-sum-exp against its plain version's (`torch.logsumexp` of the
#: dense float32 scores): |d| <= 1e-4 + 1e-5 |plain|. Both are float32 sums
#: of the same exponentials in another order (the tensor-core kernel's by
#: `ex2.approx`, ~2 ulp a term), so a row's sum agrees to ~1e-6 relative
#: and its log to ~1e-6 absolute; the bound leaves 100x for rows of
#: thousands of keys
LSE_TOL = (1e-4, 1e-5)
#: the LM path: qwen3-1.7b, 4 requests x 2,048 prompt tokens, 32 generated
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen3-1.7b", 4, 2048, 32
#: decode steps in the profiled pass (its busy share is taken against the
#: unprofiled run's wall time for as many steps): 4 since the frontends
#: phase came (8 before): the profiler's overhead over ~2,300-14,500 host
#: ops a step took ~290 of the script's 1,146 s on a slow host, and the
#: script must stay within its time
LM_PROFILED_STEPS = 4


#: (kernel iterations, plain iterations, plain queued behind a sleep) of the
#: timing phase where not (100, 10, True): the plain versions that loop over
#: time launch thousands of ops per call (the codec form's: ~850,000 over
#: a 128-block chunk, seconds per call) and run unqueued
TIMING_ITERS = {
    "rans_encode": (20, 3, False),
    "rans_section_encode": (20, 3, False),
    "rans_decode": (20, 3, False),
    "rans_section_decode": (100, 3, False),
    "adpcm_encode": (20, 3, False),
    "adpcm_decode": (20, 3, False),
    "adpcm_lane_encode": (100, 1, False),
    "adpcm_lane_decode": (100, 1, False),
    "adpcm_lane_encode_serial": (5, 1, False),
    "adpcm_lane_decode_serial": (5, 1, False),
    "dict_chunk_encode": (100, 3, False),
    "dict_chunk_decode": (100, 3, False),
}
#: B5's codec form in phase `kernels`: (stream, idx_bits, lanes, tuples per
#: lane, blocks per call, seeded); each case runs two calls, the state
#: carried from a cold start or, seeded, from a dictionary trained on the
#: case's values. The Rovio cases are the tdic32 path's first two 128-block
#: chunks (4 lanes x 512 tuples), or lane 0 of them; "ragged" cuts the same
#: values into 333 tuples per lane and 7 blocks, a last chunk's shape
DICT_CHUNK_CASES = (
    ("rovio", 12, 4, 512, 128, False),
    ("rovio", 12, 1, 512, 128, False),
    ("rovio", 10, 4, 512, 128, False),
    ("rovio", 10, 1, 512, 128, False),
    ("rovio", 4, 4, 512, 128, False),  # 16 slots: collisions in every block
    ("ragged", 12, 4, 333, 7, False),
    ("ragged", 4, 1, 333, 7, False),
    ("rovio", 12, 4, 512, 128, True),
    ("rovio", 4, 4, 512, 128, True),  # every seeded slot overwritten
)
DICT_CHUNK_KERNELS = ("dict_chunk_encode", "dict_chunk_decode")
def adversarial_stream(name: str, n: int):
    """The codec form's adversarial streams: (uint32[n], vmax, dmax) of
    uniform noise over ECG's range (also at a dmax that is not an integer,
    where the encode walks in float32 and the decode is serial), a square
    wave past both bounds (the state clips at 0 and at vmax), a saw past
    vmax (the input clips), or a ramp steeper than dmax = 1 under vmax =
    2^24, on which no speculative guess ever converges."""
    t = np.arange(n)
    if name == "noise":
        return np.random.default_rng(14).integers(0, 1842, n).astype(np.uint32), 1841.0, 358.0
    if name == "noise_frac_dmax":  # not an integer: the float32 walk, the serial decode
        return np.random.default_rng(14).integers(0, 1842, n).astype(np.uint32), 1841.0, 355.812
    if name == "square":
        return np.where((t // 37) % 2 == 0, 0, 4000).astype(np.uint32), 1841.0, 358.0
    if name == "saw":
        return ((t % 300) * 13).astype(np.uint32), 1841.0, 358.0
    if name == "ramp":
        return (5 + 3 * t).astype(np.uint32), float(2**24), 1.0
    raise KeyError(name)


ADVERSARIAL = ("noise", "noise_frac_dmax", "square", "saw", "ramp")
LANE_KERNELS = ("adpcm_lane_encode", "adpcm_lane_encode_serial", "adpcm_lane_decode",
                "adpcm_lane_decode_serial")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sleep_cycles_per_ms() -> float:
    """Device clock cycles per millisecond, for `torch.cuda._sleep`."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)
    start.record()
    torch.cuda._sleep(10**7)
    end.record()
    end.synchronize()
    return 1e7 / start.elapsed_time(end)


def time_ms(fn, iters: int, cycles_per_ms: float, queued: bool = True):
    """(device ms, host ms) per call of `fn`, warm.

    Device time: CUDA events around `iters` calls that queue back to back
    behind a device sleep long enough to cover their enqueue, so the host's
    launch cost (argument checks, allocation, ctypes) is not counted. A
    function of thousands of launches (the plain rANS scans) overflows the
    launch queue behind any sleep; with `queued=False` it runs without the
    sleep, and its time includes the host's launch gaps (an upper bound of
    the device time). Host time: one call's wall clock up to a
    synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    sleep_ms = 2.0 * iters * host_ms + 5.0 if queued else 0.0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if queued and enqueue_ms >= sleep_ms:
        raise AssertionError(f"enqueue took {enqueue_ms:.3f} ms, past the {sleep_ms:.3f} ms sleep")
    return start.elapsed_time(end) / iters, host_ms


def timed_once(fn) -> tuple:
    """(fn's result, device ms, host ms) of one call after one warm-up call,
    unqueued, up to a synchronize: for a plain version of seconds a call
    (TIMING_ITERS' (_, 1, False)), whose timed call also gives the reference
    output, where `time_ms` and a call for the output would run it twice
    more: 2 x (14.8 s + 3.5 s) of the timing phase's 95.6 s in a run on the
    H100 (NVIDIA H100 80GB HBM3, 700 W)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over uint32 words held as int32 bit patterns."""
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((bits._u(a) - bits._u(b)).abs().max().item())


def random_symbols(gen: torch.Generator, n_blocks: int, symbols: int, dev):
    """Codes masked to their bit lengths, bitlens 0..64 with 0 and 64 present
    and two all-zero blocks (zero-width blocks must stay transparent)."""
    codes = torch.randint(-2**31, 2**31, (n_blocks * symbols, 2), generator=gen, dtype=torch.int64)
    blen = torch.randint(0, 65, (n_blocks * symbols,), generator=gen, dtype=torch.int64)
    blen[0], blen[1] = 0, 64
    if n_blocks > 7:
        blen.view(n_blocks, symbols)[3] = 0
        blen.view(n_blocks, symbols)[7] = 0
    c = codes & bits.M32
    c0 = c[:, 0] & bits.mask_bits(blen.clamp(max=32))
    c1 = c[:, 1] & bits.mask_bits((blen - 32).clamp(min=0))
    masked = bits._i32(torch.stack([c0, c1], dim=1))
    return masked.to(dev), blen.to(torch.int32).to(dev)


#: B1/B2's cases beyond check_kernels' B1-B4 ones: (blocks, symbols,
#: out_words, symbols' kind, words by which the inputs start off a 16-byte
#: boundary); "wide" is all 64-bit symbols, "random" bitlens 0..64
BITPACK_CASES = (
    (3, 333, 668, "random", 0),  # not a multiple of 4: the scalar loads
    (2, 2048, 4098, "wide", 0),  # the live prefix reaches 2S words
    (2, 2048, 700, "random", 0),  # out_words below the live prefix: bits dropped
    (1, 4100, 8202, "random", 0),  # two rounds of 2,048 symbols
    (4, 2048, 4098, "random", 1),  # unaligned: scalar loads, rows off their quads
    (3, 333, 101, "wide", 2),
    # rows whose copy does not fit shared memory: the unstaged instances (a
    # planner candidate's LAZY micro-batch block is one row of 49,152)
    (1, 49152, 98306, "random", 0),
    (2, 30000, 60002, "wide", 1),
)


def offset_copy(t: torch.Tensor, words: int) -> torch.Tensor:
    """A contiguous copy of `t` whose data starts `words` 4-byte words past
    a 16-byte boundary."""
    flat = torch.zeros(t.numel() + words, dtype=t.dtype, device=t.device)
    flat[words:] = t.reshape(-1)
    return flat[words:].view(t.shape)


def check_bitpack(dev) -> dict:
    """B1/B2 bit-exact against their plain versions on BITPACK_CASES, and B2
    on random words and bitlens whose offsets run past the row (windows
    clamp to the last word, then zeros); returns the max error per kernel."""
    gen = torch.Generator().manual_seed(13)
    err = {"pack_blocks": 0, "unpack_blocks": 0, "pack_blocks_meta7": 0}
    for nb, s, ow, kind, shift in BITPACK_CASES:
        codes, blen = random_symbols(gen, nb, s, dev)
        if kind == "wide":
            codes = bits._i32(torch.randint(0, 2**32, (nb * s, 2), generator=gen)).to(dev)
            blen = torch.full_like(blen, 64)
        codes, blen = offset_copy(codes, 2 * shift), offset_copy(blen, shift)
        words, nbits = ops.pack_blocks(codes, blen, block=s, out_words=ow)
        w_ref, n_ref = ref.pack_blocks_ref(codes, blen, s, ow)
        err["pack_blocks"] = max(err["pack_blocks"], max_abs_err(words, w_ref), max_abs_err(nbits, n_ref))
        if s % 32 == 0:  # unaligned inputs: the scalar loads
            want = (w_ref, n_ref, ref.pack_meta7_ref(blen.view(nb, s)))
            got = ops.pack_blocks_meta7(codes, blen, block=s, out_words=ow)
            err["pack_blocks_meta7"] = max(err["pack_blocks_meta7"],
                                           *(max_abs_err(a, b) for a, b in zip(got, want)))
        rows = offset_copy(words, shift)
        back = ops.unpack_blocks(rows, blen)
        err["unpack_blocks"] = max(err["unpack_blocks"], max_abs_err(back, ref.unpack_blocks_ref(rows, blen)))
        if 64 * s <= 32 * ow:  # every symbol fits the row
            err["unpack_blocks"] = max(err["unpack_blocks"], max_abs_err(back, codes))
    for nb, s, ow in ((4, 64, 40), (2, 333, 20), (128, 2048, 1000), (1, 40000, 70000)):
        words = bits._i32(torch.randint(0, 2**32, (nb, ow), generator=gen)).to(dev)
        blen = torch.randint(0, 65, (nb * s,), generator=gen, dtype=torch.int32).to(dev)
        got = ops.unpack_blocks(words, blen)
        err["unpack_blocks"] = max(err["unpack_blocks"], max_abs_err(got, ref.unpack_blocks_ref(words, blen)))
    # the fused 7-bit metadata at every group and round boundary: one and two
    # groups of 32, one and two rounds of 2,048 symbols, 4-byte offsets
    for nb, s, shift in META7_CASES:
        codes, blen = random_symbols(gen, nb, s, dev)
        codes, blen = offset_copy(codes, 2 * shift), offset_copy(blen, shift)
        got = ops.pack_blocks_meta7(codes, blen, block=s, out_words=2 * s + 2)
        want = (*ref.pack_blocks_ref(codes, blen, s, 2 * s + 2), ref.pack_meta7_ref(blen.view(nb, s)))
        err["pack_blocks_meta7"] = max(err["pack_blocks_meta7"],
                                       *(max_abs_err(a, b) for a, b in zip(got, want)))
    torch.cuda.synchronize()
    return err


#: the fused pack's cases beyond BITPACK_CASES: (blocks, symbols, words by
#: which the inputs start off a 16-byte boundary)
META7_CASES = ((5, 32, 0), (3, 64, 0), (2, 4096, 0), (9, 96, 1), (2, 2080, 3))


def check_kernels(dev) -> dict:
    """Bit-exact kernel-vs-plain checks; returns the max error per kernel."""
    gen = torch.Generator().manual_seed(11)
    err = {k: 0 for k in KERNELS}
    cases = [
        ("slice", 128, 2048, 2 * 2048 + 2),  # 128 blocks x 2048 symbols, OW 4098
        ("ragged_tail", 1, 4 * 444, 2 * 4 * 444 + 2),  # the eval volume's tail
        ("contract", 16, 256, None),  # the Pallas kernel's pack_blocks(block=256)
    ]
    for name, nb, s, ow in cases:
        codes, blen = random_symbols(gen, nb, s, dev)
        words, nbits = ops.pack_blocks(codes, blen, block=s, out_words=ow)
        w_ref, n_ref = ref.pack_blocks_ref(codes, blen, s, ow)
        err["pack_blocks"] = max(err["pack_blocks"], max_abs_err(words, w_ref), max_abs_err(nbits, n_ref))
        back = ops.unpack_blocks(words, blen)
        e = max(max_abs_err(back, ref.unpack_blocks_ref(words, blen)), max_abs_err(back, codes))
        err["unpack_blocks"] = max(err["unpack_blocks"], e)
        pay, tot = ops.compact_blocks(words, nbits)
        p_ref, t_ref = ref.compact_blocks_ref(words, nbits)
        err["compact_blocks"] = max(err["compact_blocks"], max_abs_err(pay, p_ref), abs(int(tot) - int(t_ref)))
        m = ops.pack_meta7_blocks(blen.view(nb, s))
        err["pack_meta7_blocks"] = max(err["pack_meta7_blocks"], max_abs_err(m, ref.pack_meta7_ref(blen.view(nb, s))))
        if s % 32 == 0:
            fused = ops.pack_blocks_meta7(codes, blen, block=s, out_words=ow)
            err["pack_blocks_meta7"] = max(err["pack_blocks_meta7"],
                                           *(max_abs_err(a, b) for a, b in zip(fused, (w_ref, n_ref, m))))
        torch.cuda.synchronize()
    for name, e in check_bitpack(dev).items():
        err[name] = max(err[name], e)
    err["compact_blocks"] = max(err["compact_blocks"], check_compact(dev))
    rng = np.random.default_rng(12)
    for lanes, idx_bits in ((1, 12), (4, 12), (1, 10), (4, 10)):
        ts = 1 << idx_bits
        x = bits.u32_tensor(rng.integers(0, 3 * ts, (lanes, 512)).astype(np.uint32), dev)
        table = bits.u32_tensor(rng.integers(0, 3 * ts, (lanes, ts)).astype(np.uint32), dev)
        table[:, :256] = x[:, :256]  # some values sit in some slots
        valid = torch.from_numpy((rng.random((lanes, ts)) < 0.7).astype(np.uint8)).to(dev)
        got = ops.dict_probe(x, table, valid, idx_bits)
        want = ref.probe_ref(x, table, valid, idx_bits)
        err["dict_probe"] = max([err["dict_probe"]] + [max_abs_err(g, w) for g, w in zip(got, want)])
        torch.cuda.synchronize()
    for name, e in check_dict_chunk(dev).items():
        err[name] = max(err[name], e)
    ragged = (rng.zipf(1.4, 37 * 4096 - 1234) - 1).clip(0, 255).astype(np.uint8)
    for data in (ragged, np.full(3 * 4096, 9, np.uint8)):
        e_enc, e_dec, e_sec, flags = check_rans(data, dev)
        err["rans_encode"] = max(err["rans_encode"], e_enc)
        err["rans_decode"] = max(err["rans_decode"], e_dec)
        err["rans_section_encode"] = max(err["rans_section_encode"], e_sec)
        if data.min() == data.max() and flags != 0:
            raise AssertionError(f"a constant stream emitted {flags} u16s")
    for n, kind, shift in SECTION_CASES:
        err["rans_section_encode"] = max(err["rans_section_encode"],
                                         check_section(section_bytes(n, kind), dev, shift))
        err["rans_section_decode"] = max(err["rans_section_decode"],
                                         check_section_decode(section_bytes(n, kind), dev, shift // 2))
    err["rans_section_decode"] = max(err["rans_section_decode"], check_corrupt_sections(dev))
    for name, e in check_delta_nuq(dev).items():
        err[name] = max(err[name], e)
    return err


def state_err(a: tuple, b: tuple) -> int:
    """`max_abs_err` over two Tdic32 kernel states (table, valid, ts, clock)."""
    return max(max_abs_err(x.to(torch.int32), y.to(torch.int32)) for x, y in zip(a, b))


def check_dict_chunk(dev) -> dict:
    """B5's codec form on every DICT_CHUNK_CASES case, two calls with the
    state carried from a cold or a seeded start: the kernels (through the codec's
    `encode_blocks`/`decode_blocks`, one launch per call and direction)
    against their plain versions and against the per-block route on the
    card (`encode_each_block`/`decode_each_block`: B5's probe and the merge
    in torch ops), symbols, values and every state tensor; the decode must
    return the input. Returns the max error of each kernel."""
    values = make_dataset("rovio", n_tuples=2 * 128 * 2048 // 4, seed=7).stream()
    pipe = CompressionPipeline(JobSpec(codec="tdic32"), device=dev)
    rovio = bits.u32_tensor(pipe.shape_blocks(values).blocks, dev)
    err = dict.fromkeys(DICT_CHUNK_KERNELS, 0)
    for stream, idx_bits, lanes, b, c, seeded in DICT_CHUNK_CASES:
        if stream == "rovio":
            data = rovio[: 2 * c].view(2, c, rovio.shape[1], b)[:, :, :lanes]
        else:
            data = bits.u32_tensor(values[: 2 * c * 4 * b].reshape(2, c, 4, b), dev)[:, :, :lanes]
        codec = make_codec("tdic32", idx_bits=idx_bits)
        if seeded:
            codec.seed_dictionary(dictstore.train_dict(bits.u32_numpy(data), idx_bits=idx_bits))
        start = codec.init_state(lanes, dev)
        enc = {"kernel": start, "plain": codec.kernel_state(start), "each": start}
        dec = dict(enc)
        for part in data:
            part = part.contiguous()
            before = ops.launch_counts()
            enc["kernel"], got = codec.encode_blocks(enc["kernel"], part)
            p_codes, p_blen, *enc["plain"] = ref.dict_chunk_encode_ref(part, *enc["plain"], idx_bits)
            enc["each"], each = codec.encode_each_block(enc["each"], part)
            dec["kernel"], x = codec.decode_blocks(dec["kernel"], got)
            p_x, *dec["plain"] = ref.dict_chunk_decode_ref(got.codes, *dec["plain"], idx_bits)
            dec["each"], e_x = codec.decode_each_block(dec["each"], got)
            after = ops.launch_counts()
            if any(after[k] != before[k] + 1 for k in DICT_CHUNK_KERNELS):
                raise AssertionError(f"tdic32 at idx_bits {idx_bits}, b {b} did not run "
                                     f"B5's codec form once per direction")
            k_state = codec.kernel_state(enc["kernel"])
            e = max(max_abs_err(got.codes, p_codes), max_abs_err(got.bitlen, p_blen),
                    max_abs_err(got.codes, each.codes), max_abs_err(got.bitlen, each.bitlen),
                    state_err(k_state, enc["plain"]), state_err(k_state, codec.kernel_state(enc["each"])))
            err["dict_chunk_encode"] = max(err["dict_chunk_encode"], e)
            k_state = codec.kernel_state(dec["kernel"])
            e = max(max_abs_err(x, p_x), max_abs_err(x, e_x), max_abs_err(x, part),
                    state_err(k_state, dec["plain"]), state_err(k_state, codec.kernel_state(dec["each"])))
            err["dict_chunk_decode"] = max(err["dict_chunk_decode"], e)
        torch.cuda.synchronize()
    return err


def as_bits(t: torch.Tensor) -> torch.Tensor:
    """float32 as its int32 bit pattern, other tensors as they are."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def bits_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """`max_abs_err` of float32 tensors' bit patterns: 0 iff bit-identical."""
    return max_abs_err(as_bits(a), as_bits(b))


def ecg_stream(n_tuples: int) -> np.ndarray:
    return make_dataset("ecg", n_tuples=n_tuples, seed=7).stream()


def check_lane_plain(blocks: torch.Tensor, args: tuple, width: int, err: dict) -> None:
    """The codec form's four kernels against their plain versions on
    `blocks` in two calls (state carried): codes, bitlens, values and state
    bits. Folds each kernel's max error into `err`."""
    dev = blocks.device
    lanes = blocks.shape[1]
    fresh = (torch.zeros(lanes, device=dev), torch.zeros(lanes, dtype=torch.bool, device=dev))
    st = dict.fromkeys(LANE_KERNELS + ("enc_plain", "dec_plain"), fresh)
    half = blocks.shape[0] // 2
    for part in (blocks[:half].contiguous(), blocks[half:].contiguous()):
        p_codes, p_blen, *st["enc_plain"] = ref.adpcm_lane_encode_ref(part, *st["enc_plain"], *args, width)
        for name in ("adpcm_lane_encode", "adpcm_lane_encode_serial"):
            codes, blen, *st[name] = ops.WRAPPERS[name](part, *st[name], *args, width)
            e = max(max_abs_err(codes, p_codes), max_abs_err(blen, p_blen),
                    bits_err(st[name][0], st["enc_plain"][0]),
                    int(not torch.equal(st[name][1], st["enc_plain"][1])))
            err[name] = max(err[name], e)
        p_x, *st["dec_plain"] = ref.adpcm_lane_decode_ref(p_codes, *st["dec_plain"], *args)
        for name in ("adpcm_lane_decode", "adpcm_lane_decode_serial"):
            x, *st[name] = ops.WRAPPERS[name](p_codes, *st[name], *args)
            e = max(max_abs_err(x, p_x), bits_err(st[name][0], st["dec_plain"][0]),
                    int(not torch.equal(st[name][1], st["dec_plain"][1])))
            err[name] = max(err[name], e)
    torch.cuda.synchronize()


def check_lane_serial(blocks: torch.Tensor, args: tuple, width: int, chunk: int) -> dict:
    """The speculative encode and the scan decode against the serial kernels
    over `blocks` cut into calls of `chunk` blocks, the state carried from
    call to call: codes, bitlens, values and state bits. Returns the max
    error of each new kernel."""
    dev = blocks.device
    lanes = blocks.shape[1]
    fresh = (torch.zeros(lanes, device=dev), torch.zeros(lanes, dtype=torch.bool, device=dev))
    st = dict.fromkeys(LANE_KERNELS, fresh)
    err = {"adpcm_lane_encode": 0, "adpcm_lane_decode": 0}
    for i in range(0, blocks.shape[0], chunk):
        part = blocks[i: i + chunk].contiguous()
        codes, blen, *st["adpcm_lane_encode"] = ops.adpcm_lane_encode(part, *st["adpcm_lane_encode"], *args, width)
        s_codes, s_blen, *st["adpcm_lane_encode_serial"] = ops.adpcm_lane_encode_serial(
            part, *st["adpcm_lane_encode_serial"], *args, width)
        e = max(max_abs_err(codes, s_codes), max_abs_err(blen, s_blen),
                bits_err(st["adpcm_lane_encode"][0], st["adpcm_lane_encode_serial"][0]))
        err["adpcm_lane_encode"] = max(err["adpcm_lane_encode"], e)
        x, *st["adpcm_lane_decode"] = ops.adpcm_lane_decode(s_codes, *st["adpcm_lane_decode"], *args)
        s_x, *st["adpcm_lane_decode_serial"] = ops.adpcm_lane_decode_serial(
            s_codes, *st["adpcm_lane_decode_serial"], *args)
        e = max(max_abs_err(x, s_x), bits_err(st["adpcm_lane_decode"][0], st["adpcm_lane_decode_serial"][0]))
        err["adpcm_lane_decode"] = max(err["adpcm_lane_decode"], e)
    torch.cuda.synchronize()
    return err


def check_delta_nuq(dev) -> dict:
    """B6/B7 against their plain versions at qbits 4, 8 and 12: the Pallas
    contract (normal(0, 0.3) substreams, dmax 1.0) at the reference test's
    shapes and at S=1024, T=4096; the codec form's four kernels (the
    speculative encode, the scan decode and the two serial ones) on the
    first 16 blocks of the ECG evaluation stream (calibrated) and on 16
    blocks of each ADVERSARIAL stream, in two calls of 8 blocks with the
    state carried; the speculative encode and the scan decode against the
    serial kernels on 48 blocks of each adversarial stream (3 tiles of 8,192
    tuples per lane), in calls of 24 blocks, and on 24 blocks of 333 tuples
    per lane (noise) in calls of 12; and the decode's kernel choice:
    a calibrated dmax that is not an integer (355.812) on the serial kernel,
    and carried states outside the rule (17.5, 2000 > vmax, -0.0) walked
    serially inside the scan kernel. Returns the max error per kernel
    (codes and bit patterns of floats and states)."""
    rng = np.random.default_rng(13)
    err = dict.fromkeys(("adpcm_encode", "adpcm_decode") + LANE_KERNELS, 0)
    ecg = ecg_stream(EVAL_BYTES // 4)
    spec = JobSpec(codec="adpcm").calibrated(ecg[:CALIBRATION_TUPLES])
    pipe = CompressionPipeline(spec, device=dev)
    blocks = bits.u32_tensor(pipe.shape_blocks(ecg[: 16 * pipe.block_tuples]).blocks, dev)
    lanes, b = blocks.shape[1:]
    for qbits in (4, 8, 12):
        for s, t, sublanes, t_tile in ((8, 128, 8, 128), (16, 256, 8, 128), (32, 512, 16, 256),
                                       (1024, 4096, 8, 128)):
            x = torch.from_numpy(rng.normal(0, 0.3, (s, t)).astype(np.float32)).to(dev)
            codes = ops.adpcm_encode(x, qbits, 1.0, 255.0, sublanes, t_tile)
            e = max_abs_err(codes, ref.delta_nuq_encode_ref(x, qbits, 1.0, 255.0, t_tile))
            err["adpcm_encode"] = max(err["adpcm_encode"], e)
            back = ops.adpcm_decode(codes, qbits, 1.0, 255.0, sublanes, t_tile)
            e = bits_err(back, ref.delta_nuq_decode_ref(codes, qbits, 1.0, 255.0, t_tile))
            err["adpcm_decode"] = max(err["adpcm_decode"], e)
        width = 8 * ((qbits + 7) // 8)
        check_lane_plain(blocks, (qbits, spec.codec_kwargs["vmax"], spec.codec_kwargs["dmax"], 255.0),
                         width, err)
        for name in ADVERSARIAL:
            values, vmax, dmax = adversarial_stream(name, 48 * lanes * b)
            adv = bits.u32_tensor(values.reshape(48, lanes, b), dev)
            check_lane_plain(adv[:16], (qbits, vmax, dmax, 255.0), width, err)
            for k, e in check_lane_serial(adv, (qbits, vmax, dmax, 255.0), width, 24).items():
                err[k] = max(err[k], e)
        # blocks of 333 tuples per lane: the speculative encode's 4-byte loads and stores
        values, vmax, dmax = adversarial_stream("noise", 24 * lanes * 333)
        odd = bits.u32_tensor(values.reshape(24, lanes, 333), dev)
        for k, e in check_lane_serial(odd, (qbits, vmax, dmax, 255.0), width, 12).items():
            err[k] = max(err[k], e)
    codes = ops.adpcm_lane_encode(blocks[:4].contiguous(), torch.zeros(lanes, device=dev),
                                  torch.zeros(lanes, dtype=torch.bool, device=dev), 8,
                                  spec.codec_kwargs["vmax"], 355.812, 255.0, 8)[0]
    carried = torch.tensor([3.0, 17.5, 2000.0, -0.0][:lanes], device=dev)
    for dmax, xhat, init, kernel in ((355.812, torch.zeros(lanes, device=dev), False, "adpcm_lane_decode_serial"),
                                     (spec.codec_kwargs["dmax"], carried, True, "adpcm_lane_decode")):
        args = (codes, xhat, torch.full((lanes,), init, device=dev), 8, spec.codec_kwargs["vmax"], dmax, 255.0)
        before = ops.launch_counts()[kernel]
        got, want = ops.adpcm_lane_decode(*args), ref.adpcm_lane_decode_ref(*args)
        if ops.launch_counts()[kernel] != before + 1:
            raise AssertionError(f"the codec-form decode at dmax {dmax} did not run {kernel}")
        e = max(max_abs_err(got[0], want[0]), bits_err(got[1], want[1]))
        err[kernel] = max(err[kernel], e)
    torch.cuda.synchronize()
    return err


def check_lane_kernels_full(dev, values: np.ndarray) -> dict:
    """The codec form's speculative encode and scan decode against the
    serial kernels over every chunk of the 64 MiB ECG adpcm path (its
    calibrated spec, blocks and 128-block chunks), the state carried from
    chunk to chunk: codes, bitlens, values and state bits equal."""
    t0 = time.perf_counter()
    spec = FULL_SPECS["adpcm"][0].calibrated(values[:CALIBRATION_TUPLES])
    pipe = CompressionPipeline(spec, device=dev)
    codec = pipe.codec
    blocks = bits.u32_tensor(pipe.shape_blocks(values).blocks, dev)
    chunk = pipe.plan.scan_chunk
    err = check_lane_serial(blocks, (codec.qbits, codec.vmax, codec.dmax, codec.mu), codec._bitlen(), chunk)
    out = {"phase": "full", "path": "adpcm/new_vs_serial", "blocks": int(blocks.shape[0]),
           "chunks": -(-blocks.shape[0] // chunk), "max_abs_err": err, "seconds": time.perf_counter() - t0}
    emit(out)
    if any(err.values()):
        raise AssertionError(f"the codec form's new kernels differ from the serial ones on the ECG path: {err}")
    return err


def rans_decode_inputs(data: np.ndarray, dev):
    """One section's bytes through the library's encode half, as
    `entropy._encode_device` runs it: (syms, mask, freqs, B8's outputs,
    and B9's inputs stream, lane offsets, cap)."""
    syms, mask, freqs = entropy.section_grid(data, dev)
    enc = ops.rans_encode(syms, mask, freqs)
    stream, counts = entropy.assemble_stream(enc[1], enc[2])
    off, cap = entropy.lane_offsets(counts), entropy.decode_cap(syms.shape[0])
    return syms, mask, freqs, enc, stream, off, cap


def check_rans(data: np.ndarray, dev):
    """B8 and B9 against their plain versions on one section's bytes; the
    decode must also return the bytes; B8's section form must give the
    contract route's states, counts and stream (packed). (max err enc,
    max err dec, max err section form, u16s)."""
    syms, mask, freqs, enc, stream, off, cap = rans_decode_inputs(data, dev)
    e_enc = max(max_abs_err(a, b) for a, b in zip(enc, ref.rans_encode_ref(syms, mask, freqs)))
    got = ops.rans_decode(stream, freqs, enc[0], off, mask, cap)
    want = ref.rans_decode_ref(stream, cap, freqs, enc[0], off, mask)
    e_dec = max(max_abs_err(got, want), max_abs_err(got, torch.where(mask, syms, 0)))
    states, counts, words, _ = section_result(ops.rans_section_encode(torch.from_numpy(data).to(dev), freqs))
    e_sec = max(max_abs_err(states, enc[0]), max_abs_err(counts, enc[1].sum(dim=1, dtype=torch.int32)),
                max_abs_err(words, rans.packed_words(stream)))
    torch.cuda.synchronize()
    return e_enc, e_dec, e_sec, int(enc[1].sum())


#: B8's section form's edge sections beyond the path's: (bytes, kind, bytes
#: by which the data starts off a 16-byte boundary, where the staging loads
#: bytes one by one)
SECTION_CASES = tuple((n, kind, 0) for n in (1, 4095, 4096, 4097, 300_000)
                      for kind in ("constant", "uniform", "skewed")) + ((4097, "skewed", 3),
                                                                        (300_000, "uniform", 5))


def section_bytes(n: int, kind: str) -> np.ndarray:
    rng = np.random.default_rng(n + len(kind))
    if kind == "constant":
        return np.full(n, 9, np.uint8)
    if kind == "uniform":
        return rng.integers(0, 256, n).astype(np.uint8)
    return (rng.zipf(1.4, n) - 1).clip(0, 255).astype(np.uint8)


def section_result(out: tuple) -> tuple:
    """B8's section form's outputs with the stream cut to its ceil(E/2)
    words (the buffer's later words are not part of the result)."""
    states, counts, words, total = out
    return states, counts, words[: (int(total) + 1) // 2], total.reshape(1)


def check_section(data: np.ndarray, dev, shift: int = 0) -> int:
    """B8's section form against its plain version on one section's bytes,
    placed `shift` bytes past a 16-byte boundary; returns the max error."""
    flat = torch.zeros(data.size + shift, dtype=torch.uint8, device=dev)
    flat[shift:] = torch.from_numpy(data).to(dev)
    d = flat[shift:]
    freqs = entropy.quantize_freqs(torch.bincount(d, minlength=256)).to(torch.int32)
    got = section_result(ops.rans_section_encode(d, freqs))
    want = section_result(ref.rans_section_encode_ref(d, freqs))
    torch.cuda.synchronize()
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def section_decode_args(data: np.ndarray, dev, shift: int = 0):
    """A section's bytes through B8's section form, as `entropy.encode_section`
    codes them: (words int32[ceil(E/2)] placed `shift` words past a 16-byte
    boundary, E, freqs, states, counts, n) for B9's section form."""
    d = torch.from_numpy(data).to(dev)
    freqs = entropy.quantize_freqs(torch.bincount(d, minlength=256)).to(torch.int32)
    states, counts, words, total = ops.rans_section_encode(d, freqs)
    e = int(total)
    return offset_copy(words[: (e + 1) // 2], shift), e, freqs, states, counts, data.size


def contract_stream(stream_words: np.ndarray, total: int) -> np.ndarray:
    """The packed u16s unpacked on the host, one per uint32, as the entropy
    stage did before B9's section form."""
    w = np.ascontiguousarray(stream_words, np.uint32)
    stream = np.empty(2 * w.size, np.uint32)
    stream[0::2], stream[1::2] = w & np.uint32(0xFFFF), w >> np.uint32(16)
    return stream[:total]


def byte_mask(c: int, n: int, dev) -> torch.Tensor:
    """The contract kernel's byte mask over C chunks' grid: the first n."""
    return (torch.arange(c * rans.CHUNK_BYTES, device=dev) < n).reshape(c, rans.ROWS, rans.N_LANES)


def contract_decode_route(stream_words: np.ndarray, total: int, freqs: np.ndarray,
                          states: np.ndarray, counts: np.ndarray, n: int, dev) -> np.ndarray:
    """A section's decode as the entropy stage ran it before B9's section
    form: the u16s unpacked on the host and uploaded one per int32, the
    lane offsets, the byte mask over the chunk grid, the contract kernel's
    int32 symbol grid, narrowed to bytes and fetched."""
    c = states.shape[0]
    syms = ops.rans_decode(bits.u32_tensor(contract_stream(stream_words, total), dev),
                           torch.from_numpy(freqs.astype(np.int32)).to(dev), bits.u32_tensor(states, dev),
                           rans.lane_offsets(torch.from_numpy(counts.astype(np.int64)).to(dev)),
                           byte_mask(c, n, dev), rans.decode_cap(c))
    return syms.reshape(-1)[:n].to(torch.uint8).cpu().numpy()


def contract_route(words, total, freqs, states, counts, n) -> torch.Tensor:
    """B9's section form's arguments through the contract kernel: the u16s
    unpacked on the card, the lane offsets, the byte mask, the int32 grid
    narrowed to the n bytes."""
    c = states.shape[0]
    syms = ops.rans_decode(ref.unpack_u16(words, total), freqs, states, rans.lane_offsets(counts),
                           byte_mask(c, n, words.device), rans.decode_cap(c))
    return syms.reshape(-1)[:n].to(torch.uint8)


def check_section_decode(data: np.ndarray, dev, shift: int = 0) -> int:
    """B9's section form against its plain version, against the contract
    kernel's route on the unpacked stream and the chunk grid, and against the
    bytes, on one section (its stream words `shift` words off a 16-byte
    boundary: the guarded u16 reads); returns the max error."""
    args = section_decode_args(data, dev, shift)
    got = ops.rans_section_decode(*args)
    torch.cuda.synchronize()
    want = torch.from_numpy(data).to(dev)
    return max(max_abs_err(got, g) for g in (ref.rans_section_decode_ref(*args), contract_route(*args), want))


def corrupt_sections(dev):
    """(name, args) of sections the decoder accepts but the encoder never
    wrote: random lane states (lanes read past their runs and past the
    stream), a non-zero odd pad half, counts moved between lanes (same
    total) so lanes read their neighbours' u16s, and a stream of exactly
    cap u16s whose last lanes start at cap (reads clip to its last u16)."""
    rng = np.random.default_rng(21)
    data = section_bytes(3 * 4096 + 1001, "skewed")
    words, e, freqs, states, counts, n = section_decode_args(data, dev)
    rand_states = bits.u32_tensor(rng.integers(0, 2**32, states.shape, dtype=np.uint64).astype(np.uint32), dev)
    yield "random_states", (words, e, freqs, rand_states, counts, n)
    odd = section_decode_args(section_bytes(5000, "skewed"), dev)  # 1,351 u16s
    assert odd[1] % 2 == 1
    padded = odd[0].clone()
    padded[-1] |= bits._i32(torch.tensor(0xABCD0000, dtype=torch.int64)).to(dev)
    yield "odd_pad_half", (padded, *odd[1:])
    moved = counts.clone().view(-1)
    moved[0], moved[1] = moved[0] + moved[1], 0
    yield "moved_counts", (words, e, freqs, states, moved.view(counts.shape), n)
    cap = rans.decode_cap(1)
    full = bits.u32_tensor(rng.integers(0, 2**32, cap // 2, dtype=np.uint64).astype(np.uint32), dev)
    one_counts = torch.tensor([[cap, 0, 0, 0, 0, 0, 0, 0]], dtype=torch.int32, device=dev)
    yield "stream_at_cap", (full, cap, freqs, rand_states[:1].contiguous(), one_counts, 3000)


def check_corrupt_sections(dev) -> int:
    """B9's section form against its plain version and the contract
    kernel's route on `corrupt_sections`; returns the max error."""
    err = 0
    for _, args in corrupt_sections(dev):
        got = ops.rans_section_decode(*args)
        err = max(err, max_abs_err(got, ref.rans_section_decode_ref(*args)), max_abs_err(got, contract_route(*args)))
    torch.cuda.synchronize()
    return err


#: B3's cases beyond check_kernels' path shapes: (blocks, OW, kind, words by
#: which the inputs start off a 16-byte boundary); n of 1, 3, 128 and 300
#: (not a multiple of 4: the scalar count loads), OW even and odd
COMPACT_CASES = (
    (1, 4098, "random", 0), (1, 5, "clipped", 2), (3, 4097, "mixed", 1), (3, 33, "over", 3),
    (128, 4098, "mixed", 2), (128, 4097, "full", 3), (128, 66, "over", 0), (128, 9, "zero", 1),
    (300, 61, "random", 1), (300, 17, "clipped", 0), (300, 2, "full", 2),
)


def check_compact(dev) -> int:
    """B3 against its plain version on COMPACT_CASES: random bit counts up
    to the row, 'zero' (every block zero-width), 'full' (every row live),
    'mixed' (zero-width and full blocks among random ones), 'over' (a middle
    block's prefix longer than its row) and 'clipped' (the last block's
    prefix past the array); returns the max error."""
    err = 0
    for i, (n, ow, kind, shift) in enumerate(COMPACT_CASES):
        rng = np.random.default_rng(100 + i)
        words = rng.integers(0, 2**32, size=(n, ow), dtype=np.uint64).astype(np.uint32)
        nbits = rng.integers(0, 32 * ow + 1, size=n)
        if kind == "zero":
            nbits[:] = 0
        elif kind == "full":
            nbits[:] = 32 * ow
        elif kind == "mixed":
            nbits[::3], nbits[1::5] = 0, 32 * ow
        elif kind == "over":
            nbits[n // 2] = 32 * (ow + 7) - 5
        elif kind == "clipped":
            nbits[-1] = 32 * (ow + 9) - 1
        w = offset_copy(bits.u32_tensor(words, dev), shift)
        nb = offset_copy(torch.from_numpy(nbits.astype(np.int32)).to(dev), shift)
        pay, tot = ops.compact_blocks(w, nb)
        p_ref, t_ref = ref.compact_blocks_ref(w, nb)
        err = max(err, max_abs_err(pay, p_ref), abs(int(tot) - int(t_ref)))
    torch.cuda.synchronize()
    return err


def bound(nbytes: int, nops: int) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes the
    function must move (each input read once, each output written once)
    over the memory rate, and its 32-bit operations over the scalar rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


#: B1's and B2's unstaged instances' timed row: one row of 49,152 symbols
#: (a planner candidate's LAZY micro-batch block, the examples' planners'),
#: bitlens 0..64 at random, 98,306 words out
UNSTAGED_ROW = (1, 49152, 98306)


def time_unstaged(dev, cycles_per_ms: float) -> dict:
    """B1 and B2 on UNSTAGED_ROW, whose copy does not fit shared memory
    (`repro::fits_smem`: their unstaged instances), each held bit-exact
    against its plain version on it and timed beside it. Bound: time_kernels'
    bytes for B1 and B2 at that shape over the memory rate. Returns
    {kernel: {unstaged_ms, unstaged_plain_ms, unstaged_bound_ms,
    unstaged_symbols, unstaged_max_abs_err}}."""
    c, s, ow = UNSTAGED_ROW
    codes, blen = random_symbols(torch.Generator().manual_seed(17), c, s, dev)
    words, nbits = ops.pack_blocks(codes, blen, block=s, out_words=ow)
    live = int(((nbits.to(torch.int64) + 31) // 32).sum())
    w_ref, n_ref = ref.pack_blocks_ref(codes, blen, s, ow)
    plan = {
        "pack_blocks": (lambda: ops.pack_blocks(codes, blen, block=s, out_words=ow),
                        lambda: ref.pack_blocks_ref(codes, blen, s, ow),
                        max(max_abs_err(words, w_ref), max_abs_err(nbits, n_ref)),
                        c * s * 12 + c * ow * 4 + c * 4),
        "unpack_blocks": (lambda: ops.unpack_blocks(words, blen), lambda: ref.unpack_blocks_ref(words, blen),
                          max(max_abs_err(ops.unpack_blocks(words, blen), ref.unpack_blocks_ref(words, blen)),
                              max_abs_err(ops.unpack_blocks(words, blen), codes)),
                          live * 4 + c * s * 4 + c * s * 8),
    }
    out = {}
    for name, (kern, plain, e, nbytes) in plan.items():
        ms, _ = time_ms(kern, 50, cycles_per_ms)
        plain_ms, _ = time_ms(plain, 5, cycles_per_ms)
        out[name] = {"unstaged_ms": ms, "unstaged_plain_ms": plain_ms,
                     "unstaged_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "unstaged_symbols": c * s,
                     "unstaged_max_abs_err": e}
    return out


def time_kernels(dev, full_values: dict, heavy_frame: bits.Frame) -> dict:
    """Kernel and plain-version times at the main paths' shapes, on their
    own data: B1-B4 on the first fused chunk (128 blocks) of the tcomp32
    Rovio stream; B5 on one tdic32 block (4 lanes x 512 tuples) probing the
    table the stream built over the 64 blocks before it, and its codec form
    on the tdic32 path's first chunk (128 blocks) from the cold state, with
    the per-block route on the same chunk (`per_block_ms` unqueued,
    `per_block_busy_ms` its profiled device time); B8 in both forms and
    B9 on the heavy tier's payload section (the 64 MiB delta_leb128
    frame's raw payload), the section form also held bit-exact on its
    metadata section; B6/B7's codec form (the speculative encode, the scan decode
    and the serial kernels, one plain version per direction timed once) on
    the first chunk (128 blocks) of the 64 MiB ECG adpcm path, both encodes
    on the never-converging ramp at that shape (`never_converging_ms`,
    `never_converging_serial_ms`), and their Pallas contract on the same ECG
    stream's first 4M tuples as float32 substreams (S=1024, T=4096, t_tile
    128) at the path's qbits and dmax. Each kernel is first held bit-exact
    against its plain version on these inputs.

    Each plan entry holds the bytes and the 32-bit operations the function
    needs on these inputs: B1-B5 at their contracts' widths, with
    operations counted per element from their arithmetic (they are far
    below the byte bound); B8 (both forms) and B9 at the widths the stage
    needs, not the contract kernels' int32 grids: the section's n bytes, the table as 256 u16, the
    E u16s this data emits, and per (chunk, lane) a u32 state and a u16
    count; per byte 7 operations to encode (renorm shift and compare,
    divide, modulo, shift, two adds) or 6 to decode (mask, shift,
    multiply, add, subtract, compare), and per u16 2 to emit or 3 to read.
    B6/B7 count their tuples in and their symbols out (the codec form's
    codes as two words and a bitlen each; decode reads only word 0), the
    state and the tables; per step about 12 operations to encode (two
    clips, a subtraction, sign, abs, the code's shift and or, a lookup, a
    select, an addition) plus 2 per level of the binary search, and 7 to
    decode, whichever kernel computes it (the speculation's extra work is
    not the function's). B5's codec form counts its tuples in and symbols
    (or values) out and the state read and written once, 12 operations per
    tuple to encode and 10 to decode. `chain_steps` is each thread's serial
    chain (B5's codec form: two barriers per block; rANS:
    rows per lane; B6/B7: t_tile - 1, C*B per lane for the serial kernels,
    warm-up + segment for the speculative encode, a thread's share twice
    for the scan decode).
    Returns per kernel a dict of ms, plain_ms, bound_ms, bound_by, bytes,
    ops, chain_steps, host_ms, plain_host_ms and max_abs_err."""
    values = full_values["rovio"]
    pipe = CompressionPipeline(JobSpec(), device=dev)
    chunk = pipe.plan.scan_chunk
    shaped = pipe.shape_blocks(values[: chunk * pipe.block_tuples])
    blocks = bits.u32_tensor(shaped.blocks, dev)
    _, enc = pipe.codec.encode_blocks(pipe.init_state(), blocks)
    c, s = blocks.shape[0], pipe.block_tuples
    ow = 2 * s + 2
    blen = enc.bitlen.reshape(c * s).contiguous()
    codes = enc.codes.reshape(c * s, 2).contiguous()
    words, nbits = ops.pack_blocks(codes, blen, block=s, out_words=ow)
    live = int(((nbits.to(torch.int64) + 31) // 32).sum())
    mw = (7 * s + 31) // 32
    blen2 = blen.view(c, s)
    plan = {
        "pack_blocks": (
            lambda: ops.pack_blocks(codes, blen, block=s, out_words=ow),
            lambda: ref.pack_blocks_ref(codes, blen, s, ow),
            c * s * 12 + c * ow * 4 + c * 4,
            10 * c * s,  # offset scan, word/bit split, 4 shifts, 3 ors
        ),
        "unpack_blocks": (
            lambda: ops.unpack_blocks(words, blen),
            lambda: ref.unpack_blocks_ref(words, blen),
            live * 4 + c * s * 4 + c * s * 8,
            11 * c * s,  # offset scan, word/bit split, 4 shifts, 2 ors, 2 masks
        ),
        "compact_blocks": (
            lambda: ops.compact_blocks(words, nbits),
            lambda: ref.compact_blocks_ref(words, nbits),
            live * 4 + c * 4 + c * ow * 4 + 4,
            3 * c,  # word count and offset scan per block; the words are copies
        ),
        "pack_meta7_blocks": (
            lambda: ops.pack_meta7_blocks(blen2),
            lambda: ref.pack_meta7_ref(blen2),
            c * s * 4 + c * mw * 4,
            4 * c * s,  # mask, shift, or, and the split across two words
        ),
        # B1 and B4 in one launch: B1's bytes and B4's words out (the lengths read once)
        "pack_blocks_meta7": (
            lambda: ops.pack_blocks_meta7(codes, blen, block=s, out_words=ow),
            lambda: (*ref.pack_blocks_ref(codes, blen, s, ow), ref.pack_meta7_ref(blen2)),
            c * s * 12 + c * ow * 4 + c * 4 + c * mw * 4,
            14 * c * s,
        ),
    }
    tdic = CompressionPipeline(JobSpec(codec="tdic32"), device=dev)
    tblocks = bits.u32_tensor(tdic.shape_blocks(values[: chunk * tdic.block_tuples]).blocks, dev)
    tstate, _ = tdic.codec.encode_blocks(tdic.init_state(), tblocks[:64])
    x, table = tblocks[64].contiguous(), tstate["table"]
    valid = tstate["valid"].view(torch.uint8)
    idx_bits = tdic.codec.idx_bits
    plan["dict_probe"] = (
        lambda: ops.dict_probe(x, table, valid, idx_bits),
        lambda: ref.probe_ref(x, table, valid, idx_bits),
        x.numel() * 4 + table.numel() * 4 + valid.numel() + 3 * x.numel() * 4,
        8 * x.numel(),  # hash multiply and shift, two compares, and, symbol shift/or/select
    )
    cold = tdic.codec.kernel_state(tdic.init_state())
    dcodes = ops.dict_chunk_encode(tblocks, *cold, idx_bits)[0]
    nt_dict = tblocks.numel()
    dict_state = 2 * sum(t.numel() * t.element_size() for t in cold)  # read once, written once
    plan["dict_chunk_encode"] = (
        lambda: ops.dict_chunk_encode(tblocks, *cold, idx_bits),
        lambda: ref.dict_chunk_encode_ref(tblocks, *cold, idx_bits),
        nt_dict * (4 + 8 + 4) + dict_state,
        # per tuple: the probe's 8, the claim, and the owner's compare, key and write
        12 * nt_dict,
    )
    plan["dict_chunk_decode"] = (
        lambda: ops.dict_chunk_decode(dcodes, *cold, idx_bits),
        lambda: ref.dict_chunk_decode_ref(dcodes, *cold, idx_bits),
        nt_dict * (8 + 4) + dict_state,
        # per tuple: flag, index, literal, select, hash, the claim and the owner's
        10 * nt_dict,
    )
    section = np.ascontiguousarray(heavy_frame.payload, np.uint32).view(np.uint8)
    syms, mask, freqs, enc, stream, off, cap = rans_decode_inputs(section, dev)
    n, e, streams = section.size, stream.numel(), enc[0].numel()
    stage_bytes = n + 256 * 2 + 2 * e + streams * (4 + 2)
    plan["rans_encode"] = (
        lambda: ops.rans_encode(syms, mask, freqs),
        lambda: ref.rans_encode_ref(syms, mask, freqs),
        stage_bytes,
        7 * n + 2 * e,
    )
    # the section form computes the same function from the bytes
    section_dev = torch.from_numpy(section).to(dev)
    plan["rans_section_encode"] = (
        lambda: ops.rans_section_encode(section_dev, freqs),
        lambda: ref.rans_section_encode_ref(section_dev, freqs),
        stage_bytes,
        7 * n + 2 * e,
    )
    plan["rans_decode"] = (
        lambda: ops.rans_decode(stream, freqs, enc[0], off, mask, cap),
        lambda: ref.rans_decode_ref(stream, cap, freqs, enc[0], off, mask),
        stage_bytes,
        6 * n + 3 * e,
    )
    # B9's section form: the same function from the packed stream words
    d_states, d_counts, d_words, d_total = ops.rans_section_encode(section_dev, freqs)
    e_sec = int(d_total)
    d_words = d_words[: (e_sec + 1) // 2]
    dec_args = (d_words, e_sec, freqs, d_states, d_counts, n)
    plan["rans_section_decode"] = (
        lambda: ops.rans_section_decode(*dec_args),
        lambda: ref.rans_section_decode_ref(*dec_args),
        stage_bytes,
        6 * n + 3 * e,
    )
    chains = {"rans_encode": syms.shape[1], "rans_decode": syms.shape[1],
              "rans_section_encode": syms.shape[1], "rans_section_decode": syms.shape[1],
              # two barriers per block, one after the other in each lane's CTA
              "dict_chunk_encode": 2 * tblocks.shape[0], "dict_chunk_decode": 2 * tblocks.shape[0]}
    ecg = full_values["ecg"]
    apipe = CompressionPipeline(JobSpec(codec="adpcm").calibrated(ecg[:CALIBRATION_TUPLES]), device=dev)
    codec = apipe.codec
    ablocks = bits.u32_tensor(apipe.shape_blocks(ecg[: apipe.plan.scan_chunk * apipe.block_tuples]).blocks, dev)
    st = apipe.init_state()
    args = (codec.qbits, codec.vmax, codec.dmax, codec.mu)
    width = codec._bitlen()
    acodes = ops.adpcm_lane_encode(ablocks, st["xhat"], st["init"], *args, width)[0]
    nt, lanes = ablocks.numel(), ablocks.shape[1]
    tables = 4 * (2 * ((1 << (codec.qbits - 1)) - 1) + 1)
    search = 2 * (codec.qbits - 1)  # a compare and an index per level
    state = lanes * (4 + 1) * 2
    plan["adpcm_lane_encode"] = (
        lambda: ops.adpcm_lane_encode(ablocks, st["xhat"], st["init"], *args, width),
        lambda: ref.adpcm_lane_encode_ref(ablocks, st["xhat"], st["init"], *args, width),
        nt * 4 + nt * 8 + nt * 4 + state + tables,
        nt * (12 + search),
    )
    plan["adpcm_lane_decode"] = (
        lambda: ops.adpcm_lane_decode(acodes, st["xhat"], st["init"], *args),
        lambda: ref.adpcm_lane_decode_ref(acodes, st["xhat"], st["init"], *args),
        nt * 4 + nt * 4 + state + tables,
        nt * 7,
    )
    # the serial kernels: the same function, inputs, plain version and bound
    plan["adpcm_lane_encode_serial"] = (
        lambda: ops.adpcm_lane_encode_serial(ablocks, st["xhat"], st["init"], *args, width),
        *plan["adpcm_lane_encode"][1:],
    )
    plan["adpcm_lane_decode_serial"] = (
        lambda: ops.adpcm_lane_decode_serial(acodes, st["xhat"], st["init"], *args),
        *plan["adpcm_lane_decode"][1:],
    )
    chains["adpcm_lane_encode_serial"] = chains["adpcm_lane_decode_serial"] = nt // lanes
    chains["adpcm_lane_encode"] = delta_nuq.WARMUP + delta_nuq.SEGMENT
    chains["adpcm_lane_decode"] = 2 * -(-ablocks.shape[2] // 128)  # a thread's share, composed then applied
    sub = torch.from_numpy(ecg[: 1024 * 4096].astype(np.float32).reshape(1024, 4096)).to(dev)
    tile = (codec.qbits, codec.dmax, codec.mu)
    tcodes = ops.adpcm_encode(sub, *tile)
    plan["adpcm_encode"] = (
        lambda: ops.adpcm_encode(sub, *tile),
        lambda: ref.delta_nuq_encode_ref(sub, *tile, delta_nuq.DEFAULT_T),
        sub.numel() * 8 + tables,
        sub.numel() * (12 + search),
    )
    plan["adpcm_decode"] = (
        lambda: ops.adpcm_decode(tcodes, *tile),
        lambda: ref.delta_nuq_decode_ref(tcodes, *tile, delta_nuq.DEFAULT_T),
        sub.numel() * 8 + tables,
        sub.numel() * 5,
    )
    chains["adpcm_encode"] = chains["adpcm_decode"] = delta_nuq.DEFAULT_T - 1
    cpm = sleep_cycles_per_ms()
    out = {}
    plain_runs = {}  # a plain version shared by two kernels runs and is timed once
    for name, (kern, plain, nbytes, nops) in plan.items():
        kern_iters, plain_iters, queued = TIMING_ITERS.get(name, (100, 10, True))
        if plain not in plain_runs:
            plain_runs[plain] = (timed_once(plain) if (plain_iters, queued) == (1, False) else
                                 (plain(), *time_ms(plain, plain_iters, cpm, queued=queued)))
        want, plain_ms, plain_host_ms = plain_runs[plain]
        got = kern()
        if name == "rans_section_encode":
            got, want = section_result(got), section_result(want)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(max_abs_err(as_bits(g), as_bits(w)) for g, w in zip(got, want))
        ms, host_ms = time_ms(kern, kern_iters, cpm)
        bound_ms, bound_by = bound(nbytes, nops)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "bytes": nbytes, "ops": nops, "chain_steps": chains.get(name),
                     "host_ms": host_ms, "plain_host_ms": plain_host_ms, "max_abs_err": err}
    # the heavy tier's metadata section, the section forms' other input
    meta = np.ascontiguousarray(heavy_frame.packed_meta, np.uint32).view(np.uint8)
    out["rans_section_encode"]["max_abs_err"] = max(out["rans_section_encode"]["max_abs_err"],
                                                    check_section(meta, dev))
    out["rans_section_decode"]["max_abs_err"] = max(out["rans_section_decode"]["max_abs_err"],
                                                    check_section_decode(meta, dev))
    # the payload section's whole decode, host words to host bytes: the
    # entropy stage's route (B9's section form) against the contract
    # kernel's route it replaced (host u16 unpack, int32 upload, mask, B9 on
    # the int32 grid, narrowing), each synchronising, so unqueued
    host = (bits.u32_numpy(d_words), e_sec, bits.u32_numpy(freqs), bits.u32_numpy(d_states),
            bits.u32_numpy(d_counts), n)
    new_route, old_route = entropy._decode_device(*host, dev), contract_decode_route(*host, dev)
    if not (np.array_equal(new_route, section) and np.array_equal(old_route, section)):
        raise AssertionError("the decode routes did not return the heavy payload section")
    for key, fn in (("route_ms", lambda: entropy._decode_device(*host, dev)),
                    ("contract_route_ms", lambda: contract_decode_route(*host, dev))):
        out["rans_section_decode"][key] = time_ms(fn, 5, cpm, queued=False)[0]
    # the per-block route on the same chunk, as tdic32 ran it before B5's
    # codec form: B5's probe and the merge's torch ops, block by block; its
    # thousands of launches run unqueued, so also its device time alone
    cold_st = tdic.init_state()
    _, tenc = tdic.codec.encode_each_block(cold_st, tblocks)
    for name, fn in (("dict_chunk_encode", lambda: tdic.codec.encode_each_block(cold_st, tblocks)),
                     ("dict_chunk_decode", lambda: tdic.codec.decode_each_block(cold_st, tenc))):
        out[name]["per_block_ms"] = time_ms(fn, 3, cpm, queued=False)[0]
        out[name]["per_block_busy_ms"] = device_busy_ms(fn)
    # the never-converging ramp at the same shape: the speculative encode
    # against the serial kernel (held bit-exact to it first)
    rvals, rvmax, rdmax = adversarial_stream("ramp", nt)
    ramp = bits.u32_tensor(rvals.reshape(ablocks.shape), dev)
    rargs = (codec.qbits, rvmax, rdmax, codec.mu)
    spec_out = ops.adpcm_lane_encode(ramp, st["xhat"], st["init"], *rargs, width)
    serial_out = ops.adpcm_lane_encode_serial(ramp, st["xhat"], st["init"], *rargs, width)
    err = max(max_abs_err(as_bits(g), as_bits(w)) for g, w in zip(spec_out, serial_out))
    out["adpcm_lane_encode"]["max_abs_err"] = max(out["adpcm_lane_encode"]["max_abs_err"], err)
    out["adpcm_lane_encode"]["never_converging_ms"] = time_ms(
        lambda: ops.adpcm_lane_encode(ramp, st["xhat"], st["init"], *rargs, width), 5, cpm)[0]
    out["adpcm_lane_encode"]["never_converging_serial_ms"] = time_ms(
        lambda: ops.adpcm_lane_encode_serial(ramp, st["xhat"], st["init"], *rargs, width), 5, cpm)[0]
    return out


def run_path(dev) -> dict:
    """Phase 3: the eval volume through every configuration, card vs CPU.
    Returns each kernel's launches over the phase."""
    data = {
        "rovio": make_dataset("rovio", n_tuples=EVAL_BYTES // 16, seed=7).stream(),
        "ecg": ecg_stream(EVAL_BYTES // 4),
    }
    assert all(v.size == EVAL_BYTES // 4 for v in data.values())
    before = ops.launch_counts()
    for name, fields, n_blocks, dataset in PATH_CONFIGS:
        values = data[dataset]
        spec = JobSpec(**fields)
        if dataset == "ecg":
            spec = spec.calibrated(values[:CALIBRATION_TUPLES])
        gpu_pipe = CompressionPipeline(spec, device=dev)
        v = values if n_blocks is None else values[: n_blocks * gpu_pipe.block_tuples]
        t0 = time.perf_counter()
        gpu = gpu_pipe.compress_to_frame(v).to_bytes()
        cpu = CompressionPipeline(spec, device="cpu").compress_to_frame(v).to_bytes()
        if gpu != cpu:
            raise AssertionError(f"{name}: card frame differs from the CPU path's frame")
        back = DecompressionPipeline(spec, device=dev).ingest(gpu).values
        lossy = gpu_pipe.codec.meta.lossy
        if lossy:
            if not np.array_equal(back, DecompressionPipeline(spec, device="cpu").ingest(cpu).values):
                raise AssertionError(f"{name}: the card's decode differs from the CPU path's")
        elif not np.array_equal(back, v):
            raise AssertionError(f"{name}: ingest on the card did not return the input")
        err = int(np.abs(back.astype(np.int64) - v.astype(np.int64)).max())
        bound = gpu_pipe.codec.error_bound()
        if bound is not None and err > bound:
            raise AssertionError(f"{name}: max-abs error {err} exceeds the codec's bound {bound}")
        emit({"phase": "path", "config": name, "dataset": dataset, "params": spec.codec_kwargs,
              "integrity": spec.integrity, "entropy": spec.entropy, "tuples": int(v.size),
              "wire_bytes": len(gpu), "ratio": v.nbytes / len(gpu), "frame_equals_cpu": True,
              "decode_equals_cpu": True, "exact": err == 0, "max_abs_err": err,
              "error_bound": bound, "seconds": time.perf_counter() - t0})
    after = ops.launch_counts()
    stale = [k for k in after if after[k] <= before[k] and k not in OFF_PATH + LM_KERNELS]
    if stale:
        raise AssertionError(f"the path did not launch: {stale}")
    return {k: after[k] - before[k] for k in after}


def bf16_step_ok(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Elementwise within one bf16 rounding step: |d| <= 2^-7 |want| + 1e-6."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= w.abs() * 2.0**-7 + 1e-6).all())


def bf16_outside(got: torch.Tensor, want: torch.Tensor) -> int:
    """Outputs not within one bf16 rounding step (NaN counts as outside)."""
    g, w = got.float(), want.float()
    return int((~((g - w).abs() <= w.abs() * 2.0**-7 + 1e-6)).sum())


def flash_within(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(within tolerance, the tolerance's statement) for B10 against its
    plain version: one bf16 step for bf16, 2e-4 + 2e-4 |plain| for f32."""
    if got.dtype == torch.bfloat16:
        return bf16_step_ok(got, want), "|d| <= 2^-7 |plain| + 1e-6 (one bf16 step)"
    d = (got - want).abs()
    return bool((d <= FLASH_F32_TOL + FLASH_F32_TOL * want.abs()).all()), "|d| <= 2e-4 + 2e-4 |plain|"


def split_emulation(q, k, v, window, causal, terms: int) -> torch.Tensor:
    """The tensor-core kernel's numerics in dense torch on the card: bf16
    q.k products in float32 scaled by f32(1/sqrt(Dh)), masked scores at
    -1e30, float32 p and l, then p@v as `terms` float32 products of bf16
    terms of p (each the bf16 rounding of what the terms before it leave),
    over max(l, 1e-30), in bf16. The kernel takes three terms; one and two
    show why."""
    b, sq, h, dh = q.shape
    sk, kh = k.shape[1], k.shape[2]
    vv = v.float().repeat_interleave(h // kh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(h // kh, dim=2))
    s *= flash_attn.scale(dh)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s.masked_fill_(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    del s
    l = p.sum(dim=-1)
    out = torch.zeros_like(q, dtype=torch.float32)
    for _ in range(terms):
        term = p.bfloat16().float()
        out += torch.einsum("bhqk,bkhd->bqhd", term, vv)
        p -= term
    return (out / l.clamp_min(1e-30).permute(0, 2, 1)[..., None]).to(q.dtype)


def check_flash(dev) -> dict:
    """Phase 5: B10 against its plain version on every case of FLASH_CASES,
    in both forms; returns the largest max-abs error of out for each of its
    two kernels in each form (the lse form's out is the plain form's), and
    under DH256 and DH256_LSE those of the tensor-core kernel's cases above
    head dim 128 in each form."""
    gen = torch.Generator(device=dev).manual_seed(21)
    worst = {k: 0.0 for k in LM_KERNELS}
    for case in FLASH_CASES:
        b, sq, sk, h, kh, dh, window, causal, dt = case
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((b, sq, h, dh), (b, sk, kh, dh), (b, sk, kh, dh)))
        before = ops.launch_counts()
        got = ops.flash_attention_fwd(q, k, v, window=window, causal=causal)
        ran = [n for n in LM_KERNELS if ops.launch_counts()[n] > before[n]]
        want = ref.flash_reference(q, k, v, window=window, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok, tol = flash_within(got, want)
        finite = bool(torch.isfinite(got).all())
        expected = flash_attn.kernel_for(dt, dh, h // kh)
        if (case in MOE_FLASH_CASES + RECURRENT_FLASH_CASES[:3] + FRONTEND_FLASH_CASES
                and expected != flash_attn.TENSOR_CORE):
            raise AssertionError(f"the B10 case {case} of a served config would run on {expected}")
        split = None
        if expected == flash_attn.TENSOR_CORE:  # outputs outside the rule with p in 1, 2, 3 bf16 terms
            split = {t: bf16_outside(split_emulation(q, k, v, window, causal, t), want) for t in (1, 2, 3)}
        emit({"phase": "flash", "case": {"B": b, "Sq": sq, "Sk": sk, "H": h, "K": kh, "Dh": dh,
                                         "window": window, "causal": causal, "dtype": str(dt)},
              "kernel": ran, "max_abs_err": err, "tolerance": tol, "within": ok, "finite": finite,
              "outside_by_split_terms": split})
        if ran != [expected]:
            raise AssertionError(f"B10 case {case} launched {ran}, expected {expected}")
        if not (ok and finite):
            raise AssertionError(f"B10 ({expected}) disagrees with its plain version at {case}: "
                                 f"max abs err {err}, finite {finite}")
        worst[expected] = max(worst[expected], err)
        if expected == flash_attn.TENSOR_CORE and dh > 128:
            worst[DH256] = max(worst.get(DH256, 0.0), err)
        lse_err = check_flash_lse(q, k, v, window, causal, got, LSE_FORM[expected])
        emit({"phase": "flash", "case": {"B": b, "Sq": sq, "Sk": sk, "H": h, "K": kh, "Dh": dh,
                                         "window": window, "causal": causal, "dtype": str(dt)},
              "kernel": [LSE_FORM[expected]], "out_bit_identical": True, "lse_max_abs_err": lse_err,
              "lse_tolerance": "|d| <= 1e-4 + 1e-5 |plain|"})
        worst[LSE_FORM[expected]] = max(worst[LSE_FORM[expected]], err)
        if expected == flash_attn.TENSOR_CORE and dh > 128:
            worst[DH256_LSE] = max(worst.get(DH256_LSE, 0.0), err)
    return worst


def check_flash_lse(q, k, v, window, causal, out, form: str) -> float:
    """B10's log-sum-exp form on the same inputs: one launch counted as
    `form` (the lse form of the kernel that made `out`) and none
    elsewhere, `out` bit for bit the plain form's `out`, lse within LSE_TOL
    of the plain version's. Returns lse's max-abs error."""
    before = ops.launch_counts()
    got, lse = ops.flash_attention_fwd_lse(q, k, v, window=window, causal=causal)
    after = ops.launch_counts()
    ran = {n: after[n] - before[n] for n in LM_KERNELS if after[n] != before[n]}
    _, want = ref.flash_reference_lse(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    if ran != {form: 1}:
        raise AssertionError(f"the lse form launched {ran}, expected {form}")
    if not torch.equal(got, out):
        raise AssertionError("B10's out differs with lse written beside it")
    atol, rtol = LSE_TOL
    d = (lse - want).abs()
    if not bool((d <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"B10's lse disagrees with its plain version: max abs err {d.max().item()}")
    return d.max().item()


#: the reduced-depth card-vs-CPU check: full width, 2 layers, 2 x 256 + 4;
#: prefill logits within 3 % of the largest |logit| (bf16 matrix products
#: sum in another order on the card, and B10 against its dense plain
#: version rounds its float32 output to bf16 at other ties: bf16-step
#: differences, grown over two layers; 1.0 % measured on the H100); cache
#: codes equal at a rate >= 0.999 in layer 0 (its k/v differ only by the
#: card's matrix-product rounding; 0.99988 measured) and >= 0.8 over both
#: layers (layer 1 sees layer 0's bf16 differences, and a value moving by
#: one bf16 step often moves its mu-law code by a level; 0.917 measured);
#: the first generated token equal for every request whose CPU top-2 logit
#: margin exceeds twice the logits' max error
LM_CHECK = dict(layers=2, batch=2, prompt_len=256, gen=4, logits_frac=0.03, codes_layer0=0.999,
                codes_all=0.8)


def check_lm_card_vs_cpu(dev, arch: str = LM_ARCH, check: dict = LM_CHECK, phase: str = "lm",
                         init_device="cpu") -> dict:
    """Phase 9, first part (and the moe and frontends phases', for each of
    their configs): the same weights (drawn on `init_device` from seed 0)
    and prompts (tokens, or an embeddings config's front-end prompts, made
    on the CPU) served on the card and on the CPU at `arch`'s full width and
    `check["layers"]` layers, in `check["dtype"]` when given, held to
    `check`'s limits."""
    c = check
    cfg = dataclasses.replace(get_arch(arch).model, n_layers=c["layers"],
                              **({"dtype": c["dtype"]} if "dtype" in c else {}))
    tree = params_to_numpy(init_params(cfg, seed=0, device=init_device))
    prompts = (torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt_len"]),
                             generator=torch.Generator().manual_seed(5)) if cfg.input_kind == "tokens"
               else frontend_prompts(arch, cfg.d_model, c["batch"], c["prompt_len"], torch.device("cpu"), 5))
    t0 = time.perf_counter()
    card = serve(cfg, batch=c["batch"], prompt_len=c["prompt_len"], gen=c["gen"], device=dev, params=tree,
                 prompts=prompts)
    t1 = time.perf_counter()
    cpu = serve(cfg, batch=c["batch"], prompt_len=c["prompt_len"], gen=c["gen"], device="cpu", params=tree,
                prompts=prompts)
    t2 = time.perf_counter()
    del tree
    lc, lp = card.prefill_logits.float().cpu(), cpu.prefill_logits.float()
    scale = lp.abs().max().item()
    err = (lc - lp).abs().max().item()
    codes = {}
    for name in ("k_codes", "v_codes"):
        a, b = card.cache["layers"][name].cpu(), cpu.cache["layers"][name]
        same = a == b
        alike = slots_fed_alike(card.tokens, cpu.tokens, c["prompt_len"], a.shape[2])
        codes[name] = {"all": same.double().mean().item(), "layer0": same[0].double().mean().item(),
                       "all_fed_alike": same[:, alike].double().mean().item(),
                       "layer0_fed_alike": same[0][alike].double().mean().item()}
    top2 = lp[:, 0].topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    first = [bool(card.tokens[i, 0] == cpu.tokens[i, 0]) or margin[i] < 2 * err for i in range(c["batch"])]
    out = {"phase": phase, "path": "card_vs_cpu", "arch": arch, "dtype": cfg.dtype,
           "config": {**c, "d_model": cfg.d_model},
           "prefill_logits_max_abs_err": err, "max_abs_logit": scale, "code_agreement": codes,
           "tokens_card": card.tokens.tolist(), "tokens_cpu": cpu.tokens.tolist(),
           "token_agreement": float((card.tokens == cpu.tokens).mean()), "top2_margin_cpu": margin,
           "finite": bool(torch.isfinite(lc).all()), "card_s": t1 - t0, "cpu_s": t2 - t1}
    emit(out)
    bad = []
    if not out["finite"] or err > c["logits_frac"] * scale:
        bad.append(f"prefill logits differ by {err} (max |logit| {scale})")
    over = "_fed_alike" if c.get("codes_over_slots_fed_alike") else ""
    for name, r in codes.items():
        if r["layer0" + over] < c["codes_layer0"] or r["all" + over] < c["codes_all"]:
            bad.append(f"{name} agreement {r}")
    if not all(first):
        bad.append(f"first tokens differ where the margin is clear: {margin}")
    if bad:
        raise AssertionError(f"{arch}: card and CPU serving disagree: " + "; ".join(bad))
    return out


def slots_fed_alike(tok_a: np.ndarray, tok_b: np.ndarray, prompt_len: int, w: int) -> torch.Tensor:
    """(B, W) bool: the ring slots that hold the k/v of the same tokens on
    both sides: all but those a decode step wrote after the two sides'
    greedy tokens parted (step j writes position prompt_len + j from
    generated token j, j < gen - 1)."""
    b, gen = tok_a.shape
    same_prefix = np.cumprod(tok_a == tok_b, axis=1).astype(bool)
    alike = torch.ones((b, w), dtype=torch.bool)
    for j in range(gen - 1):
        alike[:, (prompt_len + j) % w] = torch.from_numpy(same_prefix[:, j])
    return alike


def attention_layers(cfg) -> int:
    """The layers of `cfg` that attend, each one B10 launch a prefill: none
    for the ssm family, one a group for the hybrid, every layer else."""
    return {"ssm": 0, "hybrid": cfg.hybrid_pattern()[0]}.get(cfg.family, cfg.n_layers)


def attention_ring(cfg, cache: dict) -> Optional[dict]:
    """The attention layers' rings of a cache (None for the ssm family)."""
    return {"ssm": None, "hybrid": cache.get("groups", {}).get("attn")}.get(cfg.family, cache.get("layers"))


def run_lm(dev, arch: str = LM_ARCH, batch: int = LM_BATCH, prompt_len: int = LM_PROMPT, gen: int = LM_GEN,
           n_layers: Optional[int] = None, phase: str = "lm", path: str = "full"):
    """Phase 9, the main path (and the moe phase's paths 4-6, the recurrent
    phase's serving paths): `arch` at full width and depth (or `n_layers`)
    serving `batch` requests of `prompt_len` tokens and `gen` generated
    each, with the launch counts set to 0 just before and read just after
    (B10's tensor-core kernel once per attention layer, its FMA kernel
    never); then one profiled prefill and decode for the device's busy
    time. Returns (launches, model, prompts on the card)."""
    t_run = time.perf_counter()
    cfg = get_arch(arch).model
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    prompts = (torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                             generator=torch.Generator().manual_seed(0)).to(dev, torch.int32)
               if cfg.input_kind == "tokens" else frontend_prompts(arch, cfg.d_model, batch, prompt_len, dev, 0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    serve(cfg, batch=1, prompt_len=64, gen=2, device=dev, params=model)  # warm the library and handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run = serve(cfg, batch=batch, prompt_len=prompt_len, gen=gen, device=dev, params=model, prompts=prompts)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_attn = attention_layers(cfg)
    if launches["flash_attention_fwd_tc"] != n_attn or launches["flash_attention_fwd"]:
        raise AssertionError(f"{arch}: B10 launched {launches['flash_attention_fwd_tc']} times on the tensor "
                             f"cores and {launches['flash_attention_fwd']} on the FMA kernel in a "
                             f"prefill of {n_attn} attention layers")
    cache_len = prompt_len + gen
    w = None if cfg.family == "ssm" else _round_window(cfg.effective_kv_window(cache_len))
    logits, ring = run.prefill_logits, attention_ring(cfg, run.cache)
    checks = {
        "logits_shape": tuple(logits.shape) == (batch, 1, cfg.padded_vocab),
        "logits_finite": bool(torch.isfinite(logits).all()),
        "tokens_shape": run.tokens.shape == (batch, gen),
        "tokens_in_vocab": bool(((run.tokens >= 0) & (run.tokens < cfg.padded_vocab)).all()),
        "pos": run.cache["pos"] == prompt_len + gen - 1,
    }
    if ring is not None:
        checks["ring_shape"] = tuple(ring["k_codes"].shape) == (n_attn, batch, w, cfg.n_kv_heads, cfg.head_dim)
        checks["scales_positive"] = bool((ring["k_scale"] > 0).all() and (ring["v_scale"] > 0).all())
    if cfg.family in ("ssm", "hybrid"):
        checks["states_finite"] = all(bool(torch.isfinite(t.float()).all()) for t in cache_leaves(run.cache).values())
    line = {
        "phase": phase, "path": path, "arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.param_count(), "batch": batch, "prompt_len": prompt_len, "gen": gen,
        "ring_slots": w, "kv_quant": cfg.kv_quant, "prefill_s": run.prefill_s, "decode_s": run.decode_s,
        "prefill_tok_per_s": batch * prompt_len / run.prefill_s,
        "decode_tok_per_s": run.decode_tok_per_s, "decode_ms_per_step": run.decode_s * 1e3 / (gen - 1),
        "tokens_generated": run.tokens_generated,
        "cache_bytes": run.cache_bytes, "cache_bytes_raw_equiv": run.cache_bytes_raw_equiv,
        "kv_compression": run.cache_bytes_raw_equiv / run.cache_bytes if run.cache_bytes_raw_equiv else None,
        "peak_memory_allocated": peak, "launches": launches,
        "first_tokens": run.tokens[:, :8].tolist(), "checks": checks, "init_s": init_s,
    }
    t0 = time.perf_counter()
    with torch.inference_mode():
        busy_p, top_p, ops_p, _ = device_busy_ms(lambda: prefill(model, cfg, prompts, cache_len), top=8)
        cache, lg = prefill(model, cfg, prompts, cache_len)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
        torch.cuda.synchronize()

        def decode_loop():
            nonlocal cache, tok
            for _ in range(LM_PROFILED_STEPS):
                cache, lg2 = decode_step(model, cfg, cache, decode_input(model, tok))
                tok = torch.argmax(lg2, dim=-1).to(torch.int32)

        busy_d, top_d, ops_d, _ = device_busy_ms(decode_loop, top=8)
        del cache
    profile_s = time.perf_counter() - t0
    # the unprofiled run's wall time for as many decode steps as were profiled
    decode_wall_ms = run.decode_s * 1e3 * LM_PROFILED_STEPS / (gen - 1)
    line.update({
        "device_busy_ms": {"prefill": busy_p, f"decode_{LM_PROFILED_STEPS}_steps": busy_d},
        "busy_share": {"prefill": busy_p / (run.prefill_s * 1e3) if busy_p else None,
                       "decode": busy_d / decode_wall_ms if busy_d else None},
        "top_kernels_ms": {"prefill": top_p, f"decode_{LM_PROFILED_STEPS}_steps": top_d},
        "host_ops": {"prefill": ops_p, "per_decode_step": ops_d / LM_PROFILED_STEPS},
        "profile_s": profile_s, "seconds": time.perf_counter() - t_run,
    })
    emit(line)
    if not all(checks.values()):
        raise AssertionError(f"the {arch} path's outputs fail their checks: {checks}")
    del run
    return launches, model, prompts


def time_flash(dev, model, prompts, cycles_per_ms: float) -> dict:
    """B10 on the full lm path's layer-0 q, k, v (4 x 2048): the
    tensor-core kernel on them in bf16 and the FMA kernel on the same values
    in float32, each with its plain version and torch's
    scaled_dot_product_attention on the same inputs (the library yardstick,
    causal with GQA), timed with CUDA events. The bound is the larger of the
    band's operations at the peak rate for the inputs' type (bf16 tensor
    cores; float32 outside them, B10's float32 contract) and q, k, v read
    once and o written once at the memory rate. Returns per-kernel dicts."""
    cfg = model.cfg
    with torch.inference_mode():
        b, s = prompts.shape
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        attn, x = first_attention(model, cfg, prompts)
        q, k, v = layers.attention_qkv(attn.params(), cfg, x, pos)
    window = cfg.swa_window
    nops = flash_attn.flops(b, s, s, cfg.n_heads, cfg.head_dim, window, True)
    tensor_bound_ms = nops / BF16_TENSOR_OPS_PER_S * 1e3
    out = {}
    for name, dtype, ops_per_s, iters in (("flash_attention_fwd_tc", torch.bfloat16, BF16_TENSOR_OPS_PER_S, 50),
                                          ("flash_attention_fwd", torch.float32, SCALAR_OPS_PER_S, 20)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        qt, kt, vt = (t.transpose(1, 2) for t in (qd, kd, vd))

        def kern():
            return ops.flash_attention_fwd(qd, kd, vd, window=window)

        def plain():
            return ref.flash_reference(qd, kd, vd, window=window)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

        before = ops.launch_counts()[name]
        got, want = kern(), plain()
        if ops.launch_counts()[name] != before + 1:
            raise AssertionError(f"the {dtype} lm-shape call did not run {name}")
        ok, tol = flash_within(got, want)
        err = (got.float() - want.float()).abs().max().item()
        lib_err = (library().transpose(1, 2).float() - want.float()).abs().max().item()
        if not (ok and bool(torch.isfinite(got).all())):
            raise AssertionError(f"{name} disagrees with its plain version on the lm path's inputs: {err}")
        ms, host_ms = time_ms(kern, iters, cycles_per_ms)
        plain_ms, plain_host_ms = time_ms(plain, 5, cycles_per_ms)
        library_ms, _ = time_ms(library, 50, cycles_per_ms)
        nbytes = 2 * qd.numel() * qd.element_size() + 2 * kd.numel() * kd.element_size()
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / ops_per_s * 1e3
        bound_ms, bound_by = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "tensor_bound_ms": tensor_bound_ms, "bytes": nbytes, "ops": nops,
                     "chain_steps": None, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
                     "max_abs_err": err, "library_max_abs_err": lib_err, "tolerance": tol,
                     "dtype": str(dtype), "shape": [b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
                     "tflops": nops / (ms * 1e-3) / 1e12}
        del got, want, qd, kd, vd, qt, kt, vt
    return out


#: the train phase's full-depth run: qwen3-1.7b at full width and all 28
#: layers, 4 x 1,024 tokens a step from the compressed feed, 8 steps from
#: random weights (the reference trainer's defaults otherwise: lr 3e-4,
#: warmup-cosine, full remat, one microbatch), no checkpoints
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 8
#: the card-vs-CPU training check: full width, 2 layers, 2 x 128 tokens, the
#: same numpy weights and tokens, float32 masters, one AdamW step at lr
#: 1e-3 (no clipping: the step follows each gradient's own sign). Per
#: compute dtype: the loss within `loss_rel` of the CPU's; every
#: parameter's gradient within `grad_rel` in relative norm; every
#: parameter's AdamW update (the parameters after the step less before)
#: within `update_rel` in relative norm. An early step's update is about
#: -lr * sign(g), so an element whose gradient is near 0 flips its update
#: when the two devices' sums differ in sign: `update_rel` counts those
#: flips. float32 sums in another order on the card (and B10 against its
#: dense plain version within 2e-4): loss 1e-5, gradients 1e-3, updates
#: 0.1 (measured on the H100: loss equal, 4.8e-6, 1.1e-3). bfloat16
#: rounds each matrix product's output, at other ties on the card: loss
#: 1e-2, gradients 0.1, updates 0.5 (measured 3.1e-5, 0.016, 0.18)
TRAIN_CHECK = dict(
    layers=2, batch=2, seq=128, lr=1e-3,
    float32=dict(loss_rel=1e-5, grad_rel=1e-3, update_rel=0.1),
    bfloat16=dict(loss_rel=1e-2, grad_rel=0.1, update_rel=0.5),
)
#: the fault drill: the reduced qwen3-1.7b config, 12 steps of 4 x 64,
#: checkpoints every 4 steps under build/, an injected fault at step 6
TRAIN_DRILL = dict(steps=12, batch=4, seq=64, checkpoint_every=4, fail_at=(6,))
#: float32 elements of the gradient codec's card-vs-CPU check
GRAD_CODEC_ELEMENTS = 64 << 20
#: batches of the feed's check at the full run's shape
FEED_CHECK_BATCHES = 4


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b|| in float64 (0 when both are 0)."""
    a, b = a.double(), b.double()
    den = b.norm().item()
    num = (a - b).norm().item()
    return num / den if den else num


def train_card_vs_cpu(dev, tree: dict, tokens: np.ndarray, dtype: str) -> dict:
    """One dtype of `check_train_card_vs_cpu`: on the card and on the CPU,
    the loss and every parameter's gradient (`loss_fn` under the config's
    full remat, and autograd), then one AdamW step on those gradients
    (`adamw`'s update, added in place as `make_train_step` adds it; the
    step's own plumbing runs on the card in `run_train`); each device's
    (loss, grads, updates) moved to the CPU."""
    c = TRAIN_CHECK
    cfg = dataclasses.replace(get_arch(LM_ARCH).model, n_layers=c["layers"], dtype=dtype)
    batch = {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}
    opt_init, opt_update = adamw(AdamWConfig(lr=c["lr"], clip_norm=None))
    got = {}
    for d in (dev, torch.device("cpu")):
        model = params_from_numpy(tree, cfg, d, param_dtype="float32")
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        params = dict(model.named_parameters())
        before = {k: p.detach().clone() for k, p in params.items()}
        loss, _ = loss_fn(model, cfg, b)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            updates, _, _ = opt_update(grads, opt_init(params), params)
            apply_updates_(params, updates)
        got[d.type] = (loss.item(), {k: g.float().cpu() for k, g in grads.items()},
                       {k: (p.detach() - before[k]).float().cpu() for k, p in params.items()})
        del model, params, before, grads, updates
    return got


def check_train_card_vs_cpu(dev) -> dict:
    """Phase 10, first part: training at qwen3-1.7b's full width and 2
    layers on the card and on the CPU from the same numpy weights and
    tokens, in float32 and in bf16, held to TRAIN_CHECK."""
    c = TRAIN_CHECK
    cfg = dataclasses.replace(get_arch(LM_ARCH).model, n_layers=c["layers"])
    tree = params_to_numpy(init_params(cfg, seed=0, device="cpu", param_dtype="float32"))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (c["batch"], c["seq"] + 1)).astype(np.int32)
    bad, out = [], {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        got = train_card_vs_cpu(dev, tree, tokens, dtype)
        (lc, gc, uc), (lp, gp, up) = got["cuda"], got["cpu"]
        grad_rel = {k: rel_norm(gc[k], gp[k]) for k in gp}
        update_rel = {k: rel_norm(uc[k], up[k]) for k in up}
        tol = c[dtype]
        r = {"loss_card": lc, "loss_cpu": lp, "loss_rel": abs(lc - lp) / abs(lp),
             "grad_rel_max": max(grad_rel.values()), "grad_rel_worst": max(grad_rel, key=grad_rel.get),
             "update_rel_max": max(update_rel.values()), "update_rel_worst": max(update_rel, key=update_rel.get),
             "params_after_max_abs_err": max((uc[k] - up[k]).abs().max().item() for k in up),
             "finite": all(bool(torch.isfinite(g).all()) for g in gc.values()) and math.isfinite(lc),
             "tolerance": tol, "seconds": time.perf_counter() - t0}
        out[dtype] = r
        emit({"phase": "train", "path": "card_vs_cpu", "dtype": dtype,
              "config": {k: c[k] for k in ("layers", "batch", "seq", "lr")}, **r})
        if not r["finite"]:
            bad.append(f"{dtype}: non-finite loss or gradients on the card")
        if r["loss_rel"] > tol["loss_rel"]:
            bad.append(f"{dtype}: loss {lc} on the card against {lp}")
        if r["grad_rel_max"] > tol["grad_rel"]:
            bad.append(f"{dtype}: gradient of {r['grad_rel_worst']} differs by {r['grad_rel_max']}")
        if r["update_rel_max"] > tol["update_rel"]:
            bad.append(f"{dtype}: update of {r['update_rel_worst']} differs by {r['update_rel_max']}")
    if bad:
        raise AssertionError("card and CPU training disagree: " + "; ".join(bad))
    return out


def check_train_feed(dev) -> dict:
    """Phase 10: the compressed feed at the full run's shape, TRAIN_BATCH x
    TRAIN_SEQ Zipf tokens over qwen3-1.7b's vocabulary. FEED_CHECK_BATCHES
    batches through `next_batch` (B2 over the whole stream as one block,
    then delta_leb128's decode, on the card) equal the source's tokens bit
    for bit, one B2 launch each. Then each of those batches packed again on
    the host and its words and bit lengths uploaded: B2's codes equal its
    plain version's (`ref.unpack_blocks_ref`) on the same words, and the
    feed's decode of them equals the tokens."""
    vocab = get_arch(LM_ARCH).model.vocab_size
    t0 = time.perf_counter()
    source = zipf_token_stream(vocab, TRAIN_BATCH, TRAIN_SEQ, seed=11)
    feed = CompressedFeed(zipf_token_stream(vocab, TRAIN_BATCH, TRAIN_SEQ, seed=11), device=dev).start()
    batches = []
    try:
        for i in range(FEED_CHECK_BATCHES):
            before = ops.launch_counts()["unpack_blocks"]
            b = feed.next_batch()
            got = torch.cat([b["inputs"], b["labels"][:, -1:]], dim=1).cpu().numpy()
            launched = ops.launch_counts()["unpack_blocks"] - before
            batches.append(next(source))
            if launched != 1 or not np.array_equal(got, batches[-1]):
                raise AssertionError(f"feed batch {i} on the card: {launched} B2 launches, tokens equal "
                                     f"{np.array_equal(got, batches[-1])}")
    finally:
        feed.stop()
    words_per_batch = []
    for i, tokens in enumerate(batches):
        payload, shape = feed._pack(tokens)
        words = torch.from_numpy(payload["words"])
        bitlen = torch.from_numpy(payload["bitlen"]).reshape(-1).to(torch.int32)
        tail = torch.from_numpy(payload["tail"].view(np.int32))
        n = bitlen.numel()
        codes = ops.unpack_blocks(words.to(dev)[None], bitlen.to(dev), block=n)
        want = ref.unpack_blocks_ref(words[None], bitlen)
        decoded = feed._decode(words.to(dev), bitlen.to(dev), tail.to(dev), n // feed.lanes)
        if not torch.equal(codes.cpu(), want):
            raise AssertionError(f"B2 disagrees with its plain version on feed batch {i} "
                                 f"({words.numel()} words, one block of {n} symbols)")
        if not np.array_equal(decoded.cpu().numpy().reshape(shape), tokens):
            raise AssertionError(f"the feed's decode of batch {i}'s words differs from its tokens")
        words_per_batch.append(words.numel())
    out = {"phase": "train", "path": "feed", "batches": FEED_CHECK_BATCHES, "shape": [TRAIN_BATCH, TRAIN_SEQ + 1],
           "block_symbols": n, "words": words_per_batch, "b2_codes_equal": True, "tokens_equal": True,
           "ratio": feed.stats.ratio, "seconds": time.perf_counter() - t0}
    emit(out)
    return out


def check_grad_codec(dev) -> dict:
    """Phase 10: the gradient codec (`core/gradient.py`) on GRAD_CODEC_ELEMENTS
    float32 values at qbits 4 and 8: codes, scales and the dequantized
    values equal on the card and on the CPU."""
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 0.02, GRAD_CODEC_ELEMENTS).astype(np.float32))
    xd = x.to(dev)
    out = {}
    for qbits in (4, 8):
        cfg = GradCompressionConfig(qbits=qbits)
        t0 = time.perf_counter()
        codes, scales, n = quantize_tensor(xd, cfg)
        back = dequantize_tensor(codes, scales, n, xd.shape, cfg)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        codes_c, scales_c, _ = quantize_tensor(x, cfg)
        back_c = dequantize_tensor(codes_c, scales_c, n, x.shape, cfg)
        cpu_s = time.perf_counter() - t0
        same = {"codes": torch.equal(codes.cpu(), codes_c), "scales": torch.equal(scales.cpu(), scales_c),
                "dequantized": torch.equal(back.cpu(), back_c)}
        out[qbits] = {**same, "card_s": card_s, "cpu_s": cpu_s, "wire_bytes": codes.numel() + 4 * scales.numel(),
                      "rel_err": rel_norm(back_c, x)}
        if not all(same.values()):
            raise AssertionError(f"the gradient codec at qbits {qbits} differs on the card: {same}")
    emit({"phase": "train", "path": "grad_codec", "elements": GRAD_CODEC_ELEMENTS, "qbits": out})
    return out


def time_train_flash(dev, model, batch: dict, cycles_per_ms: float) -> dict:
    """B10's lse forms on the training path's layer-0 q, k, v (4 x 1,024):
    the tensor-core kernel's in bf16, the path's own, and the FMA kernel's
    on the same values in float32, each timed with CUDA events beside its
    plain version and a torch call that returns out and the log-sum-exp
    (the library yardstick; the port never calls it): the flash
    `_scaled_dot_product_flash_attention` in bf16, the memory-efficient
    `_scaled_dot_product_efficient_attention` in float32 (the flash one
    takes no float32), k/v repeated to 16 heads. In bf16 also the flash
    backward (`layers.flash_backward`, plain torch, `plain_backward_ms`).
    Bound: the band's operations at the peak rate for the inputs' type
    (bf16 tensor cores; float32 outside them) against q, k, v read and out
    and lse written once."""
    cfg = model.cfg
    with torch.no_grad():
        blk = model.layers[0]
        b, s = batch["inputs"].shape
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        x = layers.rms_norm(model.embedding(batch["inputs"]), blk.p("attn_norm"))
        q0, k0, v0 = (t.contiguous() for t in layers.attention_qkv(blk.attn.params(), cfg, x, pos))
    nops = flash_attn.flops(b, s, s, cfg.n_heads, cfg.head_dim, None, True)
    g = cfg.n_heads // cfg.n_kv_heads
    out = {}
    for form, dtype, ops_per_s, iters in (("flash_attention_fwd_lse", torch.bfloat16, BF16_TENSOR_OPS_PER_S, 50),
                                          ("flash_attention_fwd_lse_fma", torch.float32, SCALAR_OPS_PER_S, 10)):
        with torch.no_grad():
            q, k, v = (t.to(dtype) for t in (q0, k0, v0))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
            wrapper = getattr(ops, form)
            before = ops.launch_counts()[form]
            got, lse = wrapper(q, k, v)
            if ops.launch_counts()[form] != before + 1:
                raise AssertionError(f"the {dtype} training-shape call did not run {form}")
            want, want_lse = ref.flash_reference_lse(q, k, v)
            ok, tol = flash_within(got, want)
            err = (got.float() - want.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            if not (ok and lse_err <= LSE_TOL[0] + LSE_TOL[1] * want_lse.abs().max().item()):
                raise AssertionError(f"{form} disagrees on the training path's inputs: {err}, lse {lse_err}")

            if dtype == torch.bfloat16:
                def library():
                    return torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)
            else:
                def library():
                    return torch.ops.aten._scaled_dot_product_efficient_attention(qt, kt, vt, None, True, 0.0, True)

            lib = library()
            lib_lse_err = (lib[1][..., :s].float() - want_lse).abs().max().item()
            ms, host_ms = time_ms(lambda: wrapper(q, k, v), iters, cycles_per_ms)
            plain_ms, plain_host_ms = time_ms(lambda: ref.flash_reference_lse(q, k, v), 5, cycles_per_ms)
            library_ms, _ = time_ms(library, 50, cycles_per_ms)
            extra = {}
            if dtype == torch.bfloat16:
                dout = torch.randn(got.shape, generator=torch.Generator(device=dev).manual_seed(2),
                                   device=dev).to(dtype)
                extra["plain_backward_ms"], _ = time_ms(
                    lambda: layers.flash_backward(q, k, v, got, lse, dout, None, True), 10, cycles_per_ms)
        nbytes = 2 * (q.numel() * q.element_size() + k.numel() * k.element_size()) + lse.numel() * 4
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = nops / ops_per_s * 1e3
        bound_ms, bound_by = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
        out[form] = {
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "ops": nops, "chain_steps": None, "host_ms": host_ms,
            "plain_host_ms": plain_host_ms, "max_abs_err": err, "lse_max_abs_err": lse_err,
            "library_lse_max_abs_err": lib_lse_err, "tolerance": tol, **extra,
            "dtype": str(dtype), "shape": [b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim],
            "tflops": nops / (ms * 1e-3) / 1e12,
        }
        del got, lse, want, want_lse, lib, q, k, v, qt, kt, vt
    return out


def run_train(dev, cycles_per_ms: float):
    """Phase 10, the main path: `launch.train.train` on qwen3-1.7b at full
    width and depth, TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ, with the
    launch counts set to 0 just before and read just after (B10's lse form
    twice per layer and step: the forward and full remat's recompute; B2
    once per step, the feed's decode; no other form of B10). Then, on a
    fresh model, one warm step, one timed step and one profiled step (the
    device's busy share), and B10's lse form timed on that model's layer 0.
    Returns (launches, the lse form's times)."""
    cfg = get_arch(LM_ARCH).model
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    run = train(cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, device=dev, log_every=TRAIN_STEPS)
    train_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention_fwd_lse": 2 * cfg.n_layers * TRAIN_STEPS, "unpack_blocks": TRAIN_STEPS,
            "flash_attention_fwd_tc": 0, "flash_attention_fwd": 0, "flash_attention_fwd_lse_fma": 0}
    wrong = {k: launches[k] for k, n in want.items() if launches[k] != n}
    checks = {
        "steps": run.final_step == TRAIN_STEPS and len(run.losses) == TRAIN_STEPS and run.restarts == 0,
        "losses_finite": all(math.isfinite(x) for x in run.losses),
        "loss_fell": run.losses[-1] < run.losses[0],
        "launches": not wrong,
    }
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = sorted(run.step_s[1:])[len(run.step_s[1:]) // 2]
    emit({
        "phase": "train", "path": "full", "arch": LM_ARCH, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": cfg.param_count(), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "remat": cfg.remat, "dtype": cfg.dtype, "param_dtype": cfg.param_dtype, "losses": run.losses,
        "step_s": run.step_s, "wall_s": run.wall_s, "tokens_per_s": run.tokens_per_s,
        "steady_step_s": steady, "steady_tokens_per_s": tokens / steady, "feed_ratio": run.feed_ratio,
        "peak_memory_allocated": peak, "launches": launches, "launches_expected": want,
        "checks": checks, "train_call_s": train_s,
    })
    if not all(checks.values()):
        raise AssertionError(f"the train path fails its checks: {checks}; launches off: {wrong}")
    t0 = time.perf_counter()
    init_fn, train_step = make_train_step(cfg, AdamWConfig(lr=3e-4), device=dev)
    model, opt_state = init_fn(1)
    feed = CompressedFeed(zipf_token_stream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=1), device=dev).start()
    try:
        model, opt_state, _ = train_step(model, opt_state, feed.next_batch())
        b = feed.next_batch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model, opt_state, _ = train_step(model, opt_state, b)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3
        b = feed.next_batch()
        busy, top, host_ops, top_ops = device_busy_ms(lambda: train_step(model, opt_state, b), top=12)
        times = time_train_flash(dev, model, b, cycles_per_ms)
    finally:
        feed.stop()
    del model, opt_state
    emit({"phase": "train", "path": "profiled_step", "timed_step_ms": step_ms, "device_busy_ms": busy,
          "busy_share": busy / step_ms if busy else None, "top_kernels_ms": top, "top_ops_ms": top_ops,
          "host_ops_per_step": host_ops, "seconds": time.perf_counter() - t0})
    return launches, times


def run_train_drill(dev) -> dict:
    """Phase 10: the fault drill (a reduced qwen3-1.7b config on the card,
    TRAIN_DRILL: an injected fault restarts from the step-4 checkpoint and
    the run ends at step 12), then a checkpoint of a card model's training
    state after one step loaded on the CPU (`like=`): every leaf equal, and
    the state restored into a CPU model equal to the card's."""
    d = TRAIN_DRILL
    cfg = get_arch(LM_ARCH).model.reduced()
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    run = train(cfg, steps=d["steps"], batch=d["batch"], seq=d["seq"], checkpoint_dir=str(root / "drill"),
                checkpoint_every=d["checkpoint_every"], fail_at=d["fail_at"], device=dev, log_every=100)
    drill_s = time.perf_counter() - t0
    init_fn, train_step = make_train_step(cfg, AdamWConfig(), device=dev)
    model, opt_state = init_fn(0)
    feed = CompressedFeed(zipf_token_stream(cfg.vocab_size, d["batch"], d["seq"], seed=2), device=dev).start()
    try:
        model, opt_state, _ = train_step(model, opt_state, feed.next_batch())
    finally:
        feed.stop()
    tree = state_tree(model, opt_state)
    save_checkpoint(str(root / "card"), 1, tree)
    got = load_checkpoint(str(root / "card"), 1, device="cpu", like=state_like(model))
    leaves_equal = all(torch.equal(a, b) for a, b in zip(tree_flatten(got), tree_flatten(tree)))
    cpu_model, _ = make_train_step(cfg, AdamWConfig(), device="cpu")[0](7)
    cpu_state = restore_state(cpu_model, load_checkpoint(str(root / "card"), 1, like=state_like(cpu_model)))
    restored = (all(torch.equal(p.cpu(), q) for p, q in zip(model.parameters(), cpu_model.parameters()))
                and int(cpu_state.step) == int(opt_state.step) == 1)
    checks = {"restarts": run.restarts == 1, "final_step": run.final_step == d["steps"],
              "losses_finite": all(math.isfinite(x) for x in run.losses),
              "card_checkpoint_on_cpu": leaves_equal, "restored_on_cpu": restored}
    out = {"phase": "train", "path": "fault_drill", "config": {**d, "d_model": cfg.d_model, "n_layers": cfg.n_layers},
           "restarts": run.restarts, "final_step": run.final_step, "losses": run.losses,
           "checks": checks, "drill_s": drill_s, "seconds": time.perf_counter() - t0}
    emit(out)
    shutil.rmtree(root, ignore_errors=True)
    if not all(checks.values()):
        raise AssertionError(f"the fault drill fails its checks: {checks}")
    return out


#: the utility ops `prof.events()` leaves out of a trace, which
#: `device_busy_ms` leaves out too
PROFILER_UTILITY_OPS = ("[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
                        "profiler::_record_function_enter_new", "profiler::_record_function_exit",
                        "aten::is_leaf", "aten::output_nr", "aten::_version")


def device_busy_ms(fn, top: int = 0):
    """Device time of every kernel, copy and set `fn` runs, summed over the
    profiler trace's device-side events (None if it holds none). With
    `top`, returns (ms, the `top` kernel names with the most device time and
    their ms, the count of torch ops the host called at top level: aten ops
    inside no other synchronous host event of their thread, the parents
    `prof.events()` gives, and the `top` torch ops with the most device time
    and their ms: each device event charged, through its launch's
    correlation id, to the op that launched it, named by `op_label`).

    The trace is read from the profiler's raw events: `prof.events()` builds
    a Python object and the parent tree for each of them, ~0.28 ms a host op
    on an 8-core host, twice the capture's own cost, which made the served
    paths' profiles a tenth of the script's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    device_events: list = []  # (ms, the launching host event's correlation id)
    spans: dict = {}  # thread -> [(start, -end, name, correlation id or None)] of its synchronous host events
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in PROFILER_UTILITY_OPS or getattr(e, "is_hidden_event", lambda: False)():
            continue
        if e.device_type() == DeviceType.CUDA:
            ms = (e.end_ns() - e.start_ns()) / 1e6
            by_name[name] = by_name.get(name, 0.0) + ms
            device_events.append((ms, e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU and not e.is_async() and e.start_thread_id() == e.end_thread_id():
            # a host op's own correlation id; a runtime call (its launch) links to its op's instead
            corr = e.correlation_id() if e.linked_correlation_id() == 0 else None
            spans.setdefault(e.start_thread_id(), []).append((e.start_ns(), -e.end_ns(), name, corr))
    host_ops = 0
    launched = {corr for _, corr in device_events}
    labels: dict = {}  # correlation id -> op_label of the host event and its enclosing ones
    for evs in spans.values():
        stack = []  # (end, name) of the events enclosing the current one, innermost last
        for start, neg_end, name, corr in sorted(evs, key=lambda ev: ev[:3]):
            while stack and (start >= stack[-1][0] or -neg_end > stack[-1][0]):
                stack.pop()
            host_ops += not stack and name.startswith("aten::")
            stack.append((-neg_end, name))
            if top and corr in launched:
                labels[corr] = op_label([n for _, n in stack])
    total = sum(by_name.values())
    ms = total if total > 0 else None
    if not top:
        return ms
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    per_op: dict = {}
    for t, corr in device_events:
        label = labels.get(corr, "(no host op)")
        per_op[label] = per_op.get(label, 0.0) + t
    return ms, kernels, host_ops, sorted(per_op.items(), key=lambda kv: -kv[1])[:top]


def op_label(names: list) -> str:
    """The torch op a device event is charged to, from the names of its
    launching host event and those enclosing it (outermost first): the
    outermost aten op below the innermost autograd node (a backward node,
    or the recompute a node's saved tensors ran), else the innermost
    name."""
    node = max((i for i, n in enumerate(names) if n.startswith("autograd::engine::evaluate_function")),
               default=-1)
    return next((n for n in names[node + 1:] if n.startswith("aten::")), names[-1])


def run_full(dev, name: str, values: np.ndarray):
    """Phase 4: one main path on a 64 MiB stream, compress + decode, timed
    step by step on the host clock, with the launch counts set to 0 just
    before and read just after; then one profiled pass of each direction
    for the device's busy time. Returns (launches, frame)."""
    t_run = time.perf_counter()
    spec, needed, dataset = FULL_SPECS[name]
    if dataset == "ecg":
        spec = spec.calibrated(values[:CALIBRATION_TUPLES])
    pipe = CompressionPipeline(spec, device=dev)
    decomp = DecompressionPipeline(spec, device=dev)
    warm = pipe.compress_to_frame(values[: 8 * pipe.block_tuples]).to_bytes()  # warm the allocator
    decomp.ingest(warm)
    torch.cuda.synchronize()
    ops.reset_launches()
    t = {}
    t0 = time.perf_counter()
    shaped = pipe.shape_blocks(values)
    t["shape_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = pipe.execute(shaped, collect_payload=True)
    t["execute_s"] = time.perf_counter() - t0
    t["execute_loop_s"] = res.wall_s  # chunk loop + egress fetches + metadata splice
    t0 = time.perf_counter()
    frame = pipe.frame_from(shaped, res)  # with entropy: the rANS blob (B8)
    t["frame_from_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wire = frame.to_bytes()
    t["to_bytes_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = bits.parse_frame(wire, dev)  # with entropy: the blob decode (B9)
    t["parse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dec = decomp.decompress(parsed)
    t["decompress_s"] = time.perf_counter() - t0
    t["decompress_device_loop_s"] = dec.wall_s  # unpack + decode chunks, synced
    launches = ops.launch_counts()
    if pipe.codec.meta.lossy:
        head = 16 * pipe.block_tuples
        cpu = CompressionPipeline(spec, device="cpu").compress_to_frame(values[:head]).to_bytes()
        if not np.array_equal(dec.values[:head], DecompressionPipeline(spec, device="cpu").ingest(cpu).values):
            raise AssertionError(f"64 MiB {name}: the card's decode of the first 16 blocks "
                                 "differs from the CPU path's")
    elif not np.array_equal(dec.values, values):
        raise AssertionError(f"64 MiB {name} roundtrip is not exact")
    max_err = int(np.abs(dec.values.astype(np.int64) - values.astype(np.int64)).max())
    bound = pipe.codec.error_bound()
    if bound is not None and max_err > bound:
        raise AssertionError(f"64 MiB {name}: max-abs error {max_err} exceeds the bound {bound}")
    missing = [k for k in needed if launches[k] == 0]
    if missing:
        raise AssertionError(f"the {name} main path did not launch: {missing}")
    n_chunks = len(pipe._chunks(len(shaped.blocks)))
    if name == "tdic32":  # a tail block, if any, encodes on B5's probe and decodes as a chunk of one
        tails = int(shaped.tail is not None)
        want = {"dict_chunk_encode": n_chunks, "dict_chunk_decode": n_chunks + tails, "dict_probe": tails}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"the tdic32 path's {n_chunks} chunks launched "
                                 f"{ {k: launches[k] for k in want} }, expected {want}")
    # every chunk packs with B4 in B1's launch; B1 alone only for a tail block and a flush block
    want = {**{k: n_chunks for k in CHUNK_KERNELS}, "pack_meta7_blocks": 0,
            "pack_blocks": int(shaped.tail is not None) + int(pipe._has_flush)}
    if name == "heavy":  # the entropy stage: one section-form encode and decode per section
        want.update(rans_section_encode=2, rans_encode=0, rans_section_decode=2, rans_decode=0)
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"the {name} path's {n_chunks} chunks launched "
                             f"{ {k: launches[k] for k in want} }, expected {want}")
    if name == "adpcm" and {k: launches[k] for k in LANE_KERNELS} != {
            "adpcm_lane_encode": n_chunks, "adpcm_lane_encode_serial": 0,
            "adpcm_lane_decode": n_chunks, "adpcm_lane_decode_serial": 0}:
        raise AssertionError(f"the adpcm path's {n_chunks} chunks launched the codec form's kernels "
                             f"{ {k: launches[k] for k in LANE_KERNELS} } times, expected the "
                             "speculative encode and the scan decode once per chunk")
    comp_s = t["shape_s"] + t["execute_s"] + t["frame_from_s"] + t["to_bytes_s"]
    dec_s = t["parse_s"] + t["decompress_s"]
    t0 = time.perf_counter()
    busy_c = device_busy_ms(lambda: pipe.frame_from(shaped, pipe.execute(shaped, collect_payload=True)))
    busy_d = device_busy_ms(lambda: decomp.ingest(wire))
    t["profile_s"] = time.perf_counter() - t0  # the two profiled passes
    emit({
        "phase": "full", "path": name, "spec": spec.to_dict(), "input_bytes": int(values.nbytes),
        "blocks": int(len(shaped.blocks)), "chunks": n_chunks,
        "wire_bytes": len(wire), "ratio": values.nbytes / len(wire),
        "compress_s": comp_s, "compress_MBps": values.nbytes / 1e6 / comp_s,
        "decompress_s": dec_s, "decompress_MBps": values.nbytes / 1e6 / dec_s,
        "d2h_bytes": res.compacted.d2h_bytes,
        "steps": t, "device_busy_ms": {"compress": busy_c, "decompress": busy_d},
        "exact": max_err == 0, "max_abs_err": max_err, "error_bound": bound,
        "launches": launches, "seconds": time.perf_counter() - t_run,
    })
    return launches, frame


#: the api phase: the 64 MiB Rovio stream as eight 8 MiB segments (each
#: 1,024 blocks of JobSpec()'s 2,048 tuples, 8 chunks, no tail), the
#: dictionaries' training sample, the scripted tier schedule (every rung at
#: least twice), and the segments held against the CPU path
API_SEGMENTS = 8
API_TRAIN = 262_144
API_SCHEDULE = ("bypass", "cheap", "heavy", "cheap", "heavy", "bypass", "heavy", "cheap")
API_CPU_SEGMENTS = 2
#: the contract kernels the api phase must never launch
API_NEVER = ("dict_probe", "pack_blocks", "pack_meta7_blocks", "rans_encode", "rans_decode")


def api_drive(handle, segments, swap=None) -> list:
    """Push and flush each segment (the host wall of each, synced); `swap`
    is (index, fn): before segment `index`, `handle.swap_dictionary(fn())`."""
    walls = []
    for i, seg in enumerate(segments):
        if swap is not None and i == swap[0]:
            handle.swap_dictionary(swap[1]())
        t0 = time.perf_counter()
        handle.push(seg)
        handle.flush()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def api_collect(frames, segments, dev, params=None) -> None:
    """The collector window: every frame's wire bytes ingested on the card
    by a pipeline of the frame's own codec (default parameters, or
    `params`), which must return the segment exactly."""
    pipes = {}
    for frame, seg in zip(frames, segments):
        name = WIRE_CODEC_NAMES[frame.codec_id]
        if name not in pipes:
            pipes[name] = DecompressionPipeline(JobSpec(codec=name, params=params or {}), device=dev)
        if not np.array_equal(pipes[name].ingest(frame.to_bytes()).values, seg):
            raise AssertionError(f"api: a {name} frame's wire roundtrip on the card is not exact")


def counted_window(fn) -> tuple:
    """(launch counts, host wall, result) of `fn`: the counts set to 0
    just before it and read just after, the wall synchronized."""
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return ops.launch_counts(), time.perf_counter() - t0, out


def api_window(fn) -> dict:
    """Launch counts of one window: set to 0 just before `fn`, read after."""
    return counted_window(fn)[0]


def api_check_launches(job: str, window: str, got: dict, want: dict) -> None:
    want = {**{k: 0 for k in API_NEVER}, **want}
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"api/{job}, {window} window launched {({k: got[k] for k in want})}, "
                             f"expected {want}")


def api_roundtrips_exact(handle, segments, job: str) -> None:
    rep = handle.report()
    if rep.n_frames != len(segments) or not all(
            np.array_equal(rt.values, seg) for rt, seg in zip(rep.roundtrips, segments)):
        raise AssertionError(f"api/{job}: a segment's roundtrip is not exact")


def api_cpu_frames_equal(cpu_handle, segments, frames, job: str) -> None:
    """The same job on the CPU over the first API_CPU_SEGMENTS segments:
    byte-identical frames."""
    api_drive(cpu_handle, segments[:API_CPU_SEGMENTS])
    if [f.to_bytes() for f in cpu_handle.frames()] != [f.to_bytes() for f in frames[:API_CPU_SEGMENTS]]:
        raise AssertionError(f"api/{job}: the card's frames differ from the CPU path's")


def api_busy_share(spec, segment, walls, dev, controller=None) -> dict:
    """Device time of one more segment on a fresh handle, profiled, beside
    the unprofiled segments' median host wall."""
    handle = cstream.open(spec, controller=controller, device=dev)
    busy = device_busy_ms(lambda: api_drive(handle, [segment]))
    wall_ms = float(np.median(walls)) * 1e3
    return {"busy_ms": busy, "median_segment_ms": wall_ms,
            "share": None if busy is None else busy / wall_ms}


def api_line(job: str, segments, report, walls, **extra) -> dict:
    nbytes = sum(int(s.nbytes) for s in segments)
    return {"phase": "api", "job": job, "segments": len(segments),
            "tuples": sum(int(s.size) for s in segments), "input_bytes": nbytes,
            "wire_bytes": report.wire_bytes, "ratio": nbytes / report.wire_bytes,
            "segment_s": walls, "MBps": nbytes / 1e6 / sum(walls), **extra}


def run_api_dict(dev, values: np.ndarray) -> dict:
    """api/tdic32-dict: a collector's per-topic dictionary, hot-swapped
    after the fourth flush. Returns the launches of both windows."""
    t_job = time.perf_counter()
    segments = np.split(values, API_SEGMENTS)
    with tempfile.TemporaryDirectory() as root:
        prev = dictstore.set_default_registry(dictstore.DictRegistry(root=root))
        try:
            reg = dictstore.default_registry()
            v1 = reg.publish(dictstore.train_dict(values[:API_TRAIN], idx_bits=12, topic="rovio"))
            spec = cstream.JobSpec(codec="tdic32", egress=True, dictionary="rovio:latest")
            handle = cstream.open(spec, device=dev)
            cpu_handle = cstream.open(spec, device="cpu")  # negotiated on v1 too
            v2 = {}

            def publish_v2():
                v2["art"] = reg.publish(dictstore.train_dict(
                    values[API_TRAIN: 2 * API_TRAIN], idx_bits=12, topic="rovio"))
                return v2["art"]

            walls = []
            handle_counts = api_window(
                lambda: walls.extend(api_drive(handle, segments, swap=(4, publish_v2))))
            frames = handle.frames()
            collector_counts = api_window(lambda: api_collect(frames, segments, dev))
            ids = [f.dict_id for f in frames]
            if ids != [("rovio", 1)] * 4 + [("rovio", 2)] * 4:
                raise AssertionError(f"api/tdic32-dict: frames carry dict ids {ids}")
            api_roundtrips_exact(handle, segments, "tdic32-dict")
            chunks = API_SEGMENTS * 8
            codec_chunks = {"pack_blocks_meta7": chunks, "compact_blocks": chunks, "unpack_blocks": chunks}
            api_check_launches("tdic32-dict", "handle", handle_counts, {
                **codec_chunks, "dict_chunk_encode": chunks, "dict_chunk_decode": chunks})
            api_check_launches("tdic32-dict", "collector", collector_counts, {
                "pack_blocks_meta7": 0, "compact_blocks": 0, "unpack_blocks": chunks,
                "dict_chunk_encode": 0, "dict_chunk_decode": chunks})
            api_cpu_frames_equal(cpu_handle, segments, frames, "tdic32-dict")
            cold = cstream.open(cstream.JobSpec(codec="tdic32", egress=True), device=dev)
            cold_walls = api_drive(cold, segments)
            cold_rep = cold.close()
            busy = api_busy_share(spec, segments[0], walls, dev)
            rep = handle.close()
        finally:
            dictstore.set_default_registry(prev)
    emit(api_line(
        "tdic32-dict", segments, rep, walls, spec=spec.to_dict(),
        dict_ids=[list(i) for i in ids],
        dictionaries={f"v{a.version}": {"entries": a.n_entries, "hash": a.content_hash}
                      for a in (v1, v2["art"])},
        cold={"wire_bytes": cold_rep.wire_bytes, "ratio": values.nbytes / cold_rep.wire_bytes,
              "segment_s": cold_walls},
        device_busy=busy, frames_equal_cpu=True, cpu_segments=API_CPU_SEGMENTS,
        launches={"handle": {k: n for k, n in handle_counts.items() if n},
                  "collector": {k: n for k, n in collector_counts.items() if n}},
        seconds=time.perf_counter() - t_job,
    ))
    return {k: handle_counts[k] + collector_counts[k] for k in handle_counts}


def run_api_adaptive(dev, values: np.ndarray) -> dict:
    """api/adaptive: the tier ladder under API_SCHEDULE, then under the
    default controller. Returns the scripted job's launches."""
    t_job = time.perf_counter()
    segments = np.split(values, API_SEGMENTS)
    spec = cstream.JobSpec(codec="tcomp32", egress=True, adaptive=True)
    plan = cstream.negotiate(spec, device=dev)
    ladder = tuple(t for t, _ in plan.tiers)
    rung = {t.name: t for t in ladder}
    handle = cstream.open(spec, controller=cstream.ScriptedController(ladder, API_SCHEDULE), device=dev)
    walls = []
    handle_counts = api_window(lambda: walls.extend(api_drive(handle, segments)))
    frames = handle.frames()
    collector_counts = api_window(lambda: api_collect(frames, segments, dev))
    if handle.tier_log != list(API_SCHEDULE):
        raise AssertionError(f"api/adaptive ran rungs {handle.tier_log}, scripted {API_SCHEDULE}")
    for frame, name in zip(frames, handle.tier_log):
        if (WIRE_CODEC_NAMES[frame.codec_id], frame.entropy is not None) != (
                rung[name].codec, rung[name].entropy == "rans"):
            raise AssertionError(f"api/adaptive: a {name} segment's frame is "
                                 f"{WIRE_CODEC_NAMES[frame.codec_id]}, entropy {frame.entropy is not None}")
    api_roundtrips_exact(handle, segments, "adaptive")
    heavy = 2 * API_SCHEDULE.count("heavy")
    chunks = API_SEGMENTS * 8
    api_check_launches("adaptive", "handle", handle_counts, {
        "pack_blocks_meta7": chunks, "compact_blocks": chunks, "unpack_blocks": chunks,
        "rans_section_encode": heavy, "rans_section_decode": 0})
    api_check_launches("adaptive", "collector", collector_counts, {
        "pack_blocks_meta7": 0, "unpack_blocks": chunks,
        "rans_section_encode": 0, "rans_section_decode": heavy})
    cpu = cstream.open(spec, controller=cstream.ScriptedController(ladder, API_SCHEDULE), device="cpu")
    api_cpu_frames_equal(cpu, segments, frames, "adaptive")
    if cpu.tier_log != handle.tier_log[:API_CPU_SEGMENTS]:
        raise AssertionError("api/adaptive: the CPU run's tier log differs from the card's")
    auto = cstream.open(spec, device=dev)
    auto_walls = api_drive(auto, segments)
    auto_rep = auto.report()
    api_roundtrips_exact(auto, segments, "adaptive/default")
    auto_cpu = cstream.open(spec, device="cpu")
    api_cpu_frames_equal(auto_cpu, segments, auto.frames(), "adaptive/default")
    if auto_cpu.tier_log != auto.tier_log[:API_CPU_SEGMENTS]:
        raise AssertionError("api/adaptive/default: the CPU run's tier log differs from the card's")
    busy = api_busy_share(spec, segments[API_SCHEDULE.index("heavy")], walls, dev,
                          controller=cstream.ScriptedController(ladder, ["heavy"]))
    emit(api_line(
        "adaptive", segments, handle.report(), walls, spec=spec.to_dict(),
        tier_log=handle.tier_log, rung_codecs={t.name: [t.codec, t.entropy] for t in ladder},
        default_controller={"tier_log": auto.tier_log, "wire_bytes": auto_rep.wire_bytes,
                            "ratio": values.nbytes / auto_rep.wire_bytes, "segment_s": auto_walls},
        device_busy_heavy_segment=busy, frames_equal_cpu=True, cpu_segments=API_CPU_SEGMENTS,
        launches={"handle": {k: n for k, n in handle_counts.items() if n},
                  "collector": {k: n for k, n in collector_counts.items() if n}},
        seconds=time.perf_counter() - t_job,
    ))
    return {k: handle_counts[k] + collector_counts[k] for k in handle_counts}


#: the gang phase, offline: each 64 MiB stream split into 16 contiguous 4 MiB
#: members of 1,048,576 values (512 blocks of JobSpec()'s geometry, four
#: 128-block chunks, so a gang chunk is (128, 64 lanes, 512)); members 0-1
#: are held against the CPU path. name -> (JobSpec, dataset, the codec's
#: chunk kernel or None)
GANG_MEMBERS = 16
GANG_CPU_MEMBERS = 2
GANG_JOBS = {
    "tcomp32": (JobSpec(codec="tcomp32"), "rovio", None),
    "tdic32": (JobSpec(codec="tdic32"), "rovio", "dict_chunk_encode"),
    "adpcm": (JobSpec(codec="adpcm"), "ecg", "adpcm_lane_encode"),
}
#: the gang phase, serving: 16 topics (8 tcomp32, 8 tdic32, egress on),
#: each fed its own contiguous 4 MiB of the 64 MiB Rovio stream (512 flushes
#: of a 2,048-tuple micro-batch) at the paper's 16 MB/s per topic under
#: zipf 0.7 bursts; two topics replayed on the CPU
SERVE_TOPICS = 16
SERVE_TUPLES = 1_048_576
SERVE_CPU_TOPICS = ("t00", "t08")


def run_gang_offline(dev, name: str, values: np.ndarray) -> dict:
    """`cstream.gang_compress` over the 16 members against 16 solo
    `run_compress` runs on the card: byte-identical frames, one launch of
    each chunk kernel per gang chunk for all members. Returns the gang
    run's launches."""
    t_job = time.perf_counter()
    spec, dataset, codec_kernel = GANG_JOBS[name]
    if dataset == "ecg":
        spec = spec.calibrated(values[:CALIBRATION_TUPLES])
    members = np.split(values, GANG_MEMBERS)
    plan = cstream.negotiate(spec, device=dev)
    pipe = CompressionPipeline(plan.spec, codec=plan.codec, plan=plan.execution, device=dev)
    # one profiled gang run first: the device time, and the allocator warm
    # at the gang's shapes before the timed runs
    busy = device_busy_ms(lambda: cstream.gang_compress(spec, members, emit_frames=True, device=dev))
    gang_counts, gang_wall, res = counted_window(
        lambda: cstream.gang_compress(spec, members, emit_frames=True, device=dev))
    solo_walls = []

    def solo():
        out = []
        for m in members:
            t0 = time.perf_counter()
            out.append(cstream.run_compress(pipe, plan.spec, m, emit_frame=True))
            torch.cuda.synchronize()
            solo_walls.append(time.perf_counter() - t0)
        return out

    solo_counts, solo_wall, solos = counted_window(solo)
    gang_bytes = [r.frame.to_bytes() for r in res.results]
    if gang_bytes != [r.frame.to_bytes() for r in solos]:
        raise AssertionError(f"gang/{name}: a member's gang frame differs from its solo frame")
    cpu = cstream.gang_compress(spec, members[:GANG_CPU_MEMBERS], emit_frames=True, device="cpu")
    if [r.frame.to_bytes() for r in cpu.results] != gang_bytes[:GANG_CPU_MEMBERS]:
        raise AssertionError(f"gang/{name}: the card's frames differ from the CPU path's")
    n_chunks = len(pipe._chunks(len(pipe.shape_blocks(members[0]).blocks)))
    kernels = ("pack_blocks_meta7", "compact_blocks") + ((codec_kernel,) if codec_kernel else ())
    never = ("pack_blocks", "pack_meta7_blocks", "dict_probe", "adpcm_lane_encode_serial")
    for window, counts, per in (("gang", gang_counts, 1), ("solo", solo_counts, GANG_MEMBERS)):
        want = {**{k: n_chunks * per for k in kernels}, **{k: 0 for k in never}}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"gang/{name}, {window} runs launched "
                                 f"{ {k: counts[k] for k in want} }, expected {want}")
    emit({
        "phase": "gang", "job": f"gang/{name}", "spec": spec.to_dict(), "members": GANG_MEMBERS,
        "member_tuples": int(members[0].size), "chunks": n_chunks,
        "gang_chunk": [pipe.plan.scan_chunk, GANG_MEMBERS * spec.lanes, pipe.block_tuples // spec.lanes],
        "wire_bytes": sum(len(b) for b in gang_bytes),
        "gang_wall_s": gang_wall, "gang_loop_s": res.wall_s, "solo_walls_s": solo_walls,
        "solo_sum_s": sum(solo_walls), "speedup": sum(solo_walls) / gang_wall,
        "gang_MBps": values.nbytes / 1e6 / gang_wall,
        "device_busy": {"busy_ms": busy, "share": None if busy is None else busy / (gang_wall * 1e3)},
        "frames_equal_solo": True, "frames_equal_cpu": True, "cpu_members": GANG_CPU_MEMBERS,
        "launches": {"gang": {k: n for k, n in gang_counts.items() if n},
                     "solo": {k: n for k, n in solo_counts.items() if n}},
        "seconds": time.perf_counter() - t_job,
    })
    return gang_counts


def serve_spec(topic: str) -> JobSpec:
    return JobSpec(codec="tcomp32" if int(topic[1:]) < SERVE_TOPICS // 2 else "tdic32", egress=True)


def serve_feeds(values: np.ndarray, n: int) -> dict:
    """topic -> (its contiguous piece of the stream, zipf 0.7 arrivals at
    the paper's 16 MB/s, seeded by the topic's index)."""
    from repro_torch.data.stream import rate_for_dataset, zipf_timestamps

    rate = rate_for_dataset(1)
    return {f"t{i:02d}": (values[i * n: (i + 1) * n], zipf_timestamps(n, rate, zipf_factor=0.7, seed=i))
            for i in range(SERVE_TOPICS)}


def serve_replay(dev, feeds: dict, gang: bool, topics=None) -> tuple:
    """Open one session per topic on a Dispatcher and replay the feeds:
    (dispatcher, report, host wall of the replay, launches)."""
    d = cstream.Dispatcher(gang=gang, device=dev)
    for t in topics or sorted(feeds):
        d.open(serve_spec(t), topic=t).push(*feeds[t])
    counts, wall, rep = counted_window(d.run)
    return d, rep, wall, counts


def serve_keys_frames(d) -> tuple:
    return ({t: [f.key() for f in s.flushes] for t, s in d.sessions.items()},
            {t: s.egress_frame().to_bytes() for t, s in d.sessions.items()})


def profiled_wave(dev, codec: str, values: np.ndarray, n: int) -> dict:
    """One gang wave of n members on a fresh pipeline: its wall (synced)
    and the device time the profiler sees in it."""
    pipe = CompressionPipeline(JobSpec(codec=codec, egress=True), device=dev)
    lanes, per_lane = pipe.config.lanes, pipe.block_tuples // pipe.config.lanes
    blocks = bits.u32_tensor(values[: n * pipe.block_tuples].reshape(n, lanes, per_lane), dev)
    masks = torch.ones(blocks.shape, dtype=torch.bool, device=dev)
    states = pipe.stack_states([pipe.init_state() for _ in range(n)])
    pipe.gang_step(states, blocks, masks, meta7=True)  # warm
    walls = []
    busy = device_busy_ms(lambda: walls.append(pipe.gang_step(states, blocks, masks, meta7=True)[-1]))
    return {"members": n, "wall_ms": walls[0] * 1e3, "busy_ms": busy,
            "share": None if busy is None else busy / (walls[0] * 1e3)}


def run_gang_serve(dev, values: np.ndarray) -> tuple:
    """The serving runtime on the card: 16 topics through Dispatcher(gang=
    True) against Dispatcher(gang=False), equal records and frames; two
    topics alone on the CPU; one B1+B4 launch per wave or solo flush, one
    dict_probe per tdic32 one. Returns the gang replay's launches and its
    (keys, frames, report)."""
    t_job = time.perf_counter()
    feeds = serve_feeds(values, SERVE_TUPLES)
    g, g_rep, g_wall, g_counts = serve_replay(dev, feeds, gang=True)
    s, s_rep, s_wall, s_counts = serve_replay(dev, feeds, gang=False)
    g_keys, g_frames = serve_keys_frames(g)
    s_keys, s_frames = serve_keys_frames(s)
    if g_keys != s_keys or g_frames != s_frames:
        bad = sorted(t for t in g_keys if g_keys[t] != s_keys[t] or g_frames[t] != s_frames[t])
        raise AssertionError(f"serve: gang and solo servers differ on topics {bad}")
    c, _, _, _ = serve_replay(torch.device("cpu"), feeds, gang=True, topics=SERVE_CPU_TOPICS)
    c_keys, c_frames = serve_keys_frames(c)
    if any(c_keys[t] != g_keys[t] or c_frames[t] != g_frames[t] for t in SERVE_CPU_TOPICS):
        raise AssertionError(f"serve: topics {SERVE_CPU_TOPICS} on the CPU differ from the card's")
    for t, r in g_rep.sessions.items():
        full = sum(not f.timeout for f in g.sessions[t].flushes)
        if not (r.fidelity.bit_exact and r.n_tuples == SERVE_TUPLES and full >= 8):
            raise AssertionError(f"serve/{t}: exact {r.fidelity.bit_exact}, {r.n_tuples} tuples, "
                                 f"{full} full flushes")
    stats = {k: v for k, v in g_rep.dispatch_stats.items()}
    dispatches = sum(v.n_waves + v.n_solo for v in stats.values())
    tdic = sum(v.n_waves + v.n_solo for v in stats.values() if v.codec == "tdic32")
    want = {"pack_blocks_meta7": dispatches, "dict_probe": tdic, "pack_blocks": 0, "pack_meta7_blocks": 0}
    if {k: g_counts[k] for k in want} != want:
        raise AssertionError(f"serve: the gang replay launched { {k: g_counts[k] for k in want} }, "
                             f"expected {want} (one B1+B4 per wave or solo flush)")
    solo_flushes = sum(r.n_flushes for r in s_rep.sessions.values())
    if s_counts["pack_blocks_meta7"] != solo_flushes:
        raise AssertionError(f"serve: the solo replay launched {s_counts['pack_blocks_meta7']} B1+B4 "
                             f"for {solo_flushes} flushes")
    decode_s = {n: sum(r.decode_s for r in rep.sessions.values()) for n, rep in (("gang", g_rep), ("solo", s_rep))}
    emit({
        "phase": "gang", "job": "serve/16-topics", "topics": SERVE_TOPICS, "tuples_per_topic": SERVE_TUPLES,
        "input_bytes": SERVE_TOPICS * SERVE_TUPLES * 4,
        "flushes": sum(r.n_flushes for r in g_rep.sessions.values()),
        "timeout_flushes": sum(r.n_timeout_flushes for r in g_rep.sessions.values()),
        "signatures": {k: {"sessions": v.n_sessions, "waves": v.n_waves, "solo": v.n_solo,
                           "max_wave": v.max_wave, "mean_wave": v.mean_wave, "occupancy": v.occupancy}
                       for k, v in stats.items()},
        "gang": {"replay_s": g_wall, "waves_s": g_rep.compute_s, "decode_s": decode_s["gang"],
                 "host_s": g_wall - g_rep.compute_s - decode_s["gang"], "n_dispatches": g_rep.n_dispatches},
        "solo": {"replay_s": s_wall, "flushes_s": s_rep.compute_s, "decode_s": decode_s["solo"],
                 "host_s": s_wall - s_rep.compute_s - decode_s["solo"], "n_dispatches": s_rep.n_dispatches},
        "wire_bytes": sum(r.wire_bytes for r in g_rep.sessions.values()),
        "ratio": g_rep.ratio,
        "profiled_wave": {c: profiled_wave(dev, c, values, SERVE_TOPICS // 2) for c in ("tcomp32", "tdic32")},
        "records_equal_solo": True, "frames_equal_solo": True, "cpu_topics": list(SERVE_CPU_TOPICS),
        "launches": {"gang": {k: n for k, n in g_counts.items() if n},
                     "solo": {k: n for k, n in s_counts.items() if n}},
        "seconds": time.perf_counter() - t_job,
    })
    return g_counts, (g_keys, g_frames, g_rep)


def run_gang(dev, full_values: dict) -> tuple:
    """Phase gang: the offline gang jobs, then the serving runtime. Returns
    the summed launches of the gang runs and the gang replay, and the gang
    replay's (keys, frames, report), the fleet phase's oracle."""
    launches = {k: 0 for k in KERNELS}
    for name, (_, dataset, _) in GANG_JOBS.items():
        for k, n in run_gang_offline(dev, name, full_values[dataset]).items():
            launches[k] += n
    counts, serve_gang = run_gang_serve(dev, full_values["rovio"])
    for k, n in counts.items():
        launches[k] += n
    return launches, serve_gang


#: the fleet phase: mesh width, the chaos drill's losses (wave -> slot) and
#: its volume a topic (1 MiB), the mixed mesh's topics (two a signature),
#: and sharded_compress_fn's geometry (lanes, blocks, tuples a block)
FLEET_SLOTS = 4
FLEET_CHAOS = {1: 2, 3: 0}
FLEET_SMALL_TUPLES = 262_144
FLEET_MIXED_TOPICS = ("t00", "t01", "t08", "t09")
SHARDED_LANES, SHARDED_BLOCKS, SHARDED_BLOCK_TUPLES = 16, 128, 2048


def fleet_session(slots) -> ElasticSession:
    return ElasticSession(len(slots), profile="cstream", devices=list(slots))


def card_slots(n: int = FLEET_SLOTS) -> list:
    """n mesh slots over the visible cards, round-robin."""
    return [torch.device("cuda", i % torch.cuda.device_count()) for i in range(n)]


def mixed_slots() -> list:
    """The mixed mesh: the first card, then the CPU."""
    return [card_slots(1)[0], torch.device("cpu")]


def launches_on(slot: str) -> bool:
    """Whether a shard on this slot launches kernels (a CPU slot runs the
    plain versions)."""
    return slot.startswith("cuda")


@contextlib.contextmanager
def shard_log():
    """Record, while open, each `gang_step` call: its codec, mesh width and
    slots, and the devices of every tensor each of its `_wave_step` calls
    (one per shard) took and gave."""
    log = {"waves": []}
    gang_step, wave_step = CompressionPipeline.gang_step, CompressionPipeline._wave_step
    shards: list = []

    def logged_gang(self, states, blocks, masks, meta7=False, mesh=None):
        shards.clear()
        out = gang_step(self, states, blocks, masks, meta7=meta7, mesh=mesh)
        log["waves"].append({"codec": self.codec.name, "width": 1 if mesh is None else mesh.size,
                             "slots": [] if mesh is None else [str(d) for d in mesh.devices],
                             "shards": list(shards)})
        shards.clear()
        return out

    def logged_wave(self, state, blocks, masks, meta7=False):
        out = wave_step(self, state, blocks, masks, meta7=meta7)
        tensors = [blocks, masks, *(state or {}).values(), *(out[0] or {}).values(), *out[1:]]
        shards.append(sorted({str(t.device) for t in tensors if t is not None}))
        return out

    CompressionPipeline.gang_step, CompressionPipeline._wave_step = logged_gang, logged_wave
    try:
        yield log
    finally:
        CompressionPipeline.gang_step, CompressionPipeline._wave_step = gang_step, wave_step


def fleet_replay(dev, feeds: dict, mesh, topics=None, fault=None) -> tuple:
    """serve_replay on a fleet Dispatcher: (dispatcher, report, host wall,
    launches, shard log)."""
    d = cstream.Dispatcher(gang=True, mesh=mesh, fault_injector=fault, device=dev)
    for t in topics or sorted(feeds):
        d.open(serve_spec(t), topic=t).push(*feeds[t])
    with shard_log() as log:
        counts, wall, rep = counted_window(d.run)
    return d, rep, wall, counts, log


def fleet_check(name: str, rep, counts: dict, log: dict) -> dict:
    """Launches of a fleet replay against its shard log and report: one
    B1+B4 per card shard of a wave and per solo flush (solo flushes run on
    the server's card), one B5 probe per card shard or solo flush of
    tdic32; every tensor of a shard on its slot's device. Returns the
    per-signature stats."""
    stats = rep.dispatch_stats
    waves = log["waves"]
    if len(waves) != sum(v.n_waves for v in stats.values()):
        raise AssertionError(f"{name}: {len(waves)} gang steps for "
                             f"{sum(v.n_waves for v in stats.values())} waves in the report")
    for w in waves:
        if w["width"] > 1 and w["shards"] != [[slot] for slot in w["slots"]]:
            raise AssertionError(f"{name}: a wave on slots {w['slots']} ran shards on {w['shards']}")
    solo = {c: sum(v.n_solo for v in stats.values() if v.codec == c) for c in ("tcomp32", "tdic32")}

    def card_shards(codec=None):
        return sum(sum(launches_on(s) for s in w["slots"]) if w["width"] > 1 else 1
                   for w in waves if codec in (None, w["codec"]))

    want = {"pack_blocks_meta7": card_shards() + sum(solo.values()),
            "dict_probe": card_shards("tdic32") + solo["tdic32"], "pack_blocks": 0, "pack_meta7_blocks": 0}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"{name}: launched { {k: counts[k] for k in want} }, expected {want}")
    return {k: {"sessions": v.n_sessions, "waves": v.n_waves, "solo": v.n_solo, "max_wave": v.max_wave,
                "mean_wave": v.mean_wave, "padded_slots": v.padded_slots, "occupancy": v.occupancy}
            for k, v in stats.items()}


def fleet_frames_equal(name: str, got, want, topics) -> None:
    bad = sorted(t for t in topics if got[0][t] != want[0][t] or got[1][t] != want[1][t])
    if bad:
        raise AssertionError(f"{name}: keys or frames differ from the unsharded gang's on {bad}")


def run_sharded_compress(dev, values: np.ndarray) -> dict:
    """`engine.sharded_compress_fn` over 4 card slots against 4 CPU slots,
    block by block with the state carried: equal words, bit totals and
    final state; one B1 launch per card slot and block, and one B5 probe
    too for tdic32. Returns the card runs' launches."""
    per_lane = SHARDED_BLOCK_TUPLES // SHARDED_LANES
    n = SHARDED_BLOCKS * SHARDED_BLOCK_TUPLES
    blocks = values[:n].view(np.int32).reshape(SHARDED_BLOCKS, SHARDED_LANES, per_lane).copy()
    launches = {k: 0 for k in KERNELS}
    out = {}
    for codec, shared in (("tdic32", True), ("tcomp32", False)):
        runs = {}
        for where, slots in (("card", card_slots()), ("cpu", [torch.device("cpu")] * FLEET_SLOTS)):
            fn = engine.sharded_compress_fn(codec, fleet_session(slots).mesh, shared_state=shared)
            home = slots[0]
            blk = torch.from_numpy(blocks).to(home)

            def loop():
                state = make_codec(codec).init_state(SHARDED_LANES, home)
                words, total = [], []
                for i in range(SHARDED_BLOCKS):
                    state, w, tb = fn(state, blk[i])
                    words.append(w)
                    total.append(tb)
                return state, torch.stack(words).cpu(), torch.stack(total).cpu()

            counts, wall, res = counted_window(loop)
            runs[where] = (res, wall, counts)
        (c_state, c_words, c_bits), c_wall, c_counts = runs["card"]
        (p_state, p_words, p_bits), p_wall, _ = runs["cpu"]
        if not (torch.equal(c_words, p_words) and torch.equal(c_bits, p_bits)) or (
                c_state is not None and any(not torch.equal(c_state[k].cpu(), p_state[k]) for k in c_state)):
            raise AssertionError(f"sharded_compress_fn/{codec}: the card's output differs from the CPU's")
        want = {"pack_blocks": FLEET_SLOTS * SHARDED_BLOCKS,
                "dict_probe": FLEET_SLOTS * SHARDED_BLOCKS if codec == "tdic32" else 0}
        if {k: c_counts[k] for k in want} != want:
            raise AssertionError(f"sharded_compress_fn/{codec}: launched "
                                 f"{ {k: c_counts[k] for k in want} }, expected {want}")
        for k, v in c_counts.items():
            launches[k] += v
        out[codec] = {"shared": shared, "card_s": c_wall, "cpu_s": p_wall,
                      "total_bits": int(c_bits.sum()), "launches": {k: v for k, v in c_counts.items() if v}}
    emit({"phase": "fleet", "job": "sharded_compress_fn", "slots": [str(d) for d in card_slots()],
          "lanes": SHARDED_LANES, "blocks": SHARDED_BLOCKS, "block_tuples": SHARDED_BLOCK_TUPLES,
          "card_equals_cpu": True, **out})
    return launches


def run_fleet(dev, values: np.ndarray, serve_gang: tuple) -> dict:
    """Phase fleet: the 4-slot replay of the serving cell against the gang
    phase's unsharded replay, the chaos drill and the mixed mesh at 1 MiB a
    topic against an unsharded replay at that volume, and the sharded
    compression step. Returns the summed launches of its card runs."""
    launches = {k: 0 for k in KERNELS}

    def add(counts):
        for k, n in counts.items():
            launches[k] += n

    t_job = time.perf_counter()
    g_keys, g_frames, g_rep = serve_gang
    slots = card_slots()
    feeds = serve_feeds(values, SERVE_TUPLES)
    d, rep, wall, counts, log = fleet_replay(dev, feeds, fleet_session(slots))
    fleet_frames_equal("fleet/16-topics-4-slots", serve_keys_frames(d), (g_keys, g_frames), feeds)
    if rep.devices != FLEET_SLOTS or not all(r.fidelity.bit_exact for r in rep.sessions.values()):
        raise AssertionError(f"fleet/16-topics-4-slots: devices {rep.devices}, or a topic not exact")
    stats = fleet_check("fleet/16-topics-4-slots", rep, counts, log)
    add(counts)
    decode_s = sum(r.decode_s for r in rep.sessions.values())
    emit({
        "phase": "fleet", "job": "fleet/16-topics-4-slots", "slots": [str(s) for s in slots],
        "topics": SERVE_TOPICS, "tuples_per_topic": SERVE_TUPLES, "input_bytes": SERVE_TOPICS * SERVE_TUPLES * 4,
        "devices": rep.devices, "replay_s": wall, "waves_s": rep.compute_s, "decode_s": decode_s,
        "host_s": wall - rep.compute_s - decode_s, "device_makespan_s": rep.device_makespan_s,
        "fleet_mbps": rep.fleet_mbps, "n_dispatches": rep.n_dispatches,
        "gang_replay": {"waves_s": g_rep.compute_s, "signatures": {
            k: {"waves": v.n_waves, "solo": v.n_solo, "mean_wave": v.mean_wave}
            for k, v in g_rep.dispatch_stats.items()}},
        "signatures": stats, "frames_equal_gang": True,
        "launches": {k: n for k, n in counts.items() if n},
        "seconds": time.perf_counter() - t_job,
    })

    t_job = time.perf_counter()
    small = {t: (v[:FLEET_SMALL_TUPLES], ts[:FLEET_SMALL_TUPLES]) for t, (v, ts) in feeds.items()}
    base_d, base_rep, base_wall, base_counts = serve_replay(dev, small, gang=True)
    base = serve_keys_frames(base_d)
    add(base_counts)
    d, rep, wall, counts, log = fleet_replay(dev, small, fleet_session(slots),
                                             fault=DeviceLossInjector(dict(FLEET_CHAOS)))
    fleet_frames_equal("fleet/chaos", serve_keys_frames(d), base, small)
    events = [e["n_devices"] for e in rep.fault_events]
    if events != [3, 2] or rep.devices != 2:
        raise AssertionError(f"fleet/chaos: fault events {rep.fault_events}, devices {rep.devices}")
    widths = sorted({w["width"] for w in log["waves"]})
    stats = fleet_check("fleet/chaos", rep, counts, log)
    add(counts)
    emit({"phase": "fleet", "job": "fleet/chaos", "slots": [str(s) for s in slots],
          "tuples_per_topic": FLEET_SMALL_TUPLES, "losses": {str(k): v for k, v in FLEET_CHAOS.items()},
          "fault_events": rep.fault_events, "devices": rep.devices, "wave_widths": widths,
          "replay_s": wall, "gang_replay_s": base_wall, "waves_s": rep.compute_s,
          "signatures": stats, "frames_equal_gang": True,
          "launches": {k: n for k, n in counts.items() if n}, "seconds": time.perf_counter() - t_job})

    t_job = time.perf_counter()
    mixed = mixed_slots()
    d, rep, wall, counts, log = fleet_replay(dev, small, fleet_session(mixed), topics=FLEET_MIXED_TOPICS)
    fleet_frames_equal("fleet/mixed", serve_keys_frames(d), base, FLEET_MIXED_TOPICS)
    stats = fleet_check("fleet/mixed", rep, counts, log)
    if not any(w["width"] == 2 for w in log["waves"]):
        raise AssertionError("fleet/mixed: no wave was sharded over the card and the CPU")
    add(counts)
    emit({"phase": "fleet", "job": "fleet/mixed", "slots": [str(s) for s in mixed],
          "topics": list(FLEET_MIXED_TOPICS), "tuples_per_topic": FLEET_SMALL_TUPLES,
          "sharded_waves": sum(w["width"] == 2 for w in log["waves"]),
          "shards_on_their_slots": True, "replay_s": wall, "waves_s": rep.compute_s, "signatures": stats,
          "frames_equal_gang": True, "launches": {k: n for k, n in counts.items() if n},
          "seconds": time.perf_counter() - t_job})

    add(run_sharded_compress(dev, values))
    return launches


#: the moe phase (ROADMAP A10: the moe family and the three remaining dense
#: configs). Path 2: one MoEFFN at qwen3-moe-30b-a3b's full width (128
#: experts of 768, top-8, d_model 2,048) from seed 0, on 2 x 512 tokens of a
#: fixed float32 input, on the card and on the CPU
MOE_ROUTE = dict(arch="qwen3-moe-30b-a3b", batch=2, tokens=512)
#: the moe phase's limits, written before the first run that reads them and
#: never loosened after one.
#:  * route: the router's product is float32 on both sides, on the same
#:    inputs (bf16 inputs are rounded before either side sees them), so the
#:    two routings differ only where float32 summation order moves a
#:    probability across a near-tie of a token's k-th and (k+1)-th experts:
#:    `sel` equal at >= 0.999 in both dtypes. y is compared on the tokens
#:    whose every route (expert and slot) agrees: float32 within 1e-4 of
#:    max |y| (products over 2,048 and 768 terms in another order); bf16
#:    within 0.03 of max |y| (the expert products, the SwiGLU and the
#:    weighted sum over k each round to bf16, on each side in its own
#:    order: a few bf16 steps of the largest output);
#:  * serve: the card-vs-CPU serving check of each dense config at full
#:    width and 2 layers holds LM_CHECK unchanged. The moe configs hold
#:    LM_CHECK's limits, with the cache codes compared over the slots fed
#:    the same tokens on both sides (`slots_fed_alike`): a decode step
#:    writes the k/v of the token it was fed, so once a request's greedy
#:    tokens part, the slots written after hold different tokens' codes by
#:    design. The first run found it: mixtral-8x7b's second request parted
#:    at its second generated token (CPU top-2 margin 0.14), and its two
#:    later slots of 768 put layer 0's codes at 0.9974 over the whole ring
MOE_CHECK = dict(
    route={"float32": dict(sel=0.999, y_frac=1e-4), "bfloat16": dict(sel=0.999, y_frac=0.03)},
    serve=dict(LM_CHECK, codes_over_slots_fed_alike=True),
)
MOE_ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x7b")
DENSE_ARCHS = ("deepseek-coder-33b", "mistral-nemo-12b", "phi4-mini-3.8b")
#: paths 4 and 5: qwen3-moe-30b-a3b at full width cut to 24 of its 48 layers
#: (30.5 B parameters, 61.1 GB in bf16 at all 48; cut since the frontends
#: phase came, for the script's time: its path was the costliest of the
#: earlier ones by its own printed seconds, 50-66 s), 4 x 2,048 prompt
#: tokens; mixtral-8x7b at
#: full width cut to 8 of its 32 layers (46.7 B parameters, 93.4 GB in bf16,
#: do not fit one 80 GB card; 8 layers hold 23.7 GB), one request of 8,192
#: prompt tokens, twice its 4,096-token window; 32 generated, NUQ cache on
MOE_PATHS = (
    dict(arch="qwen3-moe-30b-a3b", batch=4, prompt_len=2048, gen=32, n_layers=12),
    dict(arch="mixtral-8x7b", batch=1, prompt_len=8192, gen=32, n_layers=8),
)
#: path 6: each dense config at full width and 16 of its layers (all 32, 40
#: and 62 hold phi4-mini 7.7 GB, mistral-nemo 24.5 GB, deepseek-coder 66.7
#: GB in bf16), 4 x 2,048 + 8. Cut, with qwen3-moe's path to 12 of 48
#: layers and musicgen's to 24 of 48, when the tp phase came: the script
#: ran 1,115.1 s on the H100 with them at 62/40/32, 24 and 48 layers, over
#: its 1,050 s target
DENSE_PATH = dict(batch=4, prompt_len=2048, gen=8, n_layers=16)
#: decode steps of the ring check (a prompt longer than the ring)
RING_STEPS = 8
#: device memory in use when the moe phase starts: the earlier phases' models freed
MOE_START_BYTES = 2 << 30


def route_side(params: dict, cfg, x: torch.Tensor, d, shape=None) -> tuple:
    """One side of path 2: `moe_ffn` and its routing (`route`, `capacity`,
    `_dispatch_indices`) on device `d`; (y, aux, sel, e, slot) on the CPU.
    With a mesh `shape` ((data 1, model n), every slot on `d`), the split
    form `moe.moe_group` over its one model group, each slot on its shard
    of the experts (or of each expert's d_ff)."""
    p = {k: v.to(d) for k, v in params.items()}
    xd = x.to(d)
    t = xd.shape[0] * xd.shape[1]
    with torch.inference_mode():
        if shape is None:
            y, aux = moe.moe_ffn(p, cfg, xd)
        else:
            mesh = card_mesh(shape, ("data", "model"), d)
            ms = model_split(cfg)
            with partition.logical_axes(MAP2), partition.set_mesh(mesh):
                g = partition.model_groups(mesh, {})[0]
                ps = [{k: slot_weight(v, ms["layers.0.moe." + k], i, g.n, d) for k, v in p.items()}
                      for i in range(g.n)]
                ys, auxs = moe.moe_group(g, ps, cfg, [xd] * g.n, moe.capacity(t, cfg))
            y, aux = ys[0], auxs[0]
        _, sel, _, _ = moe.route(p["router"], cfg, xd.reshape(t, cfg.d_model))
        e, slot = moe._dispatch_indices(sel.reshape(-1), cfg.n_experts, moe.capacity(t, cfg))
    return y.float().cpu(), aux.item(), sel.cpu(), e.cpu(), slot.cpu()


def check_moe_route(dev, shape=None, phase: str = "moe") -> dict:
    """Path 2 (moe/route_card_vs_cpu): one MoEFFN at full width, the same
    weights and input on the card and on the CPU, float32 and bf16: the
    share of equal `sel` entries and of equal (expert, slot) pairs, the
    dropped pairs on each side, y's max error on the tokens whose every
    route agrees; `_dispatch_indices` of the CPU's `sel` on both sides.
    Held to MOE_CHECK["route"]. With a mesh `shape`, the split form on
    card slots against CPU slots (`route_side`)."""
    c = MOE_ROUTE
    base = get_arch(c["arch"]).model
    ffn = MoEFFN(base, Storage(torch.float32, torch.float32, torch.device("cpu"), False))
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for w in ffn.parameters():
            w.copy_((torch.randn(w.shape, generator=gen, device=dev) / math.sqrt(w.shape[-2])).cpu())
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(c["batch"], c["tokens"], base.d_model))
                         .astype(np.float32))
    t, k = c["batch"] * c["tokens"], base.n_experts_per_token
    cap = moe.capacity(t, base)
    out = {}
    for dtype, lim in MOE_CHECK["route"].items():
        cfg = dataclasses.replace(base, dtype=dtype)
        dt = getattr(torch, dtype)
        params = {n: v.to(dt) for n, v in ffn.params().items()}
        (yc, auxc, selc, ec, slotc), (yh, auxh, selh, eh, sloth) = (
            route_side(params, cfg, x.to(dt), d, shape) for d in (dev, torch.device("cpu")))
        pairs = (ec == eh) & (slotc == sloth)
        agree = (selc == selh).all(dim=1) & pairs.reshape(t, k).all(dim=1)
        scale = yh.abs().max().item()
        y_err = (yc - yh).abs().reshape(t, -1)[agree].max().item()
        same_dispatch = all(torch.equal(a.cpu(), b) for a, b in zip(
            moe._dispatch_indices(selh.to(dev).reshape(-1), cfg.n_experts, cap),
            moe._dispatch_indices(selh.reshape(-1), cfg.n_experts, cap)))
        r = {"sel_agreement": (selc == selh).double().mean().item(),
             "pair_agreement": pairs.double().mean().item(),
             "tokens_agreeing": int(agree.sum()), "tokens": t, "capacity": cap,
             "dropped_card": int((slotc == cap).sum()), "dropped_cpu": int((sloth == cap).sum()),
             "y_max_abs_err_agreeing": y_err, "max_abs_y": scale, "aux_card": auxc, "aux_cpu": auxh,
             "dispatch_of_cpu_sel_equal": same_dispatch, "limits": lim}
        out[dtype] = r
        emit({"phase": phase, "path": "route_card_vs_cpu", "arch": c["arch"], "dtype": dtype,
              "mesh": None if shape is None else dict(zip(("data", "model"), shape)), **r})
        bad = []
        if r["sel_agreement"] < lim["sel"]:
            bad.append(f"sel agreement {r['sel_agreement']}")
        if not y_err <= lim["y_frac"] * scale:
            bad.append(f"y differs by {y_err} (max |y| {scale})")
        if not same_dispatch:
            bad.append("_dispatch_indices of one sel differs between the card and the CPU")
        if bad:
            raise AssertionError(f"moe routing, {dtype}, card against CPU: " + "; ".join(bad))
    return out


@contextlib.contextmanager
def dropped_pairs(model, cfg):
    """While open, each layer's MoEFFN call appends to the yielded list the
    (token, choice) pairs its routing drops (a forward hook on each)."""
    drops = []

    def hook(mod, args, _out):
        x = args[1]
        t = x.shape[0] * x.shape[1]
        _, sel, _, _ = moe.route(mod.p("router"), cfg, x.reshape(t, cfg.d_model))
        cap = moe.capacity(t, cfg)
        _, slot = moe._dispatch_indices(sel.reshape(-1), cfg.n_experts, cap)
        drops.append(int((slot == cap).sum()))

    handles = [blk.moe.register_forward_hook(hook) for blk in model.layers]
    try:
        yield drops
    finally:
        for h in handles:
            h.remove()


def moe_prefill_drops(model, cfg, prompts, cache_len: int) -> tuple:
    """One more prefill, outside the timed run: (the (token, choice) pairs
    each layer's routing drops, cache, logits)."""
    with dropped_pairs(model, cfg) as drops:
        cache, logits = prefill(model, cfg, prompts, cache_len)
    return drops, cache, logits


def first_attention(model, cfg, prompts) -> tuple:
    """The first attention layer's `Attention` module and its input (the
    normed residual stream at that layer) over `prompts`: layer 0's, or for
    the hybrid family group 0's, after its two RG-LRU sublayers."""
    x = model.embedding(prompts)
    if cfg.family == "hybrid":
        grp = model.groups[0]
        x = grp.rec2.apply(cfg, grp.rec1.apply(cfg, x)[0])[0]
        return grp.attn, layers.rms_norm(x, grp.p("attn_norm"))
    blk = model.layers[0]
    return blk.attn, layers.rms_norm(x, blk.p("attn_norm"))


def check_ring_wrap(model, cfg, prompts, cache, logits) -> dict:
    """A prompt longer than the ring: the first attention layer's ring after
    the prefill holds the codes of the last W positions' keys (position p
    at slot p % W), and RING_STEPS decode steps overwrite the oldest slots
    one by one, no other."""
    b, s = prompts.shape
    codes = attention_ring(cfg, cache)["k_codes"][0]
    w = codes.shape[1]
    pos = torch.arange(s, dtype=torch.int32, device=prompts.device)[None].expand(b, s)
    attn, h = first_attention(model, cfg, prompts)
    _, k0, _ = layers.attention_qkv(attn.params(), cfg, h, pos)
    want, _ = kvcache.quantize_block(k0[:, -w:])
    slots = (s - w + torch.arange(w, device=prompts.device)) % w
    stored_last = torch.equal(codes[:, slots], want)
    before = codes.clone()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for _ in range(RING_STEPS):
        cache, lg = decode_step(model, cfg, cache, tok)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
    changed = (attention_ring(cfg, cache)["k_codes"][0] != before).flatten(2).any(dim=-1).any(dim=0).cpu()
    expect = torch.zeros(w, dtype=torch.bool)
    expect[(s + torch.arange(RING_STEPS)) % w] = True
    return {"ring_holds_last_positions": stored_last, "decode_overwrites_oldest": torch.equal(changed, expect)}


def free_card() -> None:
    """Return the freed models' memory to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def run_moe_path(dev, spec: dict) -> dict:
    """Paths 4-5: one moe config served through `serve()` as run_lm serves
    the lm path (launches, checks, busy shares, host ops per step), then one
    more prefill for the dropped pairs per layer, and the ring check where
    the prompt is longer than the ring. Frees the model. Returns launches."""
    t0 = time.perf_counter()
    launches, model, prompts = run_lm(dev, spec["arch"], spec["batch"], spec["prompt_len"], spec["gen"],
                                      spec["n_layers"], phase="moe", path=spec["arch"])
    cfg = model.cfg
    t = spec["batch"] * spec["prompt_len"]
    with torch.inference_mode():
        drops, cache, logits = moe_prefill_drops(model, cfg, prompts, spec["prompt_len"] + spec["gen"])
        line = {"phase": "moe", "path": spec["arch"], "n_layers": cfg.n_layers,
                "cut": None if spec["n_layers"] is None else
                f"{spec['n_layers']} of {get_arch(spec['arch']).model.n_layers} layers",
                "dropped_pairs_per_layer": drops, "pairs_per_layer": t * cfg.n_experts_per_token,
                "capacity": moe.capacity(t, cfg), "experts": cfg.n_experts}
        checks = {}
        if spec["prompt_len"] > cache["layers"]["k_codes"].shape[2]:
            checks = check_ring_wrap(model, cfg, prompts, cache, logits)
            line["ring"] = checks
        del cache, logits
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    if not all(checks.values()):
        raise AssertionError(f"{spec['arch']}: the ring fails its checks: {checks}")
    del model, prompts
    free_card()
    return launches


def run_moe(dev) -> dict:
    """The moe phase: paths 2-6 (path 1 is the flash phase's
    MOE_FLASH_CASES), then moe training (`check_moe_train_card_vs_cpu`,
    `run_moe_train`) on the card the served paths have freed. Returns the
    launches of the main paths (4-6 and the train run)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the router's float32 product must be true float32")
    free_card()
    if torch.cuda.memory_allocated() >= MOE_START_BYTES:
        raise AssertionError(f"{torch.cuda.memory_allocated()} bytes still allocated before the moe phase")
    t0 = time.perf_counter()
    check_moe_route(dev)
    emit({"phase": "moe", "path": "route_card_vs_cpu", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    for arch in MOE_ARCHS + DENSE_ARCHS:
        check = MOE_CHECK["serve"] if arch in MOE_ARCHS else LM_CHECK
        check_lm_card_vs_cpu(dev, arch, check, phase="moe", init_device=dev)
        free_card()
    emit({"phase": "moe", "path": "card_vs_cpu", "seconds": time.perf_counter() - t0})
    launches = {k: 0 for k in KERNELS}
    for spec in MOE_PATHS:
        for k, n in run_moe_path(dev, spec).items():
            launches[k] += n
    t0 = time.perf_counter()
    for arch in DENSE_ARCHS:
        got, model, prompts = run_lm(dev, arch, DENSE_PATH["batch"], DENSE_PATH["prompt_len"], DENSE_PATH["gen"],
                                     DENSE_PATH["n_layers"], phase="moe", path=f"dense/{arch}")
        for k, n in got.items():
            launches[k] += n
        del model, prompts
        free_card()
    emit({"phase": "moe", "path": "dense-configs", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    check_moe_train_card_vs_cpu(dev)
    free_card()
    for k, n in run_moe_train(dev).items():
        launches[k] += n
    emit({"phase": "moe", "path": "train-all", "seconds": time.perf_counter() - t0})
    return launches


#: the moe phase's training part (ROADMAP A10 item 6): qwen3-moe-30b-a3b
#: at full width (d_model 2,048, 32 heads over 4 kv heads of 128, 128
#: experts of d_ff 768, top-8, capacity factor 1.25, an untied 151,936
#: vocabulary, full remat). (a) card against CPU at 2 layers (2 x 0.623 B
#: + 0.622 B = 1.87 B parameters, 7.5 GB a float32 set), 2 x 128 tokens,
#: float32 then bf16, the same numpy weights (drawn on the card from seed
#: 0) and tokens on both. The limits, written before the first run that
#: reads them and never loosened after one:
#:  * loss, every held gradient and the updates: TRAIN_CHECK's, as they
#:    stand, in each dtype; the aux loss: TRAIN_CHECK's loss limit;
#:  * routing: where float32 summation order moves a near-tie of a token's
#:    8th and 9th experts the two sides route a pair to different experts.
#:    Each side's `sel` is recorded per layer (a pre-hook on each MoEFFN,
#:    the module's own `route` on its input) in the forward and in full
#:    remat's recompute, which must route alike on each side (the
#:    recompute's dispatch must be the forward's). The share of each
#:    token's routed experts that both sides route (`sel_set_agreement`,
#:    over all layers) must be >= MOE_CHECK's 0.999; `sel` compared place
#:    by place (`sel_agreement`, MOE_CHECK's route measure) is printed, not
#:    gated: two near-tied experts inside a token's top 8 swap places and
#:    route the same pairs to the same slots at the same gates;
#:  * a flip swaps an expert's whole gradient, and the stacked expert
#:    leaves (E, ., .) hold all 128 experts: their rows are compared only
#:    for experts whose routed (token, slot) set is the same on both sides
#:    (the count left out printed per layer), every other leaf whole;
#:  * each side's dispatch of its `sel` on its own device equals the CPU's
#:    dispatch of that `sel`, and the dropped pairs of a layer whose
#:    routing agrees in full are equal.
#: The first chip run (H100, 700 W) held both dtypes' whole steps to these
#: limits. float32 passed in full: every routed expert alike, gradients
#: within 4.4e-6. bf16 did not: 0.9915 of the routed pairs alike (0.919
#: place by place), 9 and 27 experts left out, the router's gradient 0.15
#: apart (its loss 4.3e-4 and aux loss 6.5e-4 apart). In bf16 the blocks'
#: inputs differ by bf16 rounding steps (B10's tensor-core output is held
#: within one bf16 step of its plain version, C4, and GEMMs summed in
#: another order round elsewhere), which moves near-ties of the router's
#: 128 probabilities far more often than float32's summation order does,
#: and a flipped token moves every column of the router's gradient (the
#: softmax couples them). So each dtype is also held stage by stage: the
#: card runs each stage on the CPU's own input to it and the CPU's
#: gradient at its output (`staged_loss`), where the router's input is
#: the CPU's and the two sides' routings differ by float32 summation order
#: alone; that form is held to every limit above, in both dtypes. Its
#: first run staged whole blocks, and bf16 failed again (0.9978 of the
#: routed pairs alike, 9 experts left out in layer 0: a block's attention,
#: B10 within one bf16 step, still moves the router's input); the stages
#: are since the embedding, each block's attention sublayer (to the moe's
#: normed input), its moe sublayer, each under full remat, and the head
#: (written before that form's first run). The whole step stays
#: held to every limit in float32 and to the loss and aux limits in bf16;
#: bf16's whole-step routing, gradients and updates are printed.
#: AdamW's step runs one leaf at a time (clip_norm None: each leaf's update
#: is its own), so that the CPU side holds weights, gradients and updates
#: (22.5 GB with the numpy tree) and not AdamW's moments and foreach
#: temporaries besides
MOE_TRAIN_CHECK = dict(arch="qwen3-moe-30b-a3b", layers=2, batch=2, seq=128, lr=TRAIN_CHECK["lr"],
                       sel_set=MOE_CHECK["route"]["float32"]["sel"], aux_weight=TrainStepConfig().aux_weight)
#: (b) `train()` at full width cut to 3 of 48 layers, 8 compressed steps of
#: TRAIN_BATCH x TRAIN_SEQ through B2. 16 bytes a parameter (float32
#: masters, gradients, two moments) and AdamW's foreach passes, which hold
#: three more float32 sets at once (mhat, v / bc2 and its sqrt): at 4
#: layers (3.11 B parameters) 7 sets are 87 GB, past the card's 80; at 3
#: (2.49 B) ~70 GB
MOE_TRAIN = dict(arch="qwen3-moe-30b-a3b", n_layers=3, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
#: the stacked expert leaves, compared on the experts routed alike
EXPERT_LEAF = re.compile(r"^layers\.(\d+)\.moe\.(w_gate|w_up|w_down)$")


def stage_recorder(i: int, last: bool, rec: dict):
    """A forward hook on block i that records, on its first call (not
    remat's recompute), its input and the gradient at its output, for
    block 0 the gradient at its input (the embedding's output), for the
    last block its output (the head's input)."""
    def hook(_mod, args, output):
        if f"x{i}" in rec:
            return
        x, out = args[1], output[0]
        rec[f"x{i}"] = x.detach()
        out.register_hook(lambda g: rec.__setitem__(f"g{i}", g.detach()))
        if i == 0:
            x.register_hook(lambda g: rec.__setitem__("g_embed", g.detach()))
        if last:
            rec["x_final"] = out.detach()
    return hook


def attention_stage(blk, cfg, x: torch.Tensor) -> tuple:
    """A block's first half, as `Block.forward` runs it: (h = x + its
    attention, the moe's input: h normed by `ffn_norm`)."""
    h = x + layers.attention_train(blk.attn.params(), cfg, layers.rms_norm(x, blk.p("attn_norm")),
                                   window=cfg.swa_window)
    h = partition.hint(h, "data", None, None)
    return h, layers.rms_norm(h, blk.p("ffn_norm"))


def staged_loss(model, cfg, inputs: torch.Tensor, labels: torch.Tensor, st: dict, aux_weight: float) -> tuple:
    """A scalar whose gradient with respect to every parameter is the
    whole step's, given another side's recorded stages `st`: the embedding
    of `inputs` dotted with the gradient at its output; for each block its
    attention sublayer (`attention_stage`) on the block's recorded input,
    h dotted with the gradient at the block's output and the normed h with
    the gradient at the moe's input, and its MoEFFN on the moe's recorded
    input dotted with the gradient at the block's output plus aux_weight x
    its aux loss, each sublayer under full remat as `forward` runs the
    block; and the head's cross-entropy (`loss_fn`'s) on the recorded final
    hidden state. Returns (that scalar, the cross-entropy, the summed aux
    loss)."""
    total = torch.sum(model.embedding(inputs) * st["g_embed"]).float()

    def run(fn, *args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False) if cfg.remat == "full" \
            else fn(*args)

    auxs = []
    for i, blk in enumerate(model.layers):
        h, n = run(lambda x, blk=blk: attention_stage(blk, cfg, x), st[f"x{i}"])
        y, aux = run(blk.moe, cfg, st[f"n{i}"])
        total = total + (torch.sum(h * st[f"g{i}"]) + torch.sum(n * st[f"gn{i}"])
                         + torch.sum(y * st[f"g{i}"])).float() + aux_weight * aux
        auxs.append(aux)
    logp = torch.log_softmax(model.logits(st["x_final"]).to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    ce = torch.sum(nll) / nll.numel()
    return total + ce, ce, torch.sum(torch.stack(auxs))


def moe_train_side(model, cfg, tokens: np.ndarray, lr: float, aux_weight: float,
                   stages: Optional[dict] = None) -> dict:
    """One side of `check_moe_train_card_vs_cpu` on `model`'s device, its
    parameters left as they are (float32 masters). Without
    `stages`: the whole step, `loss_fn` under full remat and autograd,
    recording every stage (`stage_recorder`, and the moe's input and the
    gradient there; returned on the CPU under "stages"). With another side's `stages`: `staged_loss` on them. Either
    way the loss (`loss_fn`'s: cross-entropy + aux_weight x aux), the aux loss, every parameter's
    gradient, one AdamW step's updates, and each layer's `sel` in every
    MoEFFN call (the forward's, then the recompute's, on the CPU). The
    gradients and updates stay on the model's device."""
    d = model.device
    inputs, labels = (torch.from_numpy(a).to(d) for a in (tokens[:, :-1], tokens[:, 1:]))
    params = dict(model.named_parameters())
    routes = {i: [] for i in range(cfg.n_layers)}
    rec: dict = {}

    def recorder(i):
        def hook(mod, args):
            x = args[1]
            with torch.no_grad():
                _, sel, _, _ = moe.route(mod.p("router"), cfg, x.reshape(-1, cfg.d_model))
            routes[i].append(sel.cpu())
            if stages is None and f"n{i}" not in rec:  # the moe's input and the gradient there
                rec[f"n{i}"] = x.detach()
                x.register_hook(lambda g: rec.__setitem__(f"gn{i}", g.detach()))
        return hook

    handles = [blk.moe.register_forward_pre_hook(recorder(i)) for i, blk in enumerate(model.layers)]
    try:
        if stages is None:
            handles += [blk.register_forward_hook(stage_recorder(i, i == cfg.n_layers - 1, rec))
                        for i, blk in enumerate(model.layers)]
            loss, metrics = loss_fn(model, cfg, {"inputs": inputs, "labels": labels}, aux_weight)
            value, aux = loss, metrics["aux"]
        else:
            loss, ce, aux = staged_loss(model, cfg, inputs, labels, {k: v.to(d) for k, v in stages.items()},
                                        aux_weight)
            value = ce + aux_weight * aux
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    finally:
        for h in handles:
            h.remove()
    opt_init, opt_update = adamw(AdamWConfig(lr=lr, clip_norm=None))
    updates = {}
    with torch.no_grad():
        for k, p in params.items():
            one = {k: p}
            updates[k] = opt_update({k: grads[k]}, opt_init(one), one)[0][k]
    out = {"loss": value.item(), "aux": aux.item(), "routes": routes, "grads": grads, "updates": updates}
    if stages is None:
        out["stages"] = {k: v.cpu() for k, v in rec.items()}
    del params, loss, value, aux, rec
    return out


def expert_table(sel: torch.Tensor, cfg, cap: int) -> tuple:
    """(table (E, cap): the token in each expert's slot, -1 where empty;
    the dropped pairs) of one layer's `sel` (T, k), dispatched on the CPU."""
    e, slot = moe._dispatch_indices(sel.reshape(-1), cfg.n_experts, cap)
    tok = torch.arange(sel.numel()) // cfg.n_experts_per_token
    keep = slot < cap
    table = torch.full((cfg.n_experts, cap), -1, dtype=torch.int64)
    table[e[keep], slot[keep]] = tok[keep]
    return table, int((~keep).sum())


def moe_train_compare(dev, cfg, cap: int, card: dict, host: dict, tol: dict, sel_set: float,
                      gate_all: bool) -> tuple:
    """Card side against CPU side (`moe_train_side`'s results, the CPU's
    gradients and updates moved to the card): the routing per layer, the
    loss and aux loss, every gradient and update (the stacked expert
    leaves on the experts routed alike). Returns (the line's
    numbers, the failures: all of MOE_TRAIN_CHECK's limits with `gate_all`,
    else the finite values and the loss and aux limits)."""
    r, agree_rows, bad, routing_bad = route_compare(dev, cfg, cap, card["routes"], host["routes"], sel_set)
    grad_rel, update_rel, finite = {}, {}, math.isfinite(card["loss"]) and math.isfinite(card["aux"])
    for k, gp in host["grads"].items():  # both sides' leaves on the card
        m = EXPERT_LEAF.match(k)
        rows = agree_rows[int(m.group(1))].to(dev) if m else slice(None)
        gc, uc = card["grads"][k], card["updates"][k]
        finite = finite and bool(torch.isfinite(gc).all())
        grad_rel[k] = rel_norm(gc[rows], gp[rows])
        update_rel[k] = rel_norm(uc[rows], host["updates"][k][rows])
    r.update({"loss_card": card["loss"], "loss_cpu": host["loss"],
              "loss_rel": abs(card["loss"] - host["loss"]) / abs(host["loss"]),
              "aux_card": card["aux"], "aux_cpu": host["aux"],
              "aux_rel": abs(card["aux"] - host["aux"]) / abs(host["aux"]),
              "grad_rel_max": max(grad_rel.values()), "grad_rel_worst": max(grad_rel, key=grad_rel.get),
              "update_rel_max": max(update_rel.values()), "update_rel_worst": max(update_rel, key=update_rel.get),
              "finite": finite, "tolerance": tol, "gated": "all" if gate_all else "finite, loss, aux"})
    if r["grad_rel_max"] > tol["grad_rel"]:
        routing_bad.append(f"gradient of {r['grad_rel_worst']} differs by {r['grad_rel_max']}")
    if r["update_rel_max"] > tol["update_rel"]:
        routing_bad.append(f"update of {r['update_rel_worst']} differs by {r['update_rel_max']}")
    if not finite:
        bad.append("non-finite loss, aux loss or gradients on the card")
    if not r["loss_rel"] <= tol["loss_rel"]:
        bad.append(f"loss {card['loss']} on the card against {host['loss']}")
    if not r["aux_rel"] <= tol["loss_rel"]:
        bad.append(f"aux loss {card['aux']} on the card against {host['aux']}")
    return r, bad + (routing_bad if gate_all else [])


def route_compare(dev, cfg, cap: int, card_routes: dict, host_routes: dict, sel_set: float) -> tuple:
    """Each layer's routing, card against CPU ({layer: [the forward's sel,
    the recompute's]} on the CPU): (the line's numbers, the experts routed
    alike per layer (E,) bool, the failures that hold in every dtype (remat
    routing otherwise than the forward, the card's dispatch of its own sel
    otherwise than the CPU's), those that hold where routing is gated
    (routed experts agreeing below `sel_set`, other drops under the same
    routing))."""
    t = host_routes[0][0].shape[0]
    layers_out, agree_rows, bad, routing_bad = [], {}, [], []
    pos = inter = n = 0
    for i in range(cfg.n_layers):
        rc, rh = card_routes[i], host_routes[i]
        remat_alike = {side: len(r) == 2 and torch.equal(r[0], r[1]) for side, r in (("card", rc), ("cpu", rh))}
        sc, sh = rc[0], rh[0]
        pos += int((sc == sh).sum())
        ohc = torch.zeros(t, cfg.n_experts, dtype=torch.bool).scatter_(1, sc, True)
        ohh = torch.zeros(t, cfg.n_experts, dtype=torch.bool).scatter_(1, sh, True)
        inter += int((ohc & ohh).sum())
        n += sc.numel()
        (tc, dc), (th, dh) = expert_table(sc, cfg, cap), expert_table(sh, cfg, cap)
        rows = (tc == th).all(dim=1)
        agree_rows[i] = rows
        own = moe._dispatch_indices(sc.to(dev).reshape(-1), cfg.n_experts, cap)
        dispatch_alike = all(torch.equal(a.cpu(), b) for a, b in
                             zip(own, moe._dispatch_indices(sc.reshape(-1), cfg.n_experts, cap)))
        layers_out.append({"dropped_card": dc, "dropped_cpu": dh, "experts_left_out": int((~rows).sum()),
                           "routing_alike": bool(torch.equal(ohc, ohh)), "remat_routes_alike": remat_alike,
                           "card_dispatch_equals_cpu_dispatch": dispatch_alike})
        if not all(remat_alike.values()):
            bad.append(f"layer {i}'s recompute routes otherwise than its forward: {remat_alike}")
        if not dispatch_alike:
            bad.append(f"layer {i}'s dispatch on the card differs from the CPU's of the same sel")
        if torch.equal(ohc, ohh) and dc != dh:
            routing_bad.append(f"layer {i} routes alike but drops {dc} pairs on the card, {dh} on the CPU")
    r = {"sel_agreement": pos / n, "sel_set_agreement": inter / n, "capacity": cap,
         "pairs_per_layer": n // cfg.n_layers, "layers": layers_out, "sel_set_limit": sel_set}
    if r["sel_set_agreement"] < sel_set:
        routing_bad.append(f"routed experts agree at {r['sel_set_agreement']}")
    return r, agree_rows, bad, routing_bad


def check_moe_train_card_vs_cpu(dev, small: Optional[dict] = None) -> dict:
    """The moe phase's training check (a): qwen3-moe-30b-a3b at full width
    (or with the config fields `small` for a small check) and
    MOE_TRAIN_CHECK's layers trained
    one step on the card and on the CPU, float32 then bf16: the whole step,
    then stage by stage on the CPU's recorded stages, each held to
    MOE_TRAIN_CHECK and TRAIN_CHECK as its comment says. The CPU side runs
    first and keeps only its loss, aux, routes, gradients, updates and
    stages, the gradients and updates moved to the card; the card's are
    compared with them there, leaf by leaf."""
    c = MOE_TRAIN_CHECK
    base = dataclasses.replace(get_arch(c["arch"]).model, n_layers=c["layers"], **(small or {}))
    tree = params_to_numpy(init_params(base, seed=0, device=dev, param_dtype="float32"))
    tokens = np.random.default_rng(5).integers(0, base.vocab_size, (c["batch"], c["seq"] + 1)).astype(np.int32)
    cap = moe.capacity(c["batch"] * c["seq"], base)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        t0 = time.perf_counter()
        host = moe_train_side(params_from_numpy(tree, cfg, "cpu", param_dtype="float32"), cfg, tokens, c["lr"],
                              c["aux_weight"])
        for key in ("grads", "updates"):  # to the card, leaf by leaf: compared there
            host[key] = {k: host[key].pop(k).to(dev) for k in list(host[key])}
        t1 = time.perf_counter()
        model = params_from_numpy(tree, cfg, dev, param_dtype="float32")
        bad, out[dtype] = [], {}
        for form in ("whole", "staged"):
            t2 = time.perf_counter()
            card = moe_train_side(model, cfg, tokens, c["lr"], c["aux_weight"],
                                  host["stages"] if form == "staged" else None)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            card_s = time.perf_counter() - t2
            r, failed = moe_train_compare(dev, cfg, cap, card, host, TRAIN_CHECK[dtype], c["sel_set"],
                                          gate_all=form == "staged" or dtype == "float32")
            del card
            free_card()
            out[dtype][form] = r
            bad += [f"{dtype} {form}: {f}" for f in failed]
            emit({"phase": "moe", "path": "train_card_vs_cpu" + ("_staged" if form == "staged" else ""),
                  "arch": c["arch"], "dtype": dtype,
                  "config": {**{k: c[k] for k in ("layers", "batch", "seq", "lr")}, "d_model": cfg.d_model,
                             "experts": cfg.n_experts, "top_k": cfg.n_experts_per_token, "remat": cfg.remat},
                  **r, "cpu_s": t1 - t0, "card_s": card_s})
        del host, model
        free_card()
        if bad:
            raise AssertionError("card and CPU moe training disagree: " + "; ".join(bad))
    return out


def routed_drops(model, cfg, batch: dict) -> tuple:
    """One forward of `loss_fn` without gradients: (the dropped (token,
    choice) pairs per layer, the aux loss)."""
    with dropped_pairs(model, cfg) as drops, torch.no_grad():
        _, metrics = loss_fn(model, cfg, batch)
    return drops, metrics["aux"].item()


def run_moe_train(dev) -> dict:
    """The moe phase's training part (b): `launch.train.train` on
    qwen3-moe-30b-a3b at full width and MOE_TRAIN's depth, MOE_TRAIN's
    steps of 4 x 1,024 through B2's compressed feed, the launch counts set
    to 0 just before and read just after (B10's lse form twice a layer and
    step, B2 once a step, no other B10 form); then on a fresh model a warm,
    a timed and a profiled step (busy share, top kernels, device ms by
    torch op), and one forward without gradients for the aux loss and the
    dropped pairs per layer. Returns the train run's launches."""
    t = MOE_TRAIN
    full = get_arch(t["arch"]).model
    cfg = dataclasses.replace(full, n_layers=t["n_layers"])
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run = train(cfg, steps=t["steps"], batch=t["batch"], seq=t["seq"], device=dev, log_every=t["steps"])
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    train_s = time.perf_counter() - t0
    want = {"flash_attention_fwd_lse": 2 * cfg.n_layers * t["steps"], "unpack_blocks": t["steps"],
            "flash_attention_fwd_tc": 0, "flash_attention_fwd": 0, "flash_attention_fwd_lse_fma": 0}
    wrong = {k: launches[k] for k, n in want.items() if launches[k] != n}
    free_card()
    t1 = time.perf_counter()
    init_fn, train_step = make_train_step(cfg, AdamWConfig(lr=3e-4), device=dev)
    model, opt_state = init_fn(1)
    feed = CompressedFeed(zipf_token_stream(cfg.vocab_size, t["batch"], t["seq"], seed=1), device=dev).start()
    try:
        model, opt_state, _ = train_step(model, opt_state, feed.next_batch())
        b = feed.next_batch()
        torch.cuda.synchronize()
        ts = time.perf_counter()
        model, opt_state, _ = train_step(model, opt_state, b)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - ts) * 1e3
        b = feed.next_batch()
        busy, top, host_ops, top_ops = device_busy_ms(lambda: train_step(model, opt_state, b), top=12)
        drops, aux = routed_drops(model, cfg, b)
    finally:
        feed.stop()
    profiled_peak = torch.cuda.max_memory_allocated()
    del model, opt_state, b
    free_card()
    checks = {
        "steps": run.final_step == t["steps"] and len(run.losses) == t["steps"] and run.restarts == 0,
        "losses_finite": all(math.isfinite(x) for x in run.losses),
        "loss_fell": run.losses[-1] < run.losses[0],
        "launches": not wrong,
        "aux_finite_positive": math.isfinite(aux) and aux > 0,
    }
    tokens = t["batch"] * t["seq"]
    steady = sorted(run.step_s[1:])[len(run.step_s[1:]) // 2]
    emit({
        "phase": "moe", "path": "train", "arch": t["arch"], "n_layers": cfg.n_layers,
        "cut": f"{cfg.n_layers} of {full.n_layers} layers", "d_model": cfg.d_model, "params": cfg.param_count(),
        "experts": cfg.n_experts, "top_k": cfg.n_experts_per_token, "capacity": moe.capacity(tokens, cfg),
        "batch": t["batch"], "seq": t["seq"], "steps": t["steps"], "remat": cfg.remat, "dtype": cfg.dtype,
        "param_dtype": cfg.param_dtype, "losses": run.losses, "step_s": run.step_s, "wall_s": run.wall_s,
        "tokens_per_s": run.tokens_per_s, "steady_step_s": steady, "steady_tokens_per_s": tokens / steady,
        "feed_ratio": run.feed_ratio, "peak_memory_allocated": peak, "launches": launches,
        "launches_expected": want, "aux": aux, "dropped_pairs_per_layer": drops,
        "pairs_per_layer": tokens * cfg.n_experts_per_token, "checks": checks, "train_call_s": train_s,
    })
    emit({"phase": "moe", "path": "train_profiled_step", "timed_step_ms": step_ms, "device_busy_ms": busy,
          "busy_share": busy / step_ms if busy else None, "top_kernels_ms": top, "top_ops_ms": top_ops,
          "host_ops_per_step": host_ops, "peak_memory_allocated": profiled_peak,
          "seconds": time.perf_counter() - t1})
    if not all(checks.values()):
        raise AssertionError(f"the moe train path fails its checks: {checks}; launches off: {wrong}")
    return launches


#: the recurrent phase (ROADMAP A10 item 2: the ssm and hybrid families).
#: The card-vs-CPU check at full width and cut depth: mamba2-1.3b at 2 of
#: its 48 layers; recurrentgemma-9b at 5 of its 38 (one group, so one
#: local-attention layer on B10, and the two-layer tail: at 2 layers
#: `hybrid_pattern()` gives no group); 2 x 256 prompt tokens and 4 greedy
#: tokens, the same numpy weights (seed 0) and prompts on both, in bf16
#: (the configs' dtype) and in float32. The limits, each written before
#: the first run that read it and never loosened after one:
#:  * bf16 prefill logits within 3 % of the largest |logit| (LM_CHECK's:
#:    bf16 products summed in another order on the card, B10 against its
#:    dense plain version); every float tensor of the prefill's cache
#:    (ssm_state, the RG-LRU h, the conv tails, the ring's scales) within
#:    5 % of the CPU's in relative norm (the states integrate 256 positions
#:    of inputs that differ by bf16 steps; the tails are bf16 projections);
#:  * the first greedy token equal wherever the CPU's top-2 logit margin
#:    exceeds twice the logits' max error (LM_CHECK's rule), both dtypes;
#:  * bf16 ring codes: reported, not gated. The first run held them to
#:    LM_CHECK's 0.8 and failed at 0.7925 (k) and 0.7948 (v), with logits,
#:    states and tokens inside their limits: recurrentgemma's attention
#:    layer sits behind two RG-LRU sublayers and their SwiGLUs, whose bf16
#:    differences (its h 0.64 % apart in relative norm) move k by more
#:    than a bf16 step, and a 7-bit mu-law level is ~4.4 % wide. The codes
#:    are held in float32 instead, where the card's path differs from the
#:    CPU's by summation order alone (written before that pass's first
#:    run): logits within 1e-3 of the largest |logit|, every float tensor
#:    of the cache within 1e-3 in relative norm, ring codes equal at
#:    >= 0.999 (LM_CHECK's layer-0 limit)
RECURRENT_CHECK = dict(batch=2, prompt_len=256, gen=4,
                       layers={"mamba2-1.3b": 2, "recurrentgemma-9b": 5},
                       dtypes={"bfloat16": dict(logits_frac=0.03, state_rel=0.05, codes=None),
                               "float32": dict(logits_frac=1e-3, state_rel=1e-3, codes=0.999)})
RECURRENT_ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
#: the serving paths, full width and depth, weights from seed 0, NUQ cache
#: on: mamba2-1.3b (48 layers, 1.34 B parameters, 2.7 GB in bf16) at the lm
#: path's 4 x 2,048 + 32; recurrentgemma-9b (38 layers, 9.57 B, 19.1 GB) at
#: 2 x 4,096 + 32, twice its 2,048-key window, so its rings wrap and B10's
#: window bounds the keys
RECURRENT_PATHS = (
    dict(arch="mamba2-1.3b", batch=4, prompt_len=2048, gen=32),
    dict(arch="recurrentgemma-9b", batch=2, prompt_len=4096, gen=32),
)


def cache_leaves(cache: dict, prefix: str = "") -> dict:
    """{"groups/rec1/h": tensor, ...}: every tensor of a cache by path (a
    leaf held as shards gathered whole)."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(cache_leaves(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
        elif isinstance(v, Sharded):
            out[prefix + k] = v.gather()
    return out


def recurrent_side(model, cfg, prompts: torch.Tensor, gen: int, cache_len: Optional[int] = None,
                   mesh=None) -> tuple:
    """One side of the card-vs-CPU check: the prefill's logits and cache
    (on the CPU, shards gathered), then greedy decode steps (the serve
    step): (logits, leaves, tokens). With `mesh`, under it and MAP2: split
    over its model axis, every cache leaf held as shards."""
    ctx = contextlib.ExitStack()
    if mesh is not None:
        ctx.enter_context(partition.logical_axes(MAP2))
        ctx.enter_context(partition.set_mesh(mesh))
    with ctx, torch.inference_mode():
        cache, logits = prefill(model, cfg, prompts, cache_len or prompts.shape[1] + gen)
        if mesh is not None and not (tp_active(cfg) and all(
                isinstance(v, Sharded) and len(v.shards) == mesh.size for v in sharded_leaves(cache))):
            raise AssertionError(f"{cfg.name}: the cache on {mesh.shape} is not held as split shards")
        leaves = {k: v.cpu().clone() for k, v in cache_leaves(cache).items()}
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks = [tok]
        for _ in range(gen - 1):
            cache, tok = decode_greedy(model, cfg, cache, tok)
            toks.append(tok)
    return logits.float().cpu(), leaves, torch.cat(toks, dim=1).cpu().numpy()


def sharded_leaves(cache: dict) -> list:
    """Every leaf of a cache but `pos`, as it is held."""
    out = []
    for k, v in cache.items():
        if isinstance(v, dict):
            out.extend(sharded_leaves(v))
        elif k != "pos":
            out.append(v)
    return out


def check_recurrent_card_vs_cpu(dev, arch: str, dtype: str, spec: Optional[dict] = None) -> dict:
    """The recurrent phase's first part for `arch` in `dtype`: the same
    weights and prompts on the card and the CPU at full width and
    RECURRENT_CHECK's depth, held to its limits for that dtype. With
    `spec` (the tp_recurrent phase's (d)/(e)): both sides split over the
    same mesh shape (`spec["shape"]`, card slots against CPU slots), with
    a cache of `spec["check_cache_len"]` positions when given, every state
    and ring leaf gathered from its shards."""
    c = RECURRENT_CHECK
    lim = c["dtypes"][dtype]
    cfg = dataclasses.replace(get_arch(arch).model, n_layers=c["layers"][arch], dtype=dtype)
    tree = params_to_numpy(init_params(cfg, seed=0, device=dev))
    prompts = torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt_len"]),
                            generator=torch.Generator().manual_seed(5)).to(torch.int32)
    cache_len = (spec or {}).get("check_cache_len")
    sides, secs = {}, {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        model = params_from_numpy(tree, cfg, d)
        mesh = None if spec is None else card_mesh(spec["shape"], ("data", "model"), d)
        sides[name] = recurrent_side(model, cfg, prompts.to(d), c["gen"], cache_len, mesh)
        del model
        free_card()
        secs[name] = time.perf_counter() - t0
    del tree
    (lc, card, tok_c), (lp, cpu, tok_p) = sides["card"], sides["cpu"]
    scale = lp.abs().max().item()
    err = (lc - lp).abs().max().item()
    states, codes = {}, {}
    for k, b in cpu.items():
        a = card[k]
        if a.dtype == torch.uint8:
            codes[k] = (a == b).double().mean().item()
        else:
            states[k] = {"rel_norm": rel_norm(a.float(), b.float()),
                         "max_abs_err": (a.float() - b.float()).abs().max().item(),
                         "max_abs": b.float().abs().max().item()}
    top2 = lp[:, 0].topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    first = [bool(tok_c[i, 0] == tok_p[i, 0]) or margin[i] < 2 * err for i in range(c["batch"])]
    out = {"phase": "recurrent" if spec is None else spec["phase"], "path": "card_vs_cpu", "arch": arch,
           "dtype": dtype, "n_layers": cfg.n_layers, "d_model": cfg.d_model, "limits": lim,
           "mesh": None if spec is None else dict(zip(("data", "model"), spec["shape"])), "cache_len": cache_len,
           "prefill_logits_max_abs_err": err, "max_abs_logit": scale,
           "states": states, "code_agreement": codes, "tokens_card": tok_c.tolist(), "tokens_cpu": tok_p.tolist(),
           "token_agreement": float((tok_c == tok_p).mean()), "top2_margin_cpu": margin,
           "finite": bool(torch.isfinite(lc).all()), "card_s": secs["card"], "cpu_s": secs["cpu"]}
    emit(out)
    bad = []
    if not out["finite"] or err > lim["logits_frac"] * scale:
        bad.append(f"prefill logits differ by {err} (max |logit| {scale})")
    bad += [f"{k} {r}" for k, r in states.items() if not r["rel_norm"] <= lim["state_rel"]]
    if lim["codes"] is not None:
        bad += [f"{k} agreement {r}" for k, r in codes.items() if r < lim["codes"]]
        if cfg.family == "hybrid" and not codes:
            bad.append("no ring codes to compare")
    if not all(first):
        bad.append(f"first tokens differ where the margin is clear: {margin}")
    if bad:
        raise AssertionError(f"{arch} ({dtype}): card and CPU serving disagree: " + "; ".join(bad))
    return out


def time_flash_dh256(dev, model, prompts, cycles_per_ms: float) -> dict:
    """B10's head-dim-256 instance on the recurrentgemma path's first
    local-attention layer (group 0's q, k, v: 2 x 4,096, 16 query heads over
    1 of 256, window 2,048), with its plain version and torch's
    scaled_dot_product_attention on the same inputs (k and v repeated to
    the 16 heads): the memory-efficient backend with the window as a mask
    (the same function: `library_ms`), and the flash backend, which takes
    no mask, causal over all keys (`library_flash_causal_ms`, more pairs
    than the window's). Bound as `time_flash`'s: the band's operations at
    the bf16 tensor-core peak against q, k, v, o at the memory rate."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    cfg = model.cfg
    b, s = prompts.shape
    with torch.inference_mode():
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        attn, h = first_attention(model, cfg, prompts)
        q, k, v = (t.contiguous() for t in layers.attention_qkv(attn.params(), cfg, h, pos))
        window = cfg.local_window
        g = cfg.n_heads // cfg.n_kv_heads
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)))
        qp = torch.arange(s, device=dev)
        mask = (qp[None, :] <= qp[:, None]) & (qp[None, :] > qp[:, None] - window)

        def kern():
            return ops.flash_attention_fwd(q, k, v, window=window)

        def plain():
            return ref.flash_reference(q, k, v, window=window)

        def library():
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        def library_flash_causal():
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        before = ops.launch_counts()["flash_attention_fwd_tc"]
        got, want = kern(), plain()
        if ops.launch_counts()["flash_attention_fwd_tc"] != before + 1:
            raise AssertionError("the recurrentgemma-shape call did not run the tensor-core kernel")
        ok, tol = flash_within(got, want)
        err = (got.float() - want.float()).abs().max().item()
        if not (ok and bool(torch.isfinite(got).all())):
            raise AssertionError(f"B10's Dh 256 instance disagrees with its plain version: {err}")
        ms, host_ms = time_ms(kern, 20, cycles_per_ms)
        plain_ms, plain_host_ms = time_ms(plain, 3, cycles_per_ms)
        lib = {}
        for key, fn in (("library", library), ("library_flash_causal", library_flash_causal)):
            try:
                lib[key + "_max_abs_err"] = (fn().transpose(1, 2).float() - want.float()).abs().max().item()
                lib[key + "_ms"] = time_ms(fn, 20, cycles_per_ms)[0]
            except RuntimeError as exc:  # a backend that refuses these inputs: recorded, not timed
                lib[key + "_ms"], lib[key + "_refused"] = None, str(exc).splitlines()[0][:200]
    nops = flash_attn.flops(b, s, s, cfg.n_heads, cfg.head_dim, window, True)
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / BF16_TENSOR_OPS_PER_S * 1e3
    bound_ms, bound_by = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": nops, "chain_steps": None, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
            "max_abs_err": err, "tolerance": tol, "dtype": str(q.dtype),
            "shape": [b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim], "window": window,
            "tflops": nops / (ms * 1e-3) / 1e12, **lib}


def run_recurrent_path(dev, spec: dict) -> tuple:
    """One recurrent config served at full width and depth through
    `serve()` as run_lm serves the lm path (launches: B10's tensor-core
    kernel once a local-attention layer, none for mamba2; busy shares, host
    ops per step), with its cache split into ring and state bytes; for
    recurrentgemma the ring check over its wrapped window and B10's Dh 256
    instance timed on its inputs. Frees the model. Returns (launches, the
    timing dict or None)."""
    t0 = time.perf_counter()
    launches, model, prompts = run_lm(dev, spec["arch"], spec["batch"], spec["prompt_len"], spec["gen"],
                                      phase="recurrent", path=spec["arch"])
    cfg = model.cfg
    shapes = cache_leaves(init_decode_cache(cfg, spec["batch"], spec["prompt_len"] + spec["gen"], "meta"))
    ring = {k for k in shapes if k.startswith("groups/attn/")}
    nbytes = {k: t.numel() * t.element_size() for k, t in shapes.items()}
    line = {"phase": "recurrent", "path": spec["arch"], "n_layers": cfg.n_layers,
            "attention_layers": attention_layers(cfg), "tc_launches": launches["flash_attention_fwd_tc"],
            "ring_bytes": sum(n for k, n in nbytes.items() if k in ring),
            "state_bytes": sum(n for k, n in nbytes.items() if k not in ring)}
    timing, checks = None, {}
    if cfg.family == "hybrid":
        with torch.inference_mode():
            cache, logits = prefill(model, cfg, prompts, spec["prompt_len"] + spec["gen"])
            checks = check_ring_wrap(model, cfg, prompts, cache, logits)
            del cache, logits
        line["ring"] = checks
        timing = time_flash_dh256(dev, model, prompts, sleep_cycles_per_ms())
        line["flash_dh256"] = {k: v for k, v in timing.items() if k != "max_abs_err"}
    line["seconds"] = time.perf_counter() - t0
    emit(line)
    if not all(checks.values()):
        raise AssertionError(f"{spec['arch']}: the ring fails its checks: {checks}")
    del model, prompts
    free_card()
    return launches, timing


def run_recurrent(dev) -> tuple:
    """The recurrent phase (the Dh > 128 flash cases ran in the flash
    phase): card against CPU for both configs, then both served at full
    width and depth. Returns (the serving paths' launches, the Dh 256
    instance's launches, its timing)."""
    free_card()
    if torch.cuda.memory_allocated() >= MOE_START_BYTES:
        raise AssertionError(f"{torch.cuda.memory_allocated()} bytes still allocated before the recurrent phase")
    t0 = time.perf_counter()
    for arch in RECURRENT_ARCHS:
        for dtype in RECURRENT_CHECK["dtypes"]:
            check_recurrent_card_vs_cpu(dev, arch, dtype)
    emit({"phase": "recurrent", "path": "card_vs_cpu", "seconds": time.perf_counter() - t0})
    launches = {k: 0 for k in KERNELS}
    dh256, timing = 0, None
    for spec in RECURRENT_PATHS:
        got, t = run_recurrent_path(dev, spec)
        for k, n in got.items():
            launches[k] += n
        if t is not None:
            dh256, timing = got["flash_attention_fwd_tc"], t
    return launches, dh256, timing


#: the frontends phase (ROADMAP A10 items 3 and 4: the embedding front ends
#: and attention logit softcaps). Its flash cases: musicgen-large's prefill
#: shape is one of FLASH_CASES (FRONTEND_FLASH_CASES); CAP_FLASH_CASES hold
#: B10 with a logit softcap on both
#: kernels and in both forms, each against the capped plain version within
#: the flash phase's unchanged tolerances, and each asserting that the cap
#: moves some output (and some lse) by more than 100x its tolerance: caps of
#: 0.5-2 on scaled scores of order 1, so that a kernel that ignored the cap
#: would fail. (B, Sq, Sk, H, K, Dh, window, causal, dtype, softcap)
CAP_FLASH_CASES = (
    (4, 2048, 2048, 32, 32, 64, None, True, torch.bfloat16, 1.0),  # musicgen's shape
    (2, 700, 700, 8, 4, 64, 96, True, torch.bfloat16, 2.0),  # windowed: leading tiles masked
    (2, 333, 250, 8, 2, 128, None, True, torch.bfloat16, 1.5),  # ragged, Sk < Sq
    (1, 200, 300, 8, 2, 128, 40, True, torch.bfloat16, 1.0),  # Sk > Sq, windowed
    (2, 512, 512, 16, 8, 128, None, True, torch.bfloat16, 1.0),  # Dh 128, G 2
    (1, 333, 400, 8, 2, 256, 100, True, torch.bfloat16, 2.0),  # Dh 256, ragged, windowed
    (1, 190, 190, 4, 2, 128, None, False, torch.bfloat16, 0.5),  # not causal
    (2, 300, 300, 8, 2, 64, 50, True, torch.float32, 1.0),  # float32: the FMA kernel
    (1, 600, 600, 4, 1, 256, 256, True, torch.float32, 2.0),  # float32 at Dh 256
    (1, 200, 200, 4, 2, 40, None, True, torch.bfloat16, 1.0),  # Dh 40: the FMA kernel in bf16
)
#: the kernels line's row of the tensor-core kernel's capped instances
#: (`kCap`): the same wrapper and counter as `flash_attention_fwd_tc`; its
#: launches are the capped serving path's, its times at musicgen's shape
SOFTCAP = "flash_attention_fwd_tc_softcap"
#: the cap of that timing: Gemma 2's attention logit cap (the time does not
#: depend on the value: every score of the band takes one tanhf)
TIMED_SOFTCAP = 50.0
FRONTEND_ARCHS = ("musicgen-large", "pixtral-12b")
#: the card-vs-CPU check of both configs at full width and 2 layers, 2 x 256
#: front-end prompts (seeded codes or patches through the stubs) + 4
#: generated, in bf16 and in float32. Limits, written before the first run:
#: bf16 holds LM_CHECK's (both backbones are dense decoders like
#: qwen3-1.7b's); float32 differs by summation order alone: logits within
#: 1e-3 of the largest |logit|, ring codes equal at >= 0.999 in every
#: layer (RECURRENT_CHECK's float32 limits). The codes are compared over
#: the slots fed the same tokens on both sides (MOE_CHECK's rule), since an
#: embeddings model is fed its greedy tokens' rows
FRONTEND_CHECK = {
    "bfloat16": dict(LM_CHECK, dtype="bfloat16", codes_over_slots_fed_alike=True),
    "float32": dict(LM_CHECK, dtype="float32", logits_frac=1e-3, codes_all=0.999,
                    codes_over_slots_fed_alike=True),
}
#: the capped model: qwen3-1.7b's reduced config (3 layers, d_model 128, 4
#: query heads over 2 of 32) with a logit softcap of 1.0 (its normed q and k
#: give scaled scores of order 1, so the cap bends most of them), served on
#: the card and the CPU from the same numpy weights and prompts, 2 x 64 + 4,
#: in bf16 (the tensor-core kernel) and float32 (the FMA kernel), and one
#: float32 `make_train_step` step of 2 x 64 tokens (B10's FMA lse form and
#: the capped flash backward). Limits, written before the first run:
#: prefill logits as FRONTEND_CHECK's (bf16 3 %, float32 1e-3 of the largest
#: |logit|); the uncapped model's float32 logits more than 100x that limit
#: from the capped CPU's; gradients, loss and the step's updates as
#: TRAIN_CHECK's float32 limits
SOFTCAP_CHECK = dict(cap=1.0, batch=2, prompt_len=64, gen=4, seq=64, lr=1e-3)
#: the serving paths, weights from seed 0, NUQ cache on: musicgen-large at
#: full width and 24 of its 48 layers (3.23 B parameters, 6.5 GB in bf16 at
#: 48; cut for the script's time, DENSE_PATH), 4 x 2,048 frame embeddings +
#: 32 generated; pixtral-12b at full width cut to 10 of its 40 layers (for
#: time: its decoder is mistral-nemo-12b's, which the moe phase serves too),
#: 4 x 2,048 patch embeddings + 8
FRONTEND_PATHS = (
    dict(arch="musicgen-large", batch=4, prompt_len=2048, gen=32, n_layers=24),
    dict(arch="pixtral-12b", batch=4, prompt_len=2048, gen=8, n_layers=10),
)


def frontend_prompts(arch: str, d_model: int, batch: int, prompt_len: int, d, seed: int) -> torch.Tensor:
    """(batch, prompt_len, d_model) bf16 prompts from `arch`'s front-end
    stub (`models/frontends.py`), drawn on device `d` from `seed`:
    musicgen-large's EnCodec codes (4 codebooks of 2,048) through the
    codebook sum; pixtral-12b's 16 x 16 RGB patches (N(0, 1) pixels)
    through the patch projection."""
    gen = torch.Generator(device=d).manual_seed(seed)
    if arch == "musicgen-large":
        p = frontends.init_audio_frontend(frontends.AUDIO_CODEBOOKS, frontends.AUDIO_CODEBOOK_SIZE, d_model,
                                          generator=gen, device=d)
        codes = torch.randint(0, frontends.AUDIO_CODEBOOK_SIZE, (batch, prompt_len, frontends.AUDIO_CODEBOOKS),
                              generator=gen, device=d)
        x = frontends.audio_frames_to_embeddings(p, codes)
    else:
        p = frontends.init_vision_frontend(frontends.VISION_PATCH_DIM, d_model, generator=gen, device=d)
        patches = torch.randn((batch, prompt_len, frontends.VISION_PATCH_DIM), generator=gen, device=d)
        x = frontends.patches_to_embeddings(p, patches)
    return x.to(torch.bfloat16)


def flash_rule(want: torch.Tensor) -> torch.Tensor:
    """`flash_within`'s elementwise tolerance: one bf16 step, or 2e-4 +
    2e-4 |plain| in float32."""
    w = want.float().abs()
    return w * 2.0**-7 + 1e-6 if want.dtype == torch.bfloat16 else FLASH_F32_TOL + FLASH_F32_TOL * w


def check_flash_capped(dev) -> dict:
    """B10 with a logit softcap on every CAP_FLASH_CASES case, both forms
    (one launch each, on the kernel `kernel_for` picks and its lse form):
    out within `flash_within`'s tolerance of the capped plain version, the
    lse form's out the plain form's, lse within LSE_TOL; the uncapped plain
    version's out and lse more than 100x those tolerances away somewhere.
    Returns the largest max-abs error of out for each kernel form, and
    under SOFTCAP that of the tensor-core cases."""
    gen = torch.Generator(device=dev).manual_seed(23)
    worst = {k: 0.0 for k in (*LM_KERNELS, SOFTCAP)}
    atol, rtol = LSE_TOL
    for case in CAP_FLASH_CASES:
        b, sq, sk, h, kh, dh, window, causal, dt, cap = case
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((b, sq, h, dh), (b, sk, kh, dh), (b, sk, kh, dh)))
        expected = flash_attn.kernel_for(dt, dh, h // kh)
        before = ops.launch_counts()
        got = ops.flash_attention_fwd(q, k, v, window=window, causal=causal, softcap=cap)
        got_lse, lse = ops.flash_attention_fwd_lse(q, k, v, window=window, causal=causal, softcap=cap)
        after = ops.launch_counts()
        ran = {n: after[n] - before[n] for n in LM_KERNELS if after[n] != before[n]}
        want, want_lse = ref.flash_reference_lse(q, k, v, window=window, causal=causal, softcap=cap)
        free, free_lse = ref.flash_reference_lse(q, k, v, window=window, causal=causal)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ok, tol = flash_within(got, want)
        lse_d = (lse - want_lse).abs()
        lse_tol = atol + rtol * want_lse.abs()
        checks = {
            "kernels": ran == {expected: 1, LSE_FORM[expected]: 1},
            "within": ok, "finite": bool(torch.isfinite(got.float()).all()),
            "lse_out_bit_identical": torch.equal(got, got_lse), "lse_within": bool((lse_d <= lse_tol).all()),
            "cap_moves_out": bool(((free.float() - want.float()).abs() > 100 * flash_rule(want)).any()),
            "cap_moves_lse": bool(((free_lse - want_lse).abs() > 100 * lse_tol).any()),
        }
        emit({"phase": "frontends", "path": "flash_softcap",
              "case": {"B": b, "Sq": sq, "Sk": sk, "H": h, "K": kh, "Dh": dh, "window": window,
                       "causal": causal, "dtype": str(dt), "softcap": cap},
              "kernel": sorted(ran), "max_abs_err": err, "tolerance": tol, "lse_max_abs_err": lse_d.max().item(),
              "lse_tolerance": "|d| <= 1e-4 + 1e-5 |plain|",
              "uncapped_max_abs_diff": (free.float() - want.float()).abs().max().item(), "checks": checks})
        if not all(checks.values()):
            raise AssertionError(f"B10 with softcap {cap} ({expected}) fails at {case}: {checks}")
        for form in (expected, LSE_FORM[expected]):
            worst[form] = max(worst[form], err)
        if expected == flash_attn.TENSOR_CORE:
            worst[SOFTCAP] = max(worst[SOFTCAP], err)
        del q, k, v, got, got_lse, want, free
    return worst


def serve_capped(dev, cfg, tree: dict, prompts: torch.Tensor, d) -> tuple:
    """One side of the capped serving check on device `d`: (prefill
    logits on the CPU, tokens, this side's B10 launches)."""
    before = ops.launch_counts()
    run = serve(cfg, batch=prompts.shape[0], prompt_len=prompts.shape[1], gen=SOFTCAP_CHECK["gen"], device=d,
                params=tree, prompts=prompts)
    after = ops.launch_counts()
    return (run.prefill_logits.float().cpu(), run.tokens,
            {n: after[n] - before[n] for n in LM_KERNELS if after[n] != before[n]})


def check_softcap_card_vs_cpu(dev) -> int:
    """The capped model (SOFTCAP_CHECK) served on the card and the CPU in
    bf16 and float32, B10's kernel once a layer on the card (the
    tensor-core kernel in bf16, the FMA kernel in float32; counts set to 0
    just before the card's run and read just after), the uncapped model's
    logits set apart; then one float32 `make_train_step` step on each,
    gradients (`loss_fn` and autograd on the same weights), loss and the
    step's updates compared. Returns the bf16 serve's tensor-core launches
    (the capped instance's)."""
    c = SOFTCAP_CHECK
    base = get_arch(LM_ARCH).model
    prompts = torch.randint(0, base.reduced().vocab_size, (c["batch"], c["prompt_len"]),
                            generator=torch.Generator().manual_seed(7)).to(torch.int32)
    tc_launches, bad = 0, []
    for dtype, kernel in (("bfloat16", flash_attn.TENSOR_CORE), ("float32", flash_attn.FMA)):
        cfg = base.reduced(dtype=dtype, attn_logit_softcap=c["cap"])
        frac = FRONTEND_CHECK[dtype]["logits_frac"]
        tree = params_to_numpy(init_params(cfg, seed=0, device="cpu"))
        ops.reset_launches()
        card_logits, card_tokens, ran = serve_capped(dev, cfg, tree, prompts.to(dev), dev)
        cpu_logits, cpu_tokens, _ = serve_capped(dev, cfg, tree, prompts, "cpu")
        free_logits = serve_capped(dev, dataclasses.replace(cfg, attn_logit_softcap=None), tree, prompts, "cpu")[0]
        scale = cpu_logits.abs().max().item()
        err = (card_logits - cpu_logits).abs().max().item()
        top2 = cpu_logits[:, 0].topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        r = {"kernels": ran, "prefill_logits_max_abs_err": err, "max_abs_logit": scale, "limit_frac": frac,
             "uncapped_max_abs_diff": (free_logits - cpu_logits).abs().max().item(),
             "tokens_card": card_tokens.tolist(), "tokens_cpu": cpu_tokens.tolist()}
        emit({"phase": "frontends", "path": "softcap_serve_card_vs_cpu", "dtype": dtype, "softcap": c["cap"], **r})
        if ran != {kernel: cfg.n_layers}:
            bad.append(f"{dtype}: B10 launched {ran}, expected {kernel} x {cfg.n_layers}")
        if not (bool(torch.isfinite(card_logits).all()) and err <= frac * scale):
            bad.append(f"{dtype}: prefill logits differ by {err} (max |logit| {scale})")
        if not all(card_tokens[i, 0] == cpu_tokens[i, 0] or margin[i] < 2 * err for i in range(c["batch"])):
            bad.append(f"{dtype}: first tokens differ where the margin is clear: {margin}")
        if dtype == "float32" and not r["uncapped_max_abs_diff"] > 100 * frac * scale:
            bad.append(f"the cap moves the logits by {r['uncapped_max_abs_diff']} only")
        if dtype == "bfloat16":
            tc_launches = ran.get(kernel, 0)
    cfg = base.reduced(dtype="float32", attn_logit_softcap=c["cap"])
    tree = params_to_numpy(init_params(cfg, seed=0, device="cpu", param_dtype="float32"))
    tokens = np.random.default_rng(9).integers(0, cfg.vocab_size, (c["batch"], c["seq"] + 1)).astype(np.int32)
    batch = {"inputs": tokens[:, :-1], "labels": tokens[:, 1:]}
    opt = AdamWConfig(lr=c["lr"], clip_norm=None)
    got = []
    for d in (dev, torch.device("cpu")):
        model = params_from_numpy(tree, cfg, d, param_dtype="float32")
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss_fn(model, cfg, b)[0], list(params.values()))
        before = {k: p.detach().clone() for k, p in params.items()}
        _, step = make_train_step(cfg, opt, device=d)
        ops.reset_launches()
        _, _, m = step(model, adamw(opt)[0](params), b)
        ran = {n: v for n, v in ops.launch_counts().items() if v}
        got.append((float(m["loss"]), {k: g.float().cpu() for k, g in zip(params, grads)},
                    {k: (p.detach() - before[k]).float().cpu() for k, p in params.items()}, ran))
    (lc, gc, uc, ran), (lp, gp, up, _) = got
    tol = TRAIN_CHECK["float32"]
    grad_rel = {k: rel_norm(gc[k], gp[k]) for k in gp}
    update_rel = {k: rel_norm(uc[k], up[k]) for k in up}
    r = {"kernels": ran, "loss_card": lc, "loss_cpu": lp, "loss_rel": abs(lc - lp) / abs(lp),
         "grad_rel_max": max(grad_rel.values()), "update_rel_max": max(update_rel.values()), "tolerance": tol}
    emit({"phase": "frontends", "path": "softcap_train_card_vs_cpu", "softcap": c["cap"], **r})
    if ran != {"flash_attention_fwd_lse_fma": cfg.n_layers}:
        bad.append(f"the train step launched {ran}, expected the FMA lse form x {cfg.n_layers}")
    if not (math.isfinite(lc) and r["loss_rel"] <= tol["loss_rel"] and r["grad_rel_max"] <= tol["grad_rel"]
            and r["update_rel_max"] <= tol["update_rel"]):
        bad.append(f"capped training differs: {r}")
    if bad:
        raise AssertionError("the capped model on the card and the CPU disagree: " + "; ".join(bad))
    return tc_launches


def time_flash_frontends(dev, model, prompts, cycles_per_ms: float) -> dict:
    """B10's tensor-core kernel on the musicgen path's layer-0 q, k, v (4 x
    2,048, 32 query heads over 32 of 64, causal) without a cap and with
    TIMED_SOFTCAP, timed in turns (uncapped, capped, capped, uncapped), each
    beside its plain version; torch's scaled_dot_product_attention (causal,
    no cap: it has none) on the same inputs. Bound as `time_flash`'s: the
    band's operations at the bf16 tensor-core peak against q, k, v, o at
    the memory rate (the cap adds one tanhf a score outside the tensor
    cores). Returns {"dh64": ..., SOFTCAP: ...}."""
    cfg = model.cfg
    b, s = prompts.shape[:2]
    with torch.inference_mode():
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        attn, x = first_attention(model, cfg, prompts)
        q, k, v = (t.contiguous() for t in layers.attention_qkv(attn.params(), cfg, x, pos))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nops = flash_attn.flops(b, s, s, cfg.n_heads, cfg.head_dim, None, True)
    nbytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / BF16_TENSOR_OPS_PER_S * 1e3
    bound_ms, bound_by = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
    out, runs = {}, {"dh64": [], SOFTCAP: []}
    fns = {}
    for name, cap in (("dh64", None), (SOFTCAP, TIMED_SOFTCAP)):
        def kern(cap=cap):
            return ops.flash_attention_fwd(q, k, v, softcap=cap)

        def plain(cap=cap):
            return ref.flash_reference(q, k, v, softcap=cap)

        before = ops.launch_counts()["flash_attention_fwd_tc"]
        got, want = kern(), plain()
        if ops.launch_counts()["flash_attention_fwd_tc"] != before + 1:
            raise AssertionError("the musicgen-shape call did not run the tensor-core kernel")
        ok, tol = flash_within(got, want)
        err = (got.float() - want.float()).abs().max().item()
        if not (ok and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"B10 (softcap {cap}) disagrees with its plain version at musicgen's shape: {err}")
        plain_ms, plain_host_ms = time_ms(plain, 5, cycles_per_ms)
        fns[name] = kern
        out[name] = {"plain_ms": plain_ms, "plain_host_ms": plain_host_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bytes": nbytes, "ops": nops, "chain_steps": None,
                     "max_abs_err": err, "tolerance": tol, "softcap": cap, "dtype": str(q.dtype),
                     "shape": [b, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim]}
        del got, want
    for name in ("dh64", SOFTCAP, SOFTCAP, "dh64"):
        runs[name].append(time_ms(fns[name], 50, cycles_per_ms))
    for name, r in runs.items():
        out[name].update({"ms": sum(t[0] for t in r) / len(r), "ms_runs": [t[0] for t in r],
                          "host_ms": sum(t[1] for t in r) / len(r)})
        out[name]["tflops"] = nops / (out[name]["ms"] * 1e-3) / 1e12

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    with torch.inference_mode():
        lib_err = (library().transpose(1, 2).float() - ref.flash_reference(q, k, v).float()).abs().max().item()
    out["dh64"].update({"library_ms": time_ms(library, 50, cycles_per_ms)[0], "library_max_abs_err": lib_err})
    out[SOFTCAP].update({"library_ms": None, "uncapped_ms": out["dh64"]["ms"],
                         "capped_over_uncapped": out[SOFTCAP]["ms"] / out["dh64"]["ms"]})
    return out


def run_frontends(dev) -> tuple:
    """The frontends phase, on a card the recurrent phase's models have
    left: B10 with a cap (CAP_FLASH_CASES), card against CPU for both
    configs in both dtypes and for the capped model, then both configs
    served through `serve()` as run_lm serves the lm path (launches: B10's
    tensor-core kernel once a layer, its FMA kernel never), musicgen's
    B10 timed with and without a cap. Returns (the serving paths'
    launches, the capped flash cases' worst errors, the capped serving
    path's tensor-core launches, the timing dict)."""
    free_card()
    if torch.cuda.memory_allocated() >= MOE_START_BYTES:
        raise AssertionError(f"{torch.cuda.memory_allocated()} bytes still allocated before the frontends phase")
    t0 = time.perf_counter()
    worst = check_flash_capped(dev)
    emit({"phase": "frontends", "path": "flash_softcap", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    for arch in FRONTEND_ARCHS:
        for check in FRONTEND_CHECK.values():
            check_lm_card_vs_cpu(dev, arch, check, phase="frontends", init_device=dev)
            free_card()
    emit({"phase": "frontends", "path": "card_vs_cpu", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    capped_launches = check_softcap_card_vs_cpu(dev)
    emit({"phase": "frontends", "path": "softcap_card_vs_cpu", "seconds": time.perf_counter() - t0})
    launches = {k: 0 for k in KERNELS}
    timing = None
    for spec in FRONTEND_PATHS:
        t0 = time.perf_counter()
        got, model, prompts = run_lm(dev, spec["arch"], spec["batch"], spec["prompt_len"], spec["gen"],
                                     spec["n_layers"], phase="frontends", path=spec["arch"])
        for k, n in got.items():
            launches[k] += n
        line = {"phase": "frontends", "path": spec["arch"], "n_layers": model.cfg.n_layers,
                "cut": None if spec["n_layers"] is None else
                f"{spec['n_layers']} of {get_arch(spec['arch']).model.n_layers} layers",
                "tc_launches": got["flash_attention_fwd_tc"]}
        if spec["arch"] == "musicgen-large":
            timing = time_flash_frontends(dev, model, prompts, sleep_cycles_per_ms())
            line["flash"] = {name: {k: v for k, v in t.items() if k != "max_abs_err"} for name, t in timing.items()}
        line["seconds"] = time.perf_counter() - t0
        emit(line)
        del model, prompts
        free_card()
    return launches, worst, capped_launches, timing

#: the mesh phase (ROADMAP A10 item 5, first half): the mesh machinery on
#: the card, every slot of each mesh on the one H100 (`cuda:0`), so no
#: collective crosses a link; each path held card against CPU on the same
#: mesh (the CPU's slots all `cpu`) at full width and 2 layers first.
#:  (a) data-parallel training: qwen3-1.7b at full width and depth on a
#:      (pod 2, data 1, model 1) mesh, masters and moments sharded by
#:      `param_specs(cfg, "train")`, the compressed pod sync
#:      (`GradCompressionConfig()`), 3 steps of the train cell's 4 x 1,024
#:      through the B2 feed;
#:  (b) distributed-LSE decode: qwen3-1.7b on a (data 1, model 4) mesh; its
#:      compute is split over the model axis now, so it runs as the tp
#:      phase's (a);
#:  (c) per-shard moe prefill: qwen3-moe-30b-a3b at full width and 4 of its
#:      48 layers (cut for the script's time), 4 x 2,048 + 4 on a (data 4,
#:      model 1) mesh.
#: The card-vs-CPU limits are the ones the earlier phases hold one device
#: to: (a) TRAIN_CHECK's, in float32 and in bf16, on the loss, on each
#: leaf's merged gradient (AdamW's first moment after the one step,
#: (1 - b1) g of the synced, clipped gradient, gathered whole) and on each
#: parameter's update, in relative norm; (b) LM_CHECK; (c)
#: MOE_CHECK["serve"] (LM_CHECK, codes over the slots fed alike).
MAP3 = {"data": ("pod", "data"), "model": "model"}
MAP2 = {"data": "data", "model": "model"}
MESH_TRAIN = dict(shape=(2, 1, 1), names=("pod", "data", "model"), steps=3, batch=TRAIN_BATCH, seq=TRAIN_SEQ)
MESH_MOE = dict(arch="qwen3-moe-30b-a3b", shape=(4, 1), batch=4, prompt_len=2048, gen=4, n_layers=4,
                check=dict(MOE_CHECK["serve"], batch=4))
MESH_KERNELS = ("flash_attention_fwd_lse", "flash_attention_fwd_tc", "flash_attention_fwd",
                "flash_attention_fwd_lse_fma", "unpack_blocks")


def card_mesh(shape, names, dev) -> "DeviceMesh":
    """A mesh of `shape` whose every slot is `dev` (one card, or the CPU)."""
    return make_mesh(shape, names, devices=[dev] * math.prod(shape))


#: B10's wrappers, whose launches `slot_launches` buckets by slot (they
#: count on `ops.WRAPPERS`, so a module attribute may wrap them; B2's count
#: on their own name, and run in the feed's thread, outside any slot)
SLOT_COUNTED = ("flash_attention_fwd_lse", "flash_attention_fwd_tc", "flash_attention_fwd",
                "flash_attention_fwd_lse_fma")


@contextlib.contextmanager
def slot_launches(keep: Optional[dict] = None, dims: Optional[dict] = None):
    """Each call of B10's wrappers made inside the block, its launches
    bucketed by the slot program it ran under (`"whole"` outside one). The
    wrappers' own counts are untouched. With `dims`, the launches are also
    counted there by kernel and head dim ({"<kernel>/<Dh>": n}); with
    `keep`, the first launching call's q, k, v (copies) and keywords in
    slot 0 are kept there by kernel."""
    buckets: dict = {}
    originals = {n: getattr(ops, n) for n in SLOT_COUNTED}

    def wrap(fn):
        def inner(*a, **kw):
            before = ops.launch_counts()
            out = fn(*a, **kw)
            after = ops.launch_counts()
            prog = partition.current_slot()
            slot = "whole" if prog is None else prog.slot
            b = buckets.setdefault(slot, {})
            for k in MESH_KERNELS:
                if after[k] != before[k]:
                    b[k] = b.get(k, 0) + after[k] - before[k]
                    if dims is not None:
                        key = f"{k}/{a[0].shape[-1]}"
                        dims[key] = dims.get(key, 0) + after[k] - before[k]
                    if keep is not None and slot == 0 and k not in keep:
                        keep[k] = (tuple(t.detach().clone() for t in a[:3]), dict(kw))
            return out
        return inner

    for n, fn in originals.items():
        setattr(ops, n, wrap(fn))
    try:
        yield buckets
    finally:
        for n, fn in originals.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def sync_inputs():
    """The calls to the compressed sync in the block: a list of (trees,
    arguments), `trees` the gradient tree of each slot of the sync's mesh
    (under tensor parallelism of each data shard) on the CPU in its dtype,
    `arguments` the call's other arguments by name. Every tree holds the
    global mean there (`steps._mesh_train_step`)."""
    import inspect

    from repro_torch.core import gradient as gradmod

    seen, orig = [], gradmod.compressed_grad_sync
    sig = inspect.signature(orig)

    def record(grads, *a, **kw):
        args = sig.bind(grads, *a, **kw).arguments
        trees = [grads] if isinstance(grads, dict) else list(grads)
        seen.append(([{k: v.detach().cpu() for k, v in t.items()} for t in trees],
                     {k: v for k, v in args.items() if k != "grads"}))
        return orig(grads, *a, **kw)

    gradmod.compressed_grad_sync = record
    try:
        yield seen
    finally:
        gradmod.compressed_grad_sync = orig


def replay_sync(call: tuple, name: str) -> torch.Tensor:
    """The sync's output for leaf `name` recomputed on the CPU from a
    recorded call (`sync_inputs`): the CPU's quantize and dequantize of the
    trees that call was given, float32."""
    from repro_torch.core import gradient as gradmod
    from repro_torch.runtime.elastic import DeviceMesh

    trees, args = call
    mesh, specs = args["mesh"], args.get("param_specs")
    kw = {**args, "mesh": DeviceMesh((torch.device("cpu"),) * mesh.size, mesh.shape, mesh.axis_names),
          "param_specs": None if specs is None else {name: specs[name]}}
    return gradmod.compressed_grad_sync([{name: t[name]} for t in trees], **kw)[0][name].to(torch.float32)


def mesh_train_once(d, cfg, tree: dict, tokens: np.ndarray, mesh) -> tuple:
    """One data-parallel step of `cfg` on `mesh` (slots on `d`) from the
    numpy weights `tree`: (loss, grad_norm, {name: AdamW's m}, {name:
    update}, {name: the merged gradient entering the compressed sync}, the
    sync's recorded call), the leaves gathered whole on the CPU."""
    c = TRAIN_CHECK
    with partition.logical_axes(MAP3):
        specs = param_specs(cfg, "train")
        _, step = make_train_step(cfg, AdamWConfig(lr=c["lr"]),
                                  TrainStepConfig(grad_compression=GradCompressionConfig()), mesh=mesh,
                                  param_pspecs=physical_specs(specs), device=d)
    model = params_from_numpy(tree, cfg, d, param_dtype="float32")
    params = reshard({k: p.detach() for k, p in model.named_parameters()}, specs, mesh, MAP3)
    del model
    # init_fn's state without its draw of a model that `tree` replaces
    opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                     m={k: t.placement.zeros(t.shape, torch.float32) for k, t in params.items()},
                     v={k: t.placement.zeros(t.shape, torch.float32) for k, t in params.items()})
    before = {k: t.gather().cpu() for k, t in params.items()}
    b = {"inputs": torch.from_numpy(tokens[:, :-1]).to(d), "labels": torch.from_numpy(tokens[:, 1:]).to(d)}
    with sync_inputs() as seen:
        params, opt, m = step(params, opt, b)
    moments = {k: t.gather().cpu() for k, t in opt.m.items()}
    updates = {k: t.gather().cpu() - before[k] for k, t in params.items()}
    merged = {k: v.to(torch.float32) for k, v in seen[0][0][0].items()}
    return float(m["loss"]), float(m["grad_norm"]), moments, updates, merged, seen[0]


def check_mesh_train_card_vs_cpu(dev, spec: dict = MESH_TRAIN, phase: str = "mesh") -> dict:
    """(a) first: one compressed data-parallel step of `spec`'s arch
    (qwen3-1.7b unless named) at full width and 2 layers on the mesh of
    `spec` ((pod 2, data 1, model 1); the tp phases' (pod 2, data 1, model
    2) splits the model axis), card slots against CPU slots, the same numpy
    weights and tokens, in float32 and in bf16, held to TRAIN_CHECK leaf by
    leaf: the loss, the gradient norm, the merged gradient entering the
    compressed pod sync (the data and model sums' result), AdamW's first
    moment after the sync and the step's updates.

    The moment is (1 - b1) x the clipped, synced gradient. Each of its
    leaves is held within the merged gradients' limit of the CPU's; a leaf
    that is not is held within that limit of the moment recomputed from the
    card's own merged gradient, quantized and dequantized by the CPU
    (`replay_sync`) and clipped by the card's gradient norm. An element of
    the merged gradient within float32 noise of a mu-law code boundary
    lands one code apart on the two sides, ~4 % of its chunk's absmax, which
    in a leaf of a few thousand elements moves the relative norm past 1e-3
    (mamba2-1.3b's `conv_b`, whose 256 B and C channels fill a 2,048-element
    chunk alone: 1.9e-3 in its first run on the H100); the recomputation
    from the card's inputs has no such flips, and a fault in the card's
    quantize or dequantize still shows there. The 8-bit codes of each
    side's merged gradient that differ in the worst leaf are reported."""
    c = TRAIN_CHECK
    arch = spec.get("arch", LM_ARCH)
    cfg = dataclasses.replace(get_arch(arch).model, n_layers=c["layers"])
    tree = params_to_numpy(init_params(cfg, seed=0, device="cpu", param_dtype="float32"))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (c["batch"], c["seq"] + 1)).astype(np.int32)
    opt = AdamWConfig(lr=c["lr"])
    bad, out = [], {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg, dtype=dtype)
        t0 = time.perf_counter()
        got = {}
        for d in (dev, torch.device("cpu")):
            mesh = card_mesh(spec["shape"], spec["names"], d)
            got[d.type] = mesh_train_once(d, cfg, tree, tokens, mesh)
            free_card()
        (lc, gc, mc, uc, gc_in, call), (lp, gp, mp, up, gp_in, _) = got["cuda"], got["cpu"]
        grad_rel = {k: rel_norm(gc_in[k], gp_in[k]) for k in gp_in}
        synced_rel = {k: rel_norm(mc[k], mp[k]) for k in mp}
        update_rel = {k: rel_norm(uc[k], up[k]) for k in up}
        tol = c[dtype]
        scale = torch.tensor(min(1.0, opt.clip_norm / max(gc, 1e-12)), dtype=torch.float32)
        replayed = {}
        for k, r in synced_rel.items():
            if r > tol["grad_rel"]:
                g = replay_sync(call, k)
                replayed[k] = rel_norm(mc[k], (g * scale).to(mc[k].dtype) * (1 - opt.b1))
        held = {k: min(r, replayed.get(k, r)) for k, r in synced_rel.items()}
        worst = max(synced_rel, key=synced_rel.get)
        codes = [quantize_tensor(g[worst], GradCompressionConfig())[0] for g in (gc_in, gp_in)]
        r = {"loss_card": lc, "loss_cpu": lp, "loss_rel": abs(lc - lp) / abs(lp), "grad_norm_card": gc,
             "grad_norm_cpu": gp, "grad_norm_rel": abs(gc - gp) / abs(gp),
             "grad_rel_max": max(grad_rel.values()), "grad_rel_worst": max(grad_rel, key=grad_rel.get),
             "synced_rel_max": synced_rel[worst], "synced_rel_worst": worst,
             "synced_worst_codes_apart": int((codes[0] != codes[1]).sum()), "synced_worst_numel": mp[worst].numel(),
             "synced_replayed_rel": replayed, "synced_held_max": max(held.values()),
             "synced_held_worst": max(held, key=held.get),
             "update_rel_max": max(update_rel.values()), "update_rel_worst": max(update_rel, key=update_rel.get),
             "finite": all(bool(torch.isfinite(g).all()) for g in (*mc.values(), *gc_in.values()))
             and math.isfinite(lc), "tolerance": tol, "seconds": time.perf_counter() - t0}
        out[dtype] = r
        emit({"phase": phase, "path": "train_card_vs_cpu", "arch": arch, "dtype": dtype,
              "mesh": dict(zip(spec["names"], spec["shape"])),
              "config": {k: c[k] for k in ("layers", "batch", "seq", "lr")}, **r})
        if not r["finite"]:
            bad.append(f"{dtype}: non-finite loss or merged gradients on the card")
        if r["loss_rel"] > tol["loss_rel"]:
            bad.append(f"{dtype}: loss {lc} on the card against {lp}")
        if r["grad_norm_rel"] > tol["grad_rel"]:
            bad.append(f"{dtype}: gradient norm {gc} on the card against {gp}")
        if r["grad_rel_max"] > tol["grad_rel"]:
            bad.append(f"{dtype}: merged gradient of {r['grad_rel_worst']} differs by {r['grad_rel_max']}")
        if r["synced_held_max"] > tol["grad_rel"]:
            bad.append(f"{dtype}: AdamW's m of {r['synced_held_worst']} differs by {r['synced_held_max']} "
                       f"(the CPU's {synced_rel[r['synced_held_worst']]})")
        if r["update_rel_max"] > tol["update_rel"]:
            bad.append(f"{dtype}: update of {r['update_rel_worst']} differs by {r['update_rel_max']}")
    if bad:
        raise AssertionError(f"{arch}: card and CPU data-parallel training disagree: " + "; ".join(bad))
    return out


def run_mesh_train(dev, t: dict = MESH_TRAIN, phase: str = "mesh", keep: Optional[dict] = None) -> dict:
    """(a): `train(mesh=...)` of `t`'s arch (qwen3-1.7b unless named) at
    full width and depth (or `t["n_layers"]`), with the compressed pod sync
    unless `t["sync"]` is False, with the launch counts set
    to 0 just before and read just after: B10's lse form twice per
    attention layer, step and slot (the forward and full remat's recompute)
    in each slot's program (under tensor parallelism, on the slot's heads;
    none for the ssm family), B2 once per step (the feed), no other form of
    B10. `keep` as `slot_launches` takes it."""
    arch = t.get("arch", LM_ARCH)
    full = get_arch(arch).model
    cfg = dataclasses.replace(full, n_layers=t["n_layers"]) if t.get("n_layers") else full
    mesh = card_mesh(t["shape"], t["names"], dev)
    free_card()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    compat.reset_wire()
    t0 = time.perf_counter()
    head_dims: dict = {}
    with partition.logical_axes(MAP3), slot_launches(keep, head_dims) as per_slot:
        run = train(cfg, steps=t["steps"], batch=t["batch"], seq=t["seq"], device=dev, mesh=mesh,
                    grad_compression=GradCompressionConfig() if t.get("sync", True) else None,
                    log_every=t["steps"])
        tp = tp_active_on(cfg, mesh, MAP3)
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    per_step = (2 if cfg.remat == "full" else 1) * attention_layers(cfg) * t["steps"]
    want_slot = {"flash_attention_fwd_lse": per_step} if per_step else {}
    checks = {
        "steps": run.final_step == t["steps"] and len(run.losses) == t["steps"],
        "losses_finite": all(math.isfinite(x) for x in run.losses),
        "per_slot_b10": all(per_slot.get(s, {}) == want_slot for s in range(mesh.size)),
        "b2_per_step": launches["unpack_blocks"] == t["steps"],
        "b10_head_dim": set(head_dims) <= {f"flash_attention_fwd_lse/{cfg.head_dim}"},
        "b10_total": launches["flash_attention_fwd_lse"] == per_step * mesh.size
        and not any(launches[k] for k in ("flash_attention_fwd_tc", "flash_attention_fwd",
                                          "flash_attention_fwd_lse_fma")),
    }
    emit({"phase": phase, "path": t.get("path", "train"), "arch": arch, "mesh": dict(zip(t["names"], t["shape"])),
          "mapping": MAP3, "n_layers": cfg.n_layers, "cut": f"{cfg.n_layers} of {full.n_layers} layers",
          "params": cfg.param_count(), "pod_sync": t.get("sync", True), "batch": t["batch"], "seq": t["seq"],
          "steps": t["steps"], "losses": run.losses, "step_s": run.step_s, "tokens_per_s": run.tokens_per_s,
          "peak_memory_allocated": torch.cuda.max_memory_allocated(), "wire_bytes": compat.wire_bytes(),
          "launches": {k: launches[k] for k in MESH_KERNELS}, "launches_per_slot": per_slot,
          "launches_by_head_dim": head_dims, "tensor_parallel": tp, "checks": checks, "seconds": wall})
    if not all(checks.values()):
        raise AssertionError(f"{arch}: the data-parallel train path fails its checks: {checks}; per slot {per_slot}")
    free_card()
    return launches


def tp_active_on(cfg, mesh, mapping) -> bool:
    """Whether `cfg`'s compute splits over `mesh`'s model axis (tensor
    parallelism) under `mapping`."""
    with partition.logical_axes(mapping), partition.set_mesh(mesh):
        return tp_active(cfg)


def check_mesh_serve_card_vs_cpu(dev, spec: dict) -> dict:
    """(b)/(c) first: `spec["arch"]` at full width and 2 layers served on
    the same mesh shape with card slots and with CPU slots, the same
    weights and prompts, held to `spec["check"]` as check_lm_card_vs_cpu
    holds one device."""
    c = spec["check"]
    names = ("data", "model")
    cfg = dataclasses.replace(get_arch(spec["arch"]).model, n_layers=c["layers"])
    tree = params_to_numpy(init_params(cfg, seed=0, device=dev))
    prompts = torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt_len"]),
                            generator=torch.Generator().manual_seed(5))
    t0 = time.perf_counter()
    kw = dict(batch=c["batch"], prompt_len=c["prompt_len"], gen=c["gen"], cache_len=c.get("cache_len"),
              params=tree, prompts=prompts)
    with partition.logical_axes(MAP2):
        card = serve(cfg, device=dev, mesh=card_mesh(spec["shape"], names, dev), **kw)
        t1 = time.perf_counter()
        cpu = serve(cfg, device="cpu", mesh=card_mesh(spec["shape"], names, torch.device("cpu")), **kw)
    t2 = time.perf_counter()
    del tree
    lc, lp = card.prefill_logits.float().cpu(), cpu.prefill_logits.float()
    scale, err = lp.abs().max().item(), (lc - lp).abs().max().item()
    codes = {}
    for name in ("k_codes", "v_codes"):
        a, b = card.cache["layers"][name].gather().cpu(), cpu.cache["layers"][name].gather()
        same = a == b
        alike = slots_fed_alike(card.tokens, cpu.tokens, c["prompt_len"], a.shape[2])
        codes[name] = {"all": same.double().mean().item(), "layer0": same[0].double().mean().item(),
                       "all_fed_alike": same[:, alike].double().mean().item(),
                       "layer0_fed_alike": same[0][alike].double().mean().item()}
    top2 = lp[:, 0].topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).tolist()
    first = [bool(card.tokens[i, 0] == cpu.tokens[i, 0]) or margin[i] < 2 * err for i in range(c["batch"])]
    out = {"phase": spec.get("phase", "mesh"), "path": f"serve_card_vs_cpu/{spec['arch']}",
           "mesh": dict(zip(names, spec["shape"])),
           "config": {**c, "d_model": cfg.d_model}, "prefill_logits_max_abs_err": err, "max_abs_logit": scale,
           "code_agreement": codes, "token_agreement": float((card.tokens == cpu.tokens).mean()),
           "top2_margin_cpu": margin, "card_s": t1 - t0, "cpu_s": t2 - t1}
    emit(out)
    bad = []
    if not bool(torch.isfinite(lc).all()) or err > c["logits_frac"] * scale:
        bad.append(f"prefill logits differ by {err} (max |logit| {scale})")
    over = "_fed_alike" if c.get("codes_over_slots_fed_alike") else ""
    for name, r in codes.items():
        if r["layer0" + over] < c["codes_layer0"] or r["all" + over] < c["codes_all"]:
            bad.append(f"{name} agreement {r}")
    if not all(first):
        bad.append(f"first tokens differ where the margin is clear: {margin}")
    if bad:
        raise AssertionError(f"{spec['arch']} on a mesh: card and CPU serving disagree: " + "; ".join(bad))
    free_card()
    return out


def run_mesh_serve(dev, spec: dict) -> dict:
    """(b)/(c), and the tp phases' serving paths: `spec["arch"]` at full
    width (and `n_layers`) served through `serve(mesh=...)` with the launch
    counts set to 0 just before and read just after: B10's tensor-core
    kernel once per attention layer in each data shard's slot program when
    the data axis splits the batch, in each slot's program on its heads
    under tensor parallelism, else once per attention layer on the whole
    batch (never for the attention-free ssm family); every slot's ring
    shard of 1/n of the ring, every recurrent state held as shards. Then
    one profiled decode step for the busy share and the host's ops."""
    cfg = get_arch(spec["arch"]).model
    if spec.get("n_layers"):
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    names = ("data", "model")
    mesh = card_mesh(spec["shape"], names, dev)
    free_card()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (spec["batch"], spec["prompt_len"]),
                            generator=torch.Generator().manual_seed(0)).to(dev, torch.int32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    compat.reset_wire()
    with partition.logical_axes(MAP2), slot_launches() as per_slot:
        run = serve(cfg, batch=spec["batch"], prompt_len=spec["prompt_len"], gen=spec["gen"], device=dev,
                    params=model, prompts=prompts, mesh=mesh)
    launches, wire = ops.launch_counts(), compat.wire_bytes()
    n_data, n_model = spec["shape"]
    tp = tp_active_on(cfg, mesh, MAP2)
    n_attn = attention_layers(cfg)
    if not n_attn:
        want = {}
    elif n_data > 1 or tp:  # per data shard, or under tensor parallelism per slot on its heads
        want = {s: {"flash_attention_fwd_tc": n_attn} for s in range(mesh.size)}
    else:
        want = {"whole": {"flash_attention_fwd_tc": n_attn}}
    ring = attention_ring(cfg, run.cache)
    w = None if ring is None else _round_window(cfg.effective_kv_window(spec["prompt_len"] + spec["gen"]))
    rows = spec["batch"] // n_data if spec["batch"] > 1 else 1
    checks = {
        "per_slot_b10": per_slot == want,
        "no_fma": launches["flash_attention_fwd"] == 0,
        "logits_finite": bool(torch.isfinite(run.prefill_logits).all()),
        "tokens_in_vocab": bool(((run.tokens >= 0) & (run.tokens < cfg.padded_vocab)).all()),
        "pos": run.cache["pos"] == spec["prompt_len"] + spec["gen"] - 1,
    }
    if ring is not None:
        checks["ring_shards"] = len(ring["k_codes"].shards) == mesh.size and all(
            tuple(sh.shape) == (n_attn, rows, w // n_model, cfg.n_kv_heads, cfg.head_dim)
            for sh in ring["k_codes"].shards)
    ring_ids = {id(v) for v in (ring or {}).values()}
    states = [v for v in sharded_leaves(run.cache) if id(v) not in ring_ids]
    if cfg.family in ("ssm", "hybrid"):
        checks["state_shards"] = bool(states) and all(
            isinstance(v, Sharded) and len(v.shards) == mesh.size
            and math.prod(v.shards[0].shape) * n_model * (spec["batch"] // rows) == math.prod(v.shape)
            for v in states)
        checks["states_finite"] = all(bool(torch.isfinite(sh.float()).all()) for v in states for sh in v.shards)
    if n_model > 1:
        checks["split_sums_on_the_wire"] = wire.get("psum", 0) > 0 and wire.get("all_gather", 0) > 0
        if n_attn:
            checks["lse_merge_on_the_wire"] = wire.get("pmax", 0) > 0
    if (n_data > 1 or tp) and cfg.family == "moe":
        checks["moe_buffers_gathered"] = wire.get("all_gather", 0) > 0
    line = {"phase": spec.get("phase", "mesh"), "path": f"serve/{spec['arch']}", "tensor_parallel": tp,
            "mesh": dict(zip(names, spec["shape"])),
            "mapping": MAP2, "n_layers": cfg.n_layers, "cut": None if not spec.get("n_layers") else
            f"{spec['n_layers']} of {get_arch(spec['arch']).model.n_layers} layers",
            "batch": spec["batch"], "prompt_len": spec["prompt_len"], "gen": spec["gen"], "ring_slots": w,
            "prefill_s": run.prefill_s, "decode_ms_per_step": run.decode_s * 1e3 / (spec["gen"] - 1),
            "peak_memory_allocated": torch.cuda.max_memory_allocated(), "wire_bytes": wire,
            "cache_bytes": run.cache_bytes, "launches_per_slot": per_slot,
            "launches": {k: launches[k] for k in MESH_KERNELS}, "checks": checks, "init_s": init_s}
    with torch.inference_mode(), partition.logical_axes(MAP2), partition.set_mesh(mesh):
        cache = run.cache
        tok = torch.from_numpy(run.tokens[:, -1:]).to(dev)
        t1 = time.perf_counter()
        cache, _ = decode_step(model, cfg, cache, tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
        busy, top, host_ops, _ = device_busy_ms(lambda: decode_step(model, cfg, cache, tok), top=4)
    line.update({"decode_step_wall_ms": wall_ms, "decode_step_busy_ms": busy,
                 "busy_share": busy / wall_ms if busy else None, "decode_step_top_kernels_ms": top,
                 "host_ops_per_decode_step": host_ops, "seconds": time.perf_counter() - t0})
    emit(line)
    del run, model, prompts, cache
    free_card()
    if not all(checks.values()):
        raise AssertionError(f"{spec['arch']} on a mesh fails its checks: {checks}; per slot {per_slot}")
    return launches


def run_mesh(dev) -> dict:
    """The mesh phase: (a) and (c) with their card-vs-CPU checks ((b), the
    distributed-LSE decode on (data 1, model 4), is tensor-parallel now and
    runs as the tp phase's (a)). Returns the launches of the main paths."""
    launches = {k: 0 for k in KERNELS}
    for fn in (lambda: (check_mesh_train_card_vs_cpu(dev), run_mesh_train(dev))[1],
               lambda: (check_mesh_serve_card_vs_cpu(dev, MESH_MOE), run_mesh_serve(dev, MESH_MOE))[1]):
        for k, n in fn().items():
            if k in launches:
                launches[k] += n
    return launches


#: the tp phase (ROADMAP A10 item 5b): tensor parallelism over the model
#: axis, every slot on the one H100, each path held card against CPU on the
#: same mesh first, at full width and 2 layers:
#:  (a) qwen3-1.7b at full width and depth served 4 x 2,048 + 4 on (data 1,
#:      model 4): B10's tensor-core kernel on each slot's 4 heads (over its
#:      2 kv heads, G = 2), the ring's slices written from K/V gathered over
#:      the group, the decode's statistics merged over the slots; LM_CHECK
#:      (the mesh phase's (b) before, now split);
#:  (b) training: one compressed step of qwen3-1.7b on (pod 2, data 1,
#:      model 2) at 2 layers, card against CPU in float32 and bf16 under
#:      TRAIN_CHECK; then `train(mesh=...)` at full width and 8 of its 28
#:      layers (cut: the four slots' gathered float32 leaves and gradients
#:      of all 28 would not fit the card beside the masters and moments), 2
#:      steps through the B2 feed;
#:  (c) expert parallelism: qwen3-moe-30b-a3b at full width and 4 of its 48
#:      layers on (data 1, model 4), 32 experts a slot, 4 x 2,048 + 4;
#:      first the split expert FFN (`moe.moe_group`) card against CPU on
#:      the same slots, routing and y held to MOE_CHECK["route"] (the moe
#:      phase's path 2 at the same shape): a served prefill's last logits
#:      move with every routing decision that a near tie flips between
#:      the card's and the CPU's bf16 partial sums.
#: (a)'s check serves LM_CHECK's 2 x 256 + 4 in a ring of 512 slots: the
#: model axis splits the ring's 128-slot scale groups 4 ways. Its codes are
#: compared over the ring slots both runs fed the same tokens, as the moe
#: check compares them: the split program's bf16 partial sums move a near
#: tie of the greedy token (a 0.2 margin in a run on the H100, 3 of 4 tokens
#: alike), and a slot fed another token holds other codes
TP_SERVE = dict(arch=LM_ARCH, shape=(1, 4), batch=4, prompt_len=2048, gen=4, phase="tp",
                check=dict(LM_CHECK, cache_len=512, codes_over_slots_fed_alike=True))
TP_TRAIN = dict(shape=(2, 1, 2), names=("pod", "data", "model"), steps=2, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                n_layers=8)
TP_MOE = dict(arch="qwen3-moe-30b-a3b", shape=(1, 4), batch=4, prompt_len=2048, gen=4, n_layers=4, phase="tp")


#: the tp_recurrent paths (ROADMAP A10 item 5c): the ssm and hybrid families
#: split over the model axis, every slot on the one H100, each held card
#: against CPU on the same slots first:
#:  (d) mamba2-1.3b at full width and depth (48 layers) served 4 x 2,048 + 4
#:      on (data 1, model 4): 2,128 of in_proj's 8,512 columns, 1,088 of the
#:      4,352 conv channels (17 heads' worth, straddling the slot's 16 SSD
#:      heads) and 1,024 of out_proj's rows a slot; its check at
#:      RECURRENT_CHECK's 2 layers and limits, both dtypes;
#:  (e) recurrentgemma-9b at full width and depth (38 layers) served 2 x
#:      4,096 + 4 on (data 1, model 4), so that its 2,048-slot rings wrap:
#:      4 of the 16 heads (G 4 over the one kv head, B10's Dh 256
#:      tensor-core instance, 12 launches a slot), 1,024 of 4,096 RG-LRU
#:      channels, 3,072 of 12,288 d_ff and 512 ring slots a slot; its check
#:      at RECURRENT_CHECK's 5 layers and limits, both dtypes, in a cache of
#:      512 positions, so that the ring's four 128-slot scale groups split 4
#:      ways (256 would be one group: refused, as TP_SERVE's check keeps
#:      512); its codes are compared after the prefill, when every slot of
#:      both rings holds the same tokens;
#:  (f) training: mamba2-1.3b on (pod 2, data 1, model 2), its split train
#:      check at 2 layers in float32 and bf16 under TRAIN_CHECK, then
#:      `train(mesh=...)` at full width and 8 of its 48 layers (TP_TRAIN's
#:      cut), 2 compressed steps of 4 x 1,024 through B2.
TP_RECURRENT_SERVE = (
    dict(arch="mamba2-1.3b", shape=(1, 4), batch=4, prompt_len=2048, gen=4, phase="tp_recurrent"),
    dict(arch="recurrentgemma-9b", shape=(1, 4), batch=2, prompt_len=4096, gen=4, phase="tp_recurrent",
         check_cache_len=512),
)
TP_TRAIN_SSM = dict(TP_TRAIN, arch="mamba2-1.3b")


def run_tp(dev) -> tuple:
    """The tp phase: (a)-(c) with their card-vs-CPU checks (a `tp` line
    with their seconds), then the tp_recurrent paths (d)-(f)
    (`run_tp_recurrent`). Returns (the launches of the six main paths,
    those of B10's Dh 256 instance in (e))."""
    t0 = time.perf_counter()
    launches = {k: 0 for k in KERNELS}
    for fn in (lambda: (check_mesh_serve_card_vs_cpu(dev, TP_SERVE), run_mesh_serve(dev, TP_SERVE))[1],
               lambda: (check_mesh_train_card_vs_cpu(dev, TP_TRAIN, "tp"), run_mesh_train(dev, TP_TRAIN, "tp"))[1],
               lambda: (check_moe_route(dev, TP_MOE["shape"], "tp"), run_mesh_serve(dev, TP_MOE))[1]):
        for k, n in fn().items():
            if k in launches:
                launches[k] += n
    end_phase("tp", t0)
    got, dh256 = run_tp_recurrent(dev)
    for k, n in got.items():
        launches[k] += n
    return launches, dh256


def run_tp_recurrent(dev) -> tuple:
    """(d)-(f) with their card-vs-CPU checks, then a `tp_recurrent` line
    with their seconds. Returns (their launches, B10's Dh 256 instance's
    launches in (e))."""
    t0 = time.perf_counter()
    launches = {k: 0 for k in KERNELS}
    dh256 = 0
    for spec in TP_RECURRENT_SERVE:
        for dtype in RECURRENT_CHECK["dtypes"]:
            check_recurrent_card_vs_cpu(dev, spec["arch"], dtype, spec)
        got = run_mesh_serve(dev, spec)
        if get_arch(spec["arch"]).model.family == "hybrid":
            dh256 += got["flash_attention_fwd_tc"]
        for k, n in got.items():
            if k in launches:
                launches[k] += n
    check_mesh_train_card_vs_cpu(dev, TP_TRAIN_SSM, "tp_recurrent")
    for k, n in run_mesh_train(dev, TP_TRAIN_SSM, "tp_recurrent").items():
        if k in launches:
            launches[k] += n
    end_phase("tp_recurrent", t0)
    return launches, dh256


#: the tp_train phase (ROADMAP A10 items 6b-6d): training split over the
#: model axis of a (pod 1, data 1, model 4) mesh under MAP3, the four slots
#: on the one H100. Its model split is the one tests/test_torch_tp.py and
#: tests/test_torch_tp_recurrent.py hold against the reference on (data 1,
#: model 4) (tests/test_torch_tp_train_card.py ties the two meshes); a data
#: axis of 1 gathers no whole shard (FSDP), and a pod axis of 1 has nothing
#: to sync, so the paths run without the compressed sync. Each at full
#: width, after the earlier phases have freed the card, held card against
#: CPU on the same slots first (`check_split_train_card_vs_cpu`), then
#: `train(mesh=...)` for 2 steps of 4 x 1,024 through B2:
#:  * recurrentgemma-9b at 3 of its 38 layers, one whole group (RG-LRU,
#:    RG-LRU, local attention): the least depth that trains the attention
#:    layer. A slot holds 4 of the 16 query heads over the one kv head (G 4,
#:    Dh 256: B10's lse form on its tensor-core Dh 256 instance, twice a
#:    step, the forward and full remat's recompute; the 2,048-key window
#:    never bites at 1,024), 1,024 of the 4,096 RG-LRU channels, 3,072 of
#:    12,288 d_ff and 64,000 of the 256,000 vocab rows (2.687 B parameters,
#:    2.097 B of them `embed` and `head`); its check at the same 3 layers;
#:  * qwen3-moe-30b-a3b with its experts split, 32 of 128 a slot, at 3 of 48
#:    layers (the one-device path's depth, `MOE_TRAIN`), 8 query heads over 1
#:    kv head a slot (G 8); its check at MOE_TRAIN_CHECK's 2 layers;
#:  * mixtral-8x7b with each expert's d_ff split, 3,584 of 14,336 columns of
#:    each of the 8 a slot, at 2 of 32 layers (3.165 B parameters): 1 layer
#:    (1.713 B) peaked at 38.5 GB on the H100, and a second adds 1.451 B at
#:    ~21 bytes (`reckoned_bytes`), ~69 GB; 8 query heads over 2 kv heads a
#:    slot (G 4); its check at 1 layer, whose CPU half at 2 layers would
#:    hold ~70 GB of the host's 96 GiB beside the script.
#: The depths are cut for the card's memory: 16 bytes a parameter (float32
#: masters, AdamW's two moments, the gradients), the bf16 working copies
#: and the per-shard AdamW's float32 temporaries (`reckoned_bytes`).
#: The check's CPU half stops where the step's per-shard AdamW begins
#: (`adamw_inputs`), and the CPU's clipped gradient shards are taken through
#: the same AdamW on the card (`host_adamw`): AdamW is elementwise and held
#: card against CPU by the train, mesh and tp phases' checks; on the H100
#: machine's host recurrentgemma's CPU step took 46.6-47.4 s with it and
#: 22.9-25.0 s without (another host), the peak host RSS 81.4 and 52.0 GB.
#: The check's limits, written before its first run and never loosened:
#: float32, every limit of TRAIN_CHECK (the loss; the gradient norm and
#: AdamW's first moment at `grad_rel`, each leaf over its four shards; the
#: updates) and for the moe configs the aux loss at `loss_rel`,
#: MOE_TRAIN_CHECK["sel_set"] on the routed experts, the stacked expert
#: leaves compared on each slot's experts routed alike, the dropped pairs
#: equal where a layer routes alike; bf16, the hybrid every limit of
#: TRAIN_CHECK["bfloat16"], the moe configs the loss and aux limits with
#: their routing, moments and updates printed (MOE_TRAIN_CHECK's rule for
#: a whole step: bf16 routing flips between the card and the CPU, and the
#: split step has no stages to hold apart). In both dtypes every layer's
#: recompute routes as its forward, every slot routes as slot 0 and the
#: card's dispatch of its own routing is the CPU's
SPLIT_TRAIN = dict(shape=(1, 1, 4), names=("pod", "data", "model"), steps=2, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                   sync=False)
TP_TRAIN_SPLIT = (
    dict(SPLIT_TRAIN, arch="recurrentgemma-9b", n_layers=3, check_layers=3, path="train-hybrid"),
    dict(SPLIT_TRAIN, arch="qwen3-moe-30b-a3b", n_layers=3, check_layers=MOE_TRAIN_CHECK["layers"],
         path="train-moe"),
    dict(SPLIT_TRAIN, arch="mixtral-8x7b", n_layers=2, check_layers=1, path="train-mixtral"),
)


@contextlib.contextmanager
def split_routes():
    """Every `moe.route` call made in the block (`moe_group` routes the
    shard's tokens on every slot, with the slot's copy of the router):
    {the router's data pointer: [(sel on the CPU, aux)]} in first-call
    order, one router per layer and slot, each called by the forward and
    then by full remat's recompute."""
    calls: dict = {}
    orig = moe.route

    def record(router, cfg, xt):
        out = orig(router, cfg, xt)
        calls.setdefault(router.data_ptr(), []).append((out[1].detach().cpu(), float(out[3].detach())))
        return out

    moe.route = record
    try:
        yield calls
    finally:
        moe.route = orig


@contextlib.contextmanager
def adamw_inputs():
    """The split step's per-shard AdamW held back for the block
    (`steps.adamw`, taken when the step is built, and `steps.apply_updates_`,
    when it runs): each call records its input, the slot's clipped
    gradient shards, and updates nothing. Yields the records, one
    {name: shard} per slot in slot order."""
    from repro_torch.launch import steps as step_module

    seen, orig = [], (step_module.adamw, step_module.apply_updates_)

    def recording_adamw(cfg):
        def update(grads, state, params):
            seen.append(dict(grads))
            return {}, state, {"lr": float(cfg.lr)}

        return orig[0](cfg)[0], update

    step_module.adamw, step_module.apply_updates_ = recording_adamw, lambda params, updates: None
    try:
        yield seen
    finally:
        step_module.adamw, step_module.apply_updates_ = orig


def split_train_side(d, cfg, named: dict, tokens: np.ndarray, spec: dict, host: bool = False) -> dict:
    """One step of `cfg` split over `spec`'s mesh with every slot on `d`,
    from the float32 weights `named` ({name: tensor}, on any device; the
    masters placed shard by shard from them: no whole copy on `d`), without
    a pod sync. Returns the loss, ce and gradient norm; per leaf AdamW's
    first moment and the update (the masters less `named`, in place), a
    tensor per slot on `d`, and each slot's slice of the leaf; with `host`,
    AdamW held back (`adamw_inputs`) and per leaf the clipped gradient it
    was given instead; for the moe family each layer's routing on slot 0
    ([forward's sel, recompute's] on the CPU), whether every slot routed
    as slot 0, and the aux loss of the forward's routing; the seconds of
    the set-up and of the step."""
    c = TRAIN_CHECK
    t0 = time.perf_counter()
    mesh = card_mesh(spec["shape"], spec["names"], d)
    with contextlib.ExitStack() as stack:
        seen = stack.enter_context(adamw_inputs()) if host else None
        with partition.logical_axes(MAP3):
            specs = param_specs(cfg, "train")
            _, step = make_train_step(cfg, AdamWConfig(lr=c["lr"]), mesh=mesh,
                                      param_pspecs=physical_specs(specs), device=d)
        params = reshard({k: named[k] for k in specs}, specs, mesh, MAP3)
        # held back, AdamW reads no moment: the masters stand in for them
        m, v = (params, params) if host else (
            {k: t.placement.zeros(t.shape, torch.float32) for k, t in params.items()} for _ in range(2))
        opt = AdamWState(step=torch.zeros((), dtype=torch.int32), m=m, v=v)
        batch = {"inputs": torch.from_numpy(tokens[:, :-1]).to(d), "labels": torch.from_numpy(tokens[:, 1:]).to(d)}
        t1 = time.perf_counter()
        with split_routes() as calls:
            params, opt, metrics = step(params, opt, batch)
    out = {"loss": float(metrics["loss"]), "ce": float(metrics["ce"]), "grad_norm": float(metrics["grad_norm"]),
           "slices": {k: [t.placement.slices(t.shape, s) for s in range(mesh.size)] for k, t in params.items()},
           "setup_s": t1 - t0, "step_s": time.perf_counter() - t1}
    if host:
        out["g"] = {k: [seen[s][k] for s in range(mesh.size)] for k in params}
    else:
        out["m"], out["updates"] = {k: t.shards for k, t in opt.m.items()}, {}
        for k, t in params.items():
            for s, shard in enumerate(t.shards):
                shard.sub_(named[k][out["slices"][k][s]].to(d))
            out["updates"][k] = t.shards
    del opt, params
    if cfg.family == "moe":
        n = mesh.shape[mesh.axis_names.index("model")]
        seq = list(calls.values())
        out["routes"] = {i: [sel for sel, _ in seq[i * n]] for i in range(cfg.n_layers)}
        out["slots_route_alike"] = len(seq) == cfg.n_layers * n and all(
            len(seq[i * n + j]) == len(seq[i * n])
            and all(torch.equal(a[0], b[0]) for a, b in zip(seq[i * n + j], seq[i * n]))
            for i in range(cfg.n_layers) for j in range(n))
        out["aux"] = sum(seq[i * n][0][1] for i in range(cfg.n_layers))
    return out


def host_adamw(dev, named: dict, k: str, host: dict, card: dict) -> tuple:
    """Leaf k's AdamW moment and update for the CPU side's clipped gradient
    (`split_train_side(host=True)`), each slot's on `dev` by the step's own
    AdamW (`adamw`, clip off, from zero moments, on the slot's slice of
    `named`), the update as the step leaves it (the master plus it, less
    the master). The host's gradient shards are dropped."""
    update = adamw(AdamWConfig(lr=TRAIN_CHECK["lr"], clip_norm=None))[1]
    ms, us = [], []
    for g, sl in zip(host["g"].pop(k), card["slices"][k]):
        g, p = g.to(dev), named[k][sl].to(dev)
        st = AdamWState(step=torch.zeros((), dtype=torch.int32), m={k: torch.zeros_like(g)},
                        v={k: torch.zeros_like(g)})
        u = update({k: g}, st, {k: p})[0][k]
        ms.append(st.m[k])
        us.append((p + u) - p)
    return ms, us


def shards_rel(dev, card: list, host: list, rows=None) -> tuple:
    """(||card - host|| / ||host|| over every slot's shard of a leaf, in
    float64 on `dev`, each CPU shard moved there in turn; whether the card's
    shards are finite). `rows(s)`: the rows of slot s's shard to compare."""
    num = den = 0.0
    finite = True
    for s, (a, b) in enumerate(zip(card, host)):
        b = b.to(dev)
        if rows is not None:
            r = rows(s).to(dev)
            a, b = a[r], b[r]
        finite = finite and bool(torch.isfinite(a).all())
        num += torch.sum(torch.square(a.double() - b.double())).item()
        den += torch.sum(torch.square(b.double())).item()
    return (math.sqrt(num / den) if den else math.sqrt(num)), finite


def split_train_compare(dev, cfg, named: dict, card: dict, host: dict, tol: dict, gate_all: bool) -> tuple:
    """Card side against CPU side (`split_train_side`'s results, the CPU's
    taken through AdamW by `host_adamw`; each leaf's shards dropped on both
    sides once compared): the loss, the gradient norm, AdamW's first moment
    and the update leaf by leaf over the slots' shards; for the moe family
    the routing per layer (`route_compare`), the aux loss, and the stacked
    expert leaves on each slot's experts routed alike. Returns (the line's
    numbers, the failures: every limit with `gate_all`, else the finite
    values and the loss and aux limits)."""
    r, agree_rows, bad, routing_bad = {}, {}, [], []
    moe_family = cfg.family == "moe"
    if moe_family:
        cap = moe.capacity(host["routes"][0][0].shape[0], cfg)
        r, agree_rows, bad, routing_bad = route_compare(dev, cfg, cap, card["routes"], host["routes"],
                                                        MOE_TRAIN_CHECK["sel_set"])
        r["slots_route_alike"] = {"card": card["slots_route_alike"], "cpu": host["slots_route_alike"]}
        if not all(r["slots_route_alike"].values()):
            bad.append(f"a slot routes otherwise than slot 0: {r['slots_route_alike']}")
    mspec = model_split(cfg)
    moment_rel, update_rel = {}, {}
    finite = math.isfinite(card["loss"]) and math.isfinite(card["grad_norm"])
    for k in list(host["g"]):
        em = EXPERT_LEAF.match(k)
        rows = None
        if em and not bool(agree_rows[int(em.group(1))].all()):
            alike, n = agree_rows[int(em.group(1))], len(host["g"][k])
            el = cfg.n_experts // n
            rows = (lambda s, a=alike, el=el: a[s * el:(s + 1) * el]) if mspec[k] == 0 else (lambda s, a=alike: a)
        host_m, host_u = host_adamw(dev, named, k, host, card)
        moment_rel[k], fin = shards_rel(dev, card["m"].pop(k), host_m, rows)
        update_rel[k], _ = shards_rel(dev, card["updates"].pop(k), host_u, rows)
        finite = finite and fin
    r.update({"loss_card": card["loss"], "loss_cpu": host["loss"],
              "loss_rel": abs(card["loss"] - host["loss"]) / abs(host["loss"]),
              "grad_norm_card": card["grad_norm"], "grad_norm_cpu": host["grad_norm"],
              "grad_norm_rel": abs(card["grad_norm"] - host["grad_norm"]) / abs(host["grad_norm"]),
              "moment_rel_max": max(moment_rel.values()), "moment_rel_worst": max(moment_rel, key=moment_rel.get),
              "update_rel_max": max(update_rel.values()), "update_rel_worst": max(update_rel, key=update_rel.get),
              "finite": finite, "tolerance": tol, "gated": "all" if gate_all else "finite, loss, aux"})
    if moe_family:
        r.update({"aux_card": card["aux"], "aux_cpu": host["aux"],
                  "aux_rel": abs(card["aux"] - host["aux"]) / abs(host["aux"])})
        if not r["aux_rel"] <= tol["loss_rel"]:
            bad.append(f"aux loss {card['aux']} on the card against {host['aux']}")
    if not finite:
        bad.append("non-finite loss, gradient norm or moments on the card")
    if not r["loss_rel"] <= tol["loss_rel"]:
        bad.append(f"loss {card['loss']} on the card against {host['loss']}")
    if r["grad_norm_rel"] > tol["grad_rel"]:
        routing_bad.append(f"gradient norm {card['grad_norm']} on the card against {host['grad_norm']}")
    if r["moment_rel_max"] > tol["grad_rel"]:
        routing_bad.append(f"AdamW's m of {r['moment_rel_worst']} differs by {r['moment_rel_max']}")
    if r["update_rel_max"] > tol["update_rel"]:
        routing_bad.append(f"update of {r['update_rel_worst']} differs by {r['update_rel_max']}")
    return r, bad + (routing_bad if gate_all else [])


def check_split_train_card_vs_cpu(dev, spec: dict, cfg=None) -> dict:
    """A tp_train path's check: one step of `spec`'s arch at full width and
    `spec["check_layers"]` (or of `cfg`, a small config for the CPU tests)
    split over `spec`'s mesh, card slots against CPU slots, the same numpy
    weights (seed 0, drawn on `dev`) and TRAIN_CHECK's tokens, float32 then
    bf16, held as the tp_train comment says (`split_train_compare`). The
    weights stay on `dev` (the host holds no copy of them); the CPU side
    runs first, up to AdamW's per-shard update, and keeps its numbers,
    routing and clipped gradient shards on the host; then the card's whole
    step; then leaf by leaf the CPU's gradient is taken through the step's
    AdamW on the card (`host_adamw`) and compared with the card's moment and
    update there."""
    c = TRAIN_CHECK
    base = cfg or dataclasses.replace(get_arch(spec["arch"]).model, n_layers=spec["check_layers"])
    named = {k: p.detach() for k, p in init_params(base, seed=0, device=dev, param_dtype="float32")
             .named_parameters()}
    tokens = np.random.default_rng(5).integers(0, base.vocab_size, (c["batch"], c["seq"] + 1)).astype(np.int32)
    out, bad = {}, []
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        t0 = time.perf_counter()
        host = split_train_side(torch.device("cpu"), cfg, named, tokens, spec, host=True)
        t1 = time.perf_counter()
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        card = split_train_side(dev, cfg, named, tokens, spec)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        seconds = {f"{side}_{k}": v[k] for side, v in (("cpu", host), ("card", card)) for k in ("setup_s", "step_s")}
        r, failed = split_train_compare(dev, cfg, named, card, host, c[dtype],
                                        gate_all=dtype == "float32" or cfg.family != "moe")
        del card, host
        free_card()
        out[dtype] = r
        bad += [f"{dtype}: {f}" for f in failed]
        emit({"phase": spec.get("phase", "tp_train"), "path": "train_card_vs_cpu", "arch": spec["arch"],
              "dtype": dtype, "mesh": dict(zip(spec["names"], spec["shape"])),
              "config": {**{k: c[k] for k in ("batch", "seq", "lr")}, "layers": cfg.n_layers, "d_model": cfg.d_model,
                         "params": cfg.param_count(), "remat": cfg.remat},
              **r, "cpu_s": t1 - t0, "card_s": t2 - t1, "compare_s": time.perf_counter() - t2, **seconds,
              "peak_rss_after_cpu_side": rss,
              "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024})
    del named
    free_card()
    if bad:
        raise AssertionError(f"{spec['arch']}: card and CPU split training disagree: " + "; ".join(bad))
    return out


def reckoned_bytes(cfg, n_slots: int) -> int:
    """The split step's reckoned peak of card memory for `cfg`'s parameters
    P: 16 P (float32 masters, AdamW's two moments, the gradients), 2 P (the
    bf16 working copies) and 3 x 4 P / n_slots (the per-shard AdamW's
    float32 temporaries: one slot's shards at a time); activations apart."""
    p = cfg.param_count()
    return 16 * p + 2 * p + 12 * p // n_slots


def time_split_flash_dh256(dev, kept: tuple, cycles_per_ms: float) -> dict:
    """B10's lse form on the split hybrid training's own q, k, v (slot 0's
    first launch: 4 x 1,024, 4 heads over 1, Dh 256) beside its plain
    version and torch's flash `_scaled_dot_product_flash_attention` (out
    and lse, causal, k and v repeated to the 4 heads; the library
    yardstick, which the port never calls). Bound as `time_train_flash`'s:
    the band's operations at the bf16 tensor-core peak against q, k, v
    read and out and lse written once."""
    (q, k, v), kw = kept
    window = kw.get("window")
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    with torch.no_grad():
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
        before = ops.launch_counts()["flash_attention_fwd_lse"]
        got, lse = ops.flash_attention_fwd_lse(q, k, v, **kw)
        if ops.launch_counts()["flash_attention_fwd_lse"] != before + 1:
            raise AssertionError("the split hybrid's lse call did not run the tensor-core kernel")
        want, want_lse = ref.flash_reference_lse(q, k, v, **kw)
        ok, tol = flash_within(got, want)
        err = (got.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if not (ok and lse_err <= LSE_TOL[0] + LSE_TOL[1] * want_lse.abs().max().item()):
            raise AssertionError(f"B10's Dh 256 lse form disagrees on the split hybrid's inputs: {err}, lse {lse_err}")
        ms, host_ms = time_ms(lambda: ops.flash_attention_fwd_lse(q, k, v, **kw), 50, cycles_per_ms)
        plain_ms, plain_host_ms = time_ms(lambda: ref.flash_reference_lse(q, k, v, **kw), 5, cycles_per_ms)
        lib = {}
        try:
            def library():
                return torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt, 0.0, True)

            lib["library_lse_max_abs_err"] = (library()[1][..., :s].float() - want_lse).abs().max().item()
            lib["library_ms"] = time_ms(library, 50, cycles_per_ms)[0]
        except RuntimeError as exc:  # a backend that refuses these inputs: recorded, not timed
            lib["library_ms"], lib["library_refused"] = None, str(exc).splitlines()[0][:200]
    nops = flash_attn.flops(b, s, s, h, dh, window, True)
    nbytes = 2 * (q.numel() * q.element_size() + k.numel() * k.element_size()) + lse.numel() * 4
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / BF16_TENSOR_OPS_PER_S * 1e3
    bound_ms, bound_by = (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": nops, "chain_steps": None, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
            "max_abs_err": err, "lse_max_abs_err": lse_err, "tolerance": tol, "dtype": str(q.dtype),
            "shape": [b, s, h, k.shape[2], dh], "window": window, "tflops": nops / (ms * 1e-3) / 1e12, **lib}


def run_tp_train(dev) -> tuple:
    """The tp_train phase: each TP_TRAIN_SPLIT path's check, then its
    `train(mesh=...)` (B10's lse form on each slot's heads, at Dh 256 on the
    hybrid), then a `tp_train` line with the phase's seconds. Returns (the
    paths' launches, the hybrid path's lse launches, the Dh 256 lse form
    timed on its inputs)."""
    t0 = time.perf_counter()
    launches = {k: 0 for k in KERNELS}
    dh256, timing = 0, None
    for spec in TP_TRAIN_SPLIT:
        free_card()
        check_split_train_card_vs_cpu(dev, spec)
        cfg = dataclasses.replace(get_arch(spec["arch"]).model, n_layers=spec["n_layers"])
        emit({"phase": "tp_train", "path": spec["path"], "arch": spec["arch"], "params": cfg.param_count(),
              "reckoned_bytes": reckoned_bytes(cfg, spec["shape"][-1]),
              "card_bytes": torch.cuda.get_device_properties(dev).total_memory})
        kept: dict = {}
        got = run_mesh_train(dev, dict(spec, phase="tp_train"), "tp_train", keep=kept)
        for k, n in got.items():
            if k in launches:
                launches[k] += n
        if cfg.family == "hybrid":
            dh256 = got["flash_attention_fwd_lse"]
            timing = time_split_flash_dh256(dev, kept["flash_attention_fwd_lse"], sleep_cycles_per_ms())
            emit({"phase": "tp_train", "path": spec["path"], "flash_lse_dh256":
                  {k: v for k, v in timing.items() if k != "max_abs_err"}})
        del kept
        free_card()
    end_phase("tp_train", t0)
    return launches, dh256, timing


#: the examples phase: each twin of the reference's examples
#: (`examples/torch_<name>.py`), its arguments, the lines it must print
#: (each pattern matched by a line of its own) and the kernels it must
#: launch. The values checked are those fixed by the configuration, not by
#: the data (ROADMAP C3: datasets differ across numpy versions): the ADPCM
#: and NUQ ratios, the caches' bytes, the restart, the remesh. Not the
#: planner's picks (quickstart's [2], edge_planner's point A): its energy
#: budget reads host walls, and a first candidate's one-time set-up can
#: spend it (the twin then prints no pick); the line is printed as it came
EXAMPLES = (
    dict(name="quickstart", args=(), lines=(
        r"^\[0\] negotiated: adpcm \(Table 1 ADPCM, wire id 2\), block 2048 tuples, scan chunk 128$",
        r"^\[1\] ADPCM on ECG: ratio 4\.00x, [\d.]+ MB/s, NRMSE [\d.]+% \(frame: \d+ wire bytes\)$",
        r"^\[3\] NUQ KV cache: 2\.00x vs bf16, value error [\d.]+%$"),
        kernels=("pack_blocks_meta7", "compact_blocks", "adpcm_lane_encode", "adpcm_lane_decode")),
    dict(name="serve_lm", args=(), lines=(
        r"^NUQ-quantized cache: +[\d.]+ tok/s decode, prefill +[\d.]+ ms, cache 0\.39 MB  \(2\.00x smaller than "
        r"raw\)$",
        r"^raw bf16     cache: +[\d.]+ tok/s decode, prefill +[\d.]+ ms, cache 0\.79 MB$",
        r"^  sample tokens: \[\d+(, \d+){9}\]$"),
        kernels=("flash_attention_fwd_tc",)),
    dict(name="train_lm", args=("--small", "--steps", "8", "--fail-at", "4"), lines=(
        r"^training qwen3-10m: [\d.]+M params, 8 steps @ batch 8 x seq 256$",
        r"^loss [\d.]+ -> [\d.]+ over 8 steps$",
        r"^throughput \d+ tok/s; feed compression [\d.]+x; restarts 1 \(injected\), stragglers flagged \d+$"),
        kernels=("unpack_blocks", "flash_attention_fwd_lse")),
    dict(name="edge_planner", args=(), lines=(
        r"^solution space on 'ecg' \(11 candidates\):$",
        r"^planner's point A: \S+$",
        r"^paper point A \(PLA, co-designed\):  ratio=[\d.]+ ",
        r"^paper point B \(careless Tdic32\):   ratio=[\d.]+ "),
        kernels=("pack_blocks_meta7", "compact_blocks")),
    dict(name="multipod_tour", args=(), lines=(
        r"^devices: 8$",
        r"^\[1\] sharded tdic32 \(private state\): warmed-up ratio [\d.]+ across 8 devices$",
        r"^\[1\] sharded tdic32 \(shared state\): warmed-up ratio [\d.]+ across 8 devices$",
        r"^\[2\] compressed pod gradient sync: max err \d\.\d\de-04 ",
        r"^\[3\] elastic remesh 8->4 devices: mesh \{'data': 1, 'model': 4\}, data intact: True$"),
        kernels=("pack_blocks", "dict_probe")),
)


def run_example(spec: dict) -> tuple:
    """One twin run in this process on the card (`main(args)`, its
    `--device` left at its default), its output captured and its launches
    counted from 0. Returns (printed lines, launches, seconds)."""
    import importlib.util
    import io

    path = Path(__file__).resolve().parent / "examples" / f"torch_{spec['name']}.py"
    mod_spec = importlib.util.spec_from_file_location(f"example_torch_{spec['name']}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    out = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        mod.main(list(spec["args"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out.getvalue().splitlines(), ops.launch_counts(), seconds


def run_examples(dev) -> dict:
    """The examples phase: each of EXAMPLES run on the card, each of its
    patterns matched by a printed line, each of its kernels launched; a line
    per twin with its printed lines, launches and seconds. Returns the
    phase's launches."""
    launches = {k: 0 for k in KERNELS}
    bad = []
    for spec in EXAMPLES:
        lines, counts, seconds = run_example(spec)
        missing = [p for p in spec["lines"] if not any(re.search(p, ln) for ln in lines)]
        idle = [k for k in spec["kernels"] if counts[k] == 0]
        emit({"phase": "examples", "example": f"examples/torch_{spec['name']}.py", "args": list(spec["args"]),
              "device": str(dev), "printed": lines, "launches": {k: n for k, n in counts.items() if n},
              "lines_missing": missing, "kernels_idle": idle, "seconds": seconds})
        if missing or idle:
            bad.append(f"torch_{spec['name']}.py: lines missing {missing}, kernels not launched {idle}")
        for k, n in counts.items():
            if k in launches:
                launches[k] += n
        free_card()
    if bad:
        raise AssertionError("the examples' twins fail their checks: " + "; ".join(bad))
    return launches


#: the helpers phase's slice of the eval volume: tuples a lane, 4 lanes
HELPERS_TUPLES = 4096


def run_helpers(dev) -> dict:
    """The helpers phase: the port of the reference's last public helpers
    on the card, each against the CPU path on the same inputs. Returns the
    launches of the roundtrips and the compress (not the timed B1+B4
    launches)."""
    from repro_torch.core.algorithms import PAPER_TABLE1

    t0 = time.perf_counter()
    n = 4 * HELPERS_TUPLES
    data = {"rovio": make_dataset("rovio", n_tuples=EVAL_BYTES // 16, seed=7).stream()[:n],
            "ecg": ecg_stream(EVAL_BYTES // 4)[:n]}
    torch.cuda.synchronize()
    ops.reset_launches()
    bad, codecs = [], {}
    for name in ("raw32",) + tuple(PAPER_TABLE1.values()):
        # each codec as the path phase configures it (its first config there)
        fields, dataset = next((f, d) for c, f, _, d in PATH_CONFIGS if c.split("/")[0].split("+")[0] == name)
        spec = JobSpec(**fields)
        if dataset == "ecg":
            spec = spec.calibrated(data["ecg"][:CALIBRATION_TUPLES])  # the path phase's sample
        codec = make_codec(name, **spec.codec_kwargs)
        x = data[dataset].reshape(4, HELPERS_TUPLES)
        card = bits.u32_numpy(codec.roundtrip(bits.u32_tensor(x, dev)))
        cpu = bits.u32_numpy(codec.roundtrip(bits.u32_tensor(x, "cpu")))
        err = int(np.abs(card.astype(np.int64) - x.astype(np.int64)).max())
        bound = codec.error_bound()
        _, enc_card = codec.encode(codec.init_state(4, dev), bits.u32_tensor(x, dev))
        _, enc_cpu = codec.encode(codec.init_state(4, torch.device("cpu")), bits.u32_tensor(x, "cpu"))
        total = enc_card.total_bits
        ok = (np.array_equal(card, cpu) and (codec.meta.lossy or err == 0)
              and (bound is None or err <= bound) and total.device.type == "cuda"
              and int(total) == int(enc_cpu.total_bits))
        codecs[name] = {"dataset": dataset, "lossy": codec.meta.lossy, "max_abs_err": err,
                        "error_bound": bound, "total_bits": int(total), "equals_cpu": ok}
        if not ok:
            bad.append(name)
    spec = JobSpec(codec="rle")
    values = data["rovio"][: 5 * 2048 * 4 + 777]
    card_pipe, cpu_pipe = CompressionPipeline(spec, device=dev), CompressionPipeline(spec, device="cpu")
    views = card_pipe.execute(card_pipe.shape_blocks(values), collect_payload=True).compacted.block_payloads()
    want = cpu_pipe.execute(cpu_pipe.shape_blocks(values), collect_payload=True).compacted.block_payloads()
    blocks_ok = len(views) == len(want) and all(
        a.nbits == b.nbits and a.valid == b.valid and np.array_equal(a.words, b.words)
        and np.array_equal(a.bitlen, b.bitlen) for a, b in zip(views, want))
    if not blocks_ok:
        bad.append("block_payloads")
    dims = (28, 4, 2048, 8, 128)  # qwen3-1.7b's ring at the lm phase's batch and prompt
    cache = kvcache.init_cache(*dims)
    want_bytes = 2 * math.prod(dims) + 2 * 4 * math.prod(dims[:2] + (dims[2] // kvcache.SCALE_GROUP, dims[3])) + 4
    cache_ok = (cache.k_codes.is_cuda and cache.window == dims[2]
                and kvcache.cache_bytes(cache) == want_bytes == kvcache.cache_bytes(cache.tensors()))
    if not cache_ok:
        bad.append("init_cache")
    del cache
    torch.cuda.synchronize()
    counts = ops.launch_counts()  # the helpers' own launches; the timed one below is a measurement
    rng = np.random.default_rng(11)
    blen = torch.from_numpy(rng.integers(0, 33, 16 * 2048).astype(np.int32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, 2**31, (16 * 2048, 2)).astype(np.int32)).to(dev)
    codes[:, 1] = 0
    codes[:, 0] &= ((1 << blen.long()) - 1).int()
    got, secs = metrics.timed(ops.pack_blocks_meta7, codes, blen, 2048, 2 * 2048 + 2, warmup=2, iters=10)
    plain = ref.pack_blocks_ref(codes.cpu(), blen.cpu(), 2048, 2 * 2048 + 2) + (
        ref.pack_meta7_ref(blen.cpu().reshape(16, 2048)),)
    timed_ok = secs > 0 and all(torch.equal(g.cpu(), w) for g, w in zip(got, plain))
    if not timed_ok:
        bad.append("timed")
    emit({"phase": "helpers", "device": str(dev), "roundtrip": codecs, "block_payloads": len(views),
          "block_payloads_equal_cpu": blocks_ok, "init_cache": {"dims": list(dims), "cache_bytes": want_bytes,
                                                                 "ok": cache_ok},
          "timed_pack_blocks_meta7_ms": secs * 1e3, "launches": {k: v for k, v in counts.items() if v},
          "seconds": time.perf_counter() - t0})
    if bad:
        raise AssertionError(f"the helpers disagree on the card: {bad}")
    return counts


def keep_freed_host_memory() -> dict:
    """This process's own allocator: glibc serves every host allocation
    from its heap (M_MMAP_MAX 0) and keeps what is freed there (M_TRIM_
    THRESHOLD at its largest) until a phase ends (`end_phase`). The CPU
    halves of the card-vs-CPU checks allocate and free tensors of up to GBs
    at full width; by default glibc maps each afresh and returns it when
    freed, so every one is faulted in page by page again. Returns mallopt's
    answers (1 each: accepted)."""
    import ctypes.util

    libc = ctypes.CDLL(ctypes.util.find_library("c"))
    m_trim_threshold, m_mmap_max = -1, -4
    got = {"M_MMAP_MAX": libc.mallopt(m_mmap_max, 0), "M_TRIM_THRESHOLD": libc.mallopt(m_trim_threshold, 2**31 - 1)}
    if not all(v == 1 for v in got.values()):
        raise RuntimeError(f"glibc refused the allocator settings: {got}")
    return got


def end_phase(name: str, t0: float) -> None:
    """A phase's closing line: its seconds, this process's peak host memory
    so far and its resident memory once the heap's free pages are handed
    back (glibc's `malloc_trim`, so that a later phase's allocations do
    not sit in holes an earlier one left)."""
    import ctypes.util

    ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim(0)
    with open("/proc/self/statm") as f:
        rss = int(f.read().split()[1]) * resource.getpagesize()
    emit({"phase": name, "seconds": time.perf_counter() - t0,
          "peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024, "rss_bytes": rss})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    malloc = keep_freed_host_memory()
    t_start = t0 = time.perf_counter()
    build.library()
    log = build.build_log()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    tc_log = log.split("== flash_attn_tc.cu")[-1].split("\n== ")[0]
    flash_tc = {
        "ptxas": [ln.strip() for ln in tc_log.splitlines() if "Used" in ln or "spill" in ln],
        "smem_bytes": {dh: flash_attn.tc_smem_bytes(dh) for dh in (64, 128, 256)},
        "injected_warpgroup_arrives": tc_log.count("C7519"),
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": regs, "flash_tc": flash_tc,
          "torch": torch.__version__, "cuda": torch.version.cuda, "numpy": np.__version__, "mallopt": malloc})

    t0 = time.perf_counter()
    err = check_kernels(dev)
    bad = {k: v for k, v in err.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    emit({"phase": "kernels", "bit_exact": True, "max_abs_err": {k: v for k, v in err.items() if k not in LM_KERNELS},
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    flash_err = check_flash(dev)
    dh256_err, dh256_lse_err = flash_err.pop(DH256), flash_err.pop(DH256_LSE)
    err.update(flash_err)
    emit({"phase": "flash", "within_tolerance": True, "max_abs_err": flash_err,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    eval_launches = run_path(dev)
    emit({"phase": "path", "launches": eval_launches, "seconds": time.perf_counter() - t0})
    full_values = {
        "rovio": make_dataset("rovio", n_tuples=FULL_BYTES // 16, seed=7).stream(),
        "ecg": ecg_stream(FULL_BYTES // 4),
    }
    launches = {k: 0 for k in KERNELS}
    frames = {}
    for name, (_, _, dataset) in FULL_SPECS.items():
        counts, frames[name] = run_full(dev, name, full_values[dataset])
        for k, n in counts.items():
            launches[k] += n
    for k, e in check_lane_kernels_full(dev, full_values["ecg"]).items():
        err[k] = max(err[k], e)
    t0 = time.perf_counter()
    for run in (run_api_dict, run_api_adaptive):
        for k, n in run(dev, full_values["rovio"]).items():
            launches[k] += n
    end_phase("api", t0)
    t0 = time.perf_counter()
    gang_launches, serve_gang = run_gang(dev, full_values)
    for k, n in gang_launches.items():
        launches[k] += n
    end_phase("gang", t0)
    t0 = time.perf_counter()
    for k, n in run_fleet(dev, full_values["rovio"], serve_gang).items():
        launches[k] += n
    end_phase("fleet", t0)
    t0 = time.perf_counter()
    check_lm_card_vs_cpu(dev)
    lm_launches, model, prompts = run_lm(dev)
    for k, n in lm_launches.items():
        launches[k] += n
    end_phase("lm", t0)
    t0 = time.perf_counter()
    check_train_card_vs_cpu(dev)
    check_train_feed(dev)
    check_grad_codec(dev)
    train_launches, train_times = run_train(dev, sleep_cycles_per_ms())
    for k, n in train_launches.items():
        launches[k] += n
    run_train_drill(dev)
    end_phase("train", t0)
    missing = [k for k, n in launches.items() if n == 0 and k not in OFF_PATH + EVAL_ONLY]
    if missing:
        raise AssertionError(f"the main paths did not launch: {missing}")

    t_timing = time.perf_counter()
    times = time_kernels(dev, full_values, frames["heavy"])
    for k, t in time_unstaged(dev, sleep_cycles_per_ms()).items():
        times[k].update(t)
    for k, t in times.items():
        err[k] = max(err[k], t["max_abs_err"], t.get("unstaged_max_abs_err", 0))
    bad = {k: v for k, v in err.items() if v != 0 and k not in LM_KERNELS}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions at the main paths' shapes: {bad}")
    times.update(time_flash(dev, model, prompts, sleep_cycles_per_ms()))
    times.update(train_times)
    for k in LM_KERNELS:
        err[k] = max(err[k], times[k]["max_abs_err"])
    del model, prompts
    emit({"phase": "timing", "seconds": time.perf_counter() - t_timing, "kernels": {
        k: {key: v for key, v in t.items() if key != "max_abs_err"} for k, t in times.items()
    }})
    t0 = time.perf_counter()
    for k, n in run_moe(dev).items():
        launches[k] += n
    end_phase("moe", t0)
    t0 = time.perf_counter()
    rec_launches, dh256_launches, times[DH256] = run_recurrent(dev)
    for k, n in rec_launches.items():
        launches[k] += n
    end_phase("recurrent", t0)
    launches[DH256], eval_launches[DH256] = dh256_launches, 0
    err[DH256] = max(dh256_err, times[DH256]["max_abs_err"])
    t0 = time.perf_counter()
    fe_launches, cap_err, launches[SOFTCAP], fe_times = run_frontends(dev)
    for k, n in fe_launches.items():
        launches[k] += n
    for k, e in cap_err.items():
        err[k] = max(err.get(k, 0.0), e)
    err[SOFTCAP] = max(err[SOFTCAP], fe_times[SOFTCAP]["max_abs_err"])
    times[SOFTCAP], eval_launches[SOFTCAP] = fe_times[SOFTCAP], 0
    end_phase("frontends", t0)
    t0 = time.perf_counter()
    for k, n in run_mesh(dev).items():
        launches[k] += n
    end_phase("mesh", t0)
    tp_launches, tp_dh256 = run_tp(dev)
    for k, n in tp_launches.items():
        launches[k] += n
    launches[DH256] += tp_dh256
    tt_launches, launches[DH256_LSE], times[DH256_LSE] = run_tp_train(dev)
    for k, n in tt_launches.items():
        launches[k] += n
    eval_launches[DH256_LSE] = 0
    err[DH256_LSE] = max(dh256_lse_err, times[DH256_LSE]["max_abs_err"])
    t0 = time.perf_counter()
    for k, n in run_examples(dev).items():
        launches[k] += n
    end_phase("examples", t0)
    t0 = time.perf_counter()
    for k, n in run_helpers(dev).items():
        launches[k] += n
    end_phase("helpers", t0)
    end_phase("host", t_start)
    emit({"kernels": [
        {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "eval_launches": eval_launches[name], "max_abs_err": err[name],
            "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
            "library_ms": times[name].get("library_ms"), "host_ms": times[name]["host_ms"],
            "chain_steps": times[name]["chain_steps"],
            **{k: times[name][k] for k in ("never_converging_ms", "never_converging_serial_ms",
                                           "per_block_ms", "per_block_busy_ms", "route_ms",
                                           "contract_route_ms", "lse_max_abs_err",
                                           "plain_backward_ms", "library_flash_causal_ms", "uncapped_ms",
                                           "unstaged_ms", "unstaged_plain_ms", "unstaged_bound_ms",
                                           "unstaged_symbols")
               if k in times[name]},
        }
        for name, (src, replaces) in {**KERNELS, DH256: KERNELS["flash_attention_fwd_tc"],
                                      SOFTCAP: KERNELS["flash_attention_fwd_tc"],
                                      DH256_LSE: KERNELS["flash_attention_fwd_lse"]}.items()
    ]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
