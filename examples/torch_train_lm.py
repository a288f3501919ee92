"""End-to-end training on the PyTorch port: train a ~100M-parameter
qwen3-family model for a few hundred steps with every production substrate
engaged — the CStream-compressed data feed (decoded on the card by B2),
microbatched AdamW, async checkpoints, an injected mid-run node failure
(recovered automatically), and exact resume. The twin of
`examples/train_lm.py`: the same arguments and printed lines, on a CUDA
card unless told otherwise.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]
(--small drops to ~10M parameters for a fast demo.)
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_arch
from repro_torch.launch.train import train
from repro_torch.models.config import ModelConfig


def config_100m() -> ModelConfig:
    # qwen3-family block at ~100M params: 12L x 512d x 8H, 32k vocab
    base = get_arch("qwen3-1.7b").model
    return dataclasses.replace(
        base,
        name="qwen3-100m",
        n_layers=12,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        d_ff=1536,
        head_dim=64,
        vocab_size=32_768,
        remat="none",
    )


def config_small() -> ModelConfig:
    return dataclasses.replace(
        config_100m(), name="qwen3-10m", n_layers=4, d_model=256, d_ff=768, vocab_size=8192
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None, help="inject a node failure")
    ap.add_argument("--device", default="cuda", help="where the model, the feed's decode and the kernels run")
    args = ap.parse_args(argv)

    cfg = config_small() if args.small else config_100m()
    n = cfg.param_count()
    print(f"training {cfg.name}: {n/1e6:.1f}M params, {args.steps} steps "
          f"@ batch {args.batch} x seq {args.seq}")

    fail_at = (args.fail_at,) if args.fail_at else (args.steps // 2,)
    with tempfile.TemporaryDirectory() as ckpt:
        run = train(
            cfg,
            steps=args.steps,
            batch=args.batch,
            seq=args.seq,
            lr=6e-4,
            microbatches=2,
            checkpoint_dir=ckpt,
            checkpoint_every=25,
            fail_at=fail_at,
            log_every=20,
            device=args.device,
        )
    print(f"\nloss {run.losses[0]:.3f} -> {run.losses[-1]:.3f} over {run.final_step} steps")
    print(f"throughput {run.tokens_per_s:.0f} tok/s; feed compression {run.feed_ratio:.2f}x; "
          f"restarts {run.restarts} (injected), stragglers flagged {run.stragglers}")
    assert run.losses[-1] < run.losses[0], "training must reduce loss"


if __name__ == "__main__":
    main()
