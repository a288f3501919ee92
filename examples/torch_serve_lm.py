"""Serving on the PyTorch port: batched prefill + autoregressive
decode with the NUQ-compressed KV cache, compared against the raw bf16
cache — the paper's lossy-compression trade on the LM serving path. The
twin of `examples/serve_lm.py`: the same arguments and printed lines, on a
CUDA card unless told otherwise (the prefill's attention is B10's kernel
there, its plain version on the CPU).

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--arch qwen3-1.7b] [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.configs import get_arch
from repro_torch.launch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--device", default="cuda", help="where the model and kernels run")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch).model.reduced()
    for kv_quant in (True, False):
        c = dataclasses.replace(cfg, kv_quant=kv_quant)
        run = serve(c, batch=args.batch, prompt_len=args.prompt_len, gen=args.gen,
                    cache_len=args.prompt_len + args.gen, device=args.device)
        kind = "NUQ-quantized" if kv_quant else "raw bf16    "
        extra = ""
        if kv_quant and run.cache_bytes_raw_equiv:
            extra = f"  ({run.cache_bytes_raw_equiv/run.cache_bytes:.2f}x smaller than raw)"
        print(f"{kind} cache: {run.decode_tok_per_s:7.1f} tok/s decode, "
              f"prefill {run.prefill_s*1e3:6.1f} ms, cache {run.cache_bytes/1e6:.2f} MB{extra}")
        print(f"  sample tokens: {run.tokens[0, :10].tolist()}")


if __name__ == "__main__":
    main()
