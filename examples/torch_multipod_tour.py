"""Distribution-layer tour on the PyTorch port: sharded compression,
compressed cross-pod gradient sync, elastic remesh. The twin of
`examples/multipod_tour.py`, with the same printed lines.

The reference forces 8 host devices through an XLA flag. Here a mesh names
its slots (`runtime/elastic.py`): 8 slots on the caller's device (a CUDA
card unless told otherwise), each running as its own device would, with its
own shard and its own kernel launches.

Run:  PYTHONPATH=src python examples/torch_multipod_tour.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.algorithms import make_codec
from repro_torch.core.engine import sharded_compress_fn
from repro_torch.core.gradient import GradCompressionConfig, compressed_grad_sync
from repro_torch.data.datasets import make_dataset
from repro_torch.runtime.elastic import ElasticSession, make_mesh, reshard
from repro_torch.runtime.sharding import gather

SLOTS = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="the device every mesh slot runs on")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    slots = [dev] * SLOTS
    print(f"devices: {len(slots)}")

    # --- 1. pod-sharded stream compression (private vs shared state) -----
    # the frozen-dictionary codec hits from the second micro-batch on, so
    # feed a few sequential blocks and report the warmed-up ratio
    mesh = make_mesh((SLOTS,), ("data",), devices=slots)
    stream = make_dataset("rovio", n_tuples=1 << 15).stream()
    lanes, B, n_blocks = 8, 1024, 8
    blocks = torch.from_numpy(stream[: n_blocks * lanes * B].view(np.int32).reshape(n_blocks, lanes, B)).to(dev)

    for shared in (False, True):
        fn = sharded_compress_fn("tdic32", mesh, axis="data", shared_state=shared)
        state = make_codec("tdic32").init_state(lanes, dev)
        bits_last = None
        for i in range(n_blocks):
            state, _, bits_last = fn(state, blocks[i])
        ratio = blocks[0].numel() * 32 / float(bits_last)
        print(f"[1] sharded tdic32 ({'shared' if shared else 'private'} state): "
              f"warmed-up ratio {ratio:.2f} across {SLOTS} devices")

    # --- 2. compressed cross-pod gradient sync ----------------------------
    # each slot holds the whole gradient as it sees it; the spec cuts the
    # pod-split dim into one slice per pod, and each pod's slice is
    # averaged with the other pod's
    mesh2 = make_mesh((2, 4), ("pod", "data"), devices=slots)
    g = torch.from_numpy(np.random.default_rng(0).normal(0, 0.01, (4, 256)).astype(np.float32)).to(dev)
    out = compressed_grad_sync([{"w": g}] * mesh2.size, mesh2, axis="pod",
                               cfg=GradCompressionConfig(qbits=8),
                               param_specs={"w": ("pod",)})
    want = (g[:2] + g[2:]) / 2
    err = float((out[0]["w"][:2] - want).abs().max())
    print(f"[2] compressed pod gradient sync: max err {err:.2e} "
          f"(uint8 on the wire = 4x less inter-pod traffic)")

    # --- 3. elastic remesh -------------------------------------------------
    sess = ElasticSession(n_devices=SLOTS, devices=slots)
    specs = {"w": ("data", None)}
    w = reshard({"w": torch.arange(32.0, device=dev).reshape(8, 4)}, specs, sess.mesh, sess.mapping)
    sess.resize(4, devices=slots[:4])  # lose half the fleet
    w2 = reshard(w, specs, sess.mesh, sess.mapping)
    intact = torch.equal(gather(w2)["w"], gather(w)["w"])
    print(f"[3] elastic remesh 8->4 devices: mesh {dict(zip(sess.mesh.axis_names, sess.mesh.shape))}, "
          f"data intact: {intact}")


if __name__ == "__main__":
    main()
