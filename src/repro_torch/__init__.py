"""CStream in PyTorch for one NVIDIA H100: the port of the `repro` package.

Entry points run on `torch.device("cuda")` unless the caller passes
`device="cpu"`. The package imports torch and numpy only, never jax or
anything of `repro`. Modules mirror `repro`'s layout file for file.
"""
