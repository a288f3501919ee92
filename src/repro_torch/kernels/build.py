"""Build and load the CUDA kernels of `repro_torch/csrc/` (Hopper, sm_90a).

The sources compile with `nvcc` into one shared library with a plain C
interface, loaded with `ctypes`. The build runs at first use, one `nvcc -c`
per source started together, then one link, into
`build/repro_torch/<hash>/` beside the package's source tree (a directory
`.gitignore` lists), keyed by a hash of the sources and the flags, so an
edited source rebuilds and an unchanged one loads the cached library.

Nothing here runs at import time: the CPU tests import every module of the
package on machines without `nvcc` or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
#: <repo>/build/repro_torch for a source checkout (src/repro_torch/kernels/..)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
#: C entry point -> argument types (pointers and the stream as void*)
SIGNATURES: Dict[str, List[type]] = {
    "repro_pack_blocks": [_P, _P, _I, _I, _I, _P, _P, _P],
    "repro_pack_blocks_meta7": [_P, _P, _I, _I, _I, _P, _P, _P, _P],
    "repro_unpack_blocks": [_P, _I, _I, _P, _I, _P, _P],
    "repro_compact_blocks": [_P, _P, _I, _I, _P, _P, _P],
    "repro_pack_meta7_blocks": [_P, _I, _I, _I, _P, _P],
    "repro_dict_probe": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "repro_dict_chunk_encode": [_P] * 5 + [_I] * 4 + [_P] * 7,
    "repro_dict_chunk_decode": [_P] * 5 + [_I] * 4 + [_P] * 6,
    "repro_rans_encode": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "repro_rans_decode": [_P, _L, _L, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "repro_rans_section_walk": [_P, _L, _P, _P, _P, _P, _P, _P],
    "repro_rans_section_copy": [_P, _P, _P, _L, _P, _P],
    "repro_rans_section_decode": [_P, _L, _L, _P, _P, _P, _P, _L, _P, _P],
    "repro_adpcm_tile_encode": [_P, _I, _I, _I, _F, _P, _P, _I, _P, _P],
    "repro_adpcm_tile_decode": [_P, _I, _I, _I, _P, _P, _I, _P, _P],
    "repro_adpcm_lane_encode": [_P, _I, _I, _I, _P, _P, _U, _F, _F, _P, _P, _I, _I, _P, _P, _P, _P],
    "repro_adpcm_lane_encode_scratch": [_I, _I, _I],
    "repro_adpcm_lane_encode_serial": [_P, _I, _I, _I, _P, _P, _U, _F, _F, _P, _P, _I, _I, _P, _P, _P],
    "repro_adpcm_lane_decode": [_P, _I, _I, _I, _P, _P, _U, _F, _P, _P, _I, _P, _P, _P],
    "repro_adpcm_lane_decode_scratch": [_I, _I],
    "repro_adpcm_lane_decode_serial": [_P, _I, _I, _I, _P, _P, _U, _F, _P, _P, _I, _P, _P],
    "repro_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "repro_flash_fwd_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "repro_flash_fwd_tc_smem": [_I],
}

#: entry points that return something other than a cudaError_t int
RESTYPES: Dict[str, type] = {
    "repro_adpcm_lane_encode_scratch": _L,
    "repro_adpcm_lane_decode_scratch": _L,
}

_lib: Optional[ctypes.CDLL] = None
#: seconds the last `library()` call spent building (0.0 when cached)
last_build_s = 0.0


def sources() -> List[Path]:
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the repro_torch "
        "CUDA kernels are built from csrc/ at first use"
    )


def build() -> Path:
    """Compile the sources (in parallel) and link the library; return its
    path. A no-op when the library for this source hash exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp-"))
    try:
        objs, procs = [], []
        for src in (p for p in sources() if p.suffix == ".cu"):
            obj = tmp / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        log, failed = [], []
        for src, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
        link = subprocess.run(
            [exe, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *map(str, objs), "-o", str(tmp / LIB_NAME)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(log))
        if not out_dir.exists():  # another process may have finished first
            os.replace(tmp, out_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def build_log() -> str:
    """`nvcc -Xptxas -v` output of the current build (registers, shared
    memory and spills per kernel), or '' before the first build."""
    p = BUILD_ROOT / source_hash() / "build.log"
    return p.read_text() if p.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use (process-wide: a
    shared library is loaded once per process)."""
    global _lib, last_build_s
    if _lib is None:
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        last_build_s = time.perf_counter() - t0
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (launch refused, too
    much shared memory, invalid configuration)."""
    if err != 0:
        import torch

        name = torch.cuda.get_device_name() if torch.cuda.is_available() else "no device"
        raise RuntimeError(f"CUDA kernel {what} failed to launch: cudaError {err} on {name}")
