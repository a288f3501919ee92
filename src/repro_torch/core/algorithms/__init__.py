"""CStream's compression algorithms (paper Table 1), ported to PyTorch:
all ten, plus the raw32 bypass. The wire ids are the reference's, verbatim.
"""
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.algorithms.base import (
    Codec,
    CodecMeta,
    Encoded,
    accepted_params,
    check_codec_params,
    codec_factory,
    codec_names,
    make_codec,
)

# importing registers each codec
from repro_torch.core.algorithms import adpcm as _adpcm  # noqa: F401
from repro_torch.core.algorithms import dictionary as _dictionary  # noqa: F401
from repro_torch.core.algorithms import elias as _elias  # noqa: F401
from repro_torch.core.algorithms import leb128 as _leb128  # noqa: F401
from repro_torch.core.algorithms import pla as _pla  # noqa: F401
from repro_torch.core.algorithms import raw as _raw  # noqa: F401
from repro_torch.core.algorithms import rle as _rle  # noqa: F401

#: paper Table 1 names -> registry names
PAPER_TABLE1 = {
    "LEB128-NUQ": "leb128_nuq",
    "ADPCM": "adpcm",
    "UANUQ": "uanuq",
    "UAADPCM": "uaadpcm",
    "LEB128": "leb128",
    "Delta-LEB128": "delta_leb128",
    "Tcomp32": "tcomp32",
    "Tdic32": "tdic32",
    "RLE": "rle",
    "PLA": "pla",
}

#: stable wire-format codec identifiers (core/bits.py frame header). Append
#: only — renumbering breaks every previously written frame.
WIRE_CODEC_IDS = {
    "leb128_nuq": 1,
    "adpcm": 2,
    "uanuq": 3,
    "uaadpcm": 4,
    "leb128": 5,
    "delta_leb128": 6,
    "tcomp32": 7,
    "tdic32": 8,
    "rle": 9,
    "pla": 10,
    # extensions past paper Table 1 (paper_name is None in the capability
    # record): raw32 is the adaptive controller's bypass tier
    "raw32": 11,
}

#: reverse map: frame codec id -> registry name
WIRE_CODEC_NAMES = {v: k for k, v in WIRE_CODEC_IDS.items()}


def state_from_numpy(
    codec: Codec,
    state: Optional[Dict[str, Any]],
    device: torch.device,
) -> Optional[Dict[str, torch.Tensor]]:
    """A reference codec state (dict of numpy arrays, e.g. delta_leb128's
    `{"prev": uint32[lanes]}`) as this port's tensors on `device`. uint32
    fields become int32 tensors with the same bits."""
    if state is None:
        return None
    out = {}
    for k, v in state.items():
        a = np.ascontiguousarray(np.asarray(v))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(a.copy()).to(device)
    return out


def state_to_numpy(
    codec: Codec, state: Optional[Dict[str, torch.Tensor]]
) -> Optional[Dict[str, np.ndarray]]:
    """Inverse of `state_from_numpy`: the reference's numpy form, with each
    field in the dtype `codec.state_dtypes` declares for it."""
    if state is None:
        return None
    out = {}
    for k, t in state.items():
        a = t.detach().cpu().contiguous().numpy()
        want = codec.state_dtypes.get(k)
        out[k] = a.view(want) if want is not None else a
    return out


__all__ = [
    "Codec",
    "CodecMeta",
    "Encoded",
    "accepted_params",
    "check_codec_params",
    "codec_factory",
    "codec_names",
    "make_codec",
    "PAPER_TABLE1",
    "WIRE_CODEC_IDS",
    "WIRE_CODEC_NAMES",
    "state_from_numpy",
    "state_to_numpy",
]
