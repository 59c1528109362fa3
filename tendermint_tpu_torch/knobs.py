"""The port's environment knobs, prefix ``TM_CUDA_``.

Counterpart of ``tendermint_tpu/utils/knobs.py`` for the port: each knob
has a name, a default and a line of help, and ``read`` resolves it from
the environment every time it is called.  Nothing reads a knob when a
module is imported or an object is built, so a change of the environment
between two calls takes effect at the second.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    name: str
    default: str
    doc: str


KNOBS = (
    Knob("TM_CUDA_RLC", "0",
         "1 verifies each batch through the RLC batch equation (kernels ed25519_rlc and "
         "rlc_fold) with the exact per-row fallback; the counterpart of TM_TPU_RLC"),
    Knob("TM_CUDA_FIELD_IMPL", "auto",
         "field layout of the verify kernel: int64 (5 x 51-bit limbs), packed (10 x "
         "25.5-bit), f32 (51 x 5-bit floats) or auto (int64 on the CPU; on the card the "
         "first layout that passes the golden batch); the counterpart of TM_TPU_FIELD_IMPL"),
    Knob("TM_CUDA_BASE_MXU", "0",
         "1 computes [s]B by the w=8 comb with its selection on the tensor cores (int64 "
         "and f32 layouts, once it passes the golden batch); the counterpart of "
         "TM_TPU_BASE_MXU"),
)
KNOWN = {k.name: k for k in KNOBS}


def read(name: str) -> str:
    """The knob's value now: the environment's, else its default.  An
    unregistered name raises KeyError."""
    if name not in KNOWN:
        raise KeyError(f"unregistered knob {name}")
    return os.environ.get(name, KNOWN[name].default)
