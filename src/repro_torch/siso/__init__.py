"""Soft-in/soft-out (SISO) codecs.

rsc.py        recursive systematic convolutional codes: the same butterfly
              as ConvCode, plus the weight and gather tables of the BCJR
              recursions; a torch encoder.
interleave.py block and QPP interleavers as hashable specs (numpy).
turbo.py      TurboSpec (the "turbo" code family) + the iterative
              extrinsic-exchange loop over two RSC SISO passes.

The kernels live in kernels/bcjr.py (alpha scan + fused beta/LLR scan,
csrc/bcjr.cu), exposed as kernels/ops.bcjr_llr_op; the registry backends
``bcjr`` and ``turbo`` (decode/backends.py) route here through the
planner's code-family rule.
"""
from repro_torch.siso.interleave import BlockInterleaver, QPPInterleaver
from repro_torch.siso.rsc import RSC_K3_75, RSC_K4_LTE, RSCCode
from repro_torch.siso.turbo import TurboResult, TurboSpec, turbo_decode

__all__ = [
    "BlockInterleaver",
    "QPPInterleaver",
    "RSCCode",
    "RSC_K3_75",
    "RSC_K4_LTE",
    "TurboResult",
    "TurboSpec",
    "turbo_decode",
]
