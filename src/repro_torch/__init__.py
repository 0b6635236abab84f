"""PyTorch/CUDA port of the Viterbi decoding stack, for one NVIDIA H100.

Beside the JAX package ``repro`` (the reference it is held against), module
for module: ``core/`` (trellis tables, encoder, channels, ACS, the plain
sequential, block-parallel and HMM decoders, the CRF), ``kernels/`` (hand-written Hopper kernels under ``csrc/``, each
beside its plain PyTorch version; tile plans and the (min,+) product and
seam algebra),
``decode/`` (spec, registry, planner, ``decode``), ``stream/`` (the
sliding-window core, ``StreamSession``, the continuous-batching
``StreamScheduler`` with online ingestion, snapshot/restore and the chaos
harness), ``siso/`` (RSC codes, interleavers, turbo), ``obs/`` (telemetry),
``configs/`` (the paper workload's codes, shapes and stream defaults),
``serve/`` and ``train/`` (the slot allocator and the straggler detector the
scheduler uses) and ``convert.py`` (state bridge from the reference).

Entry points run on the card unless the caller asks for the CPU
(``DecodeContext(device="cpu")``, ``StreamSession(..., device="cpu")``,
``StreamScheduler(..., device="cpu")``, ``turbo_decode(..., device="cpu")``),
where every kernel runs its plain version.  This package imports torch and numpy only — never jax, never
``repro``.
"""
