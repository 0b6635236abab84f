"""PyTorch/CUDA port of the Viterbi decoding stack, for one NVIDIA H100.

Beside the JAX package ``repro`` (the reference it is held against), module
for module: ``core/`` (trellis tables, encoder, channels, ACS, sequential
oracle), ``kernels/`` (hand-written Hopper kernels under ``csrc/``, each
beside its plain PyTorch version; tile plans and the min-plus seam algebra),
``decode/`` (spec, registry, planner, ``decode``), ``stream/`` (the
sliding-window core and ``StreamSession``), ``obs/`` (telemetry) and
``convert.py`` (state bridge from the reference).

Entry points run on the card unless the caller asks for the CPU
(``DecodeContext(device="cpu")``, ``StreamSession(..., device="cpu")``),
where every kernel runs its plain version.  This package imports torch and numpy only — never jax, never
``repro``.
"""
