"""Launchers: ``python -m repro_torch.launch.serve`` (batched LM generation
and the Viterbi decode path) and ``python -m repro_torch.launch.train`` (the
fault-tolerant training loop on one device).  The dry run and the mesh
helpers wait for ROADMAP items 11 and 9b."""
