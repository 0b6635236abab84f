"""Launchers: ``python -m repro_torch.launch.serve`` (batched LM generation
and the Viterbi decode path).  Training, the dry run and the mesh helpers
wait for ROADMAP items 11 and 9b."""
