"""Launchers: ``python -m repro_torch.launch.serve`` (batched LM generation
and the Viterbi decode path) and ``python -m repro_torch.launch.train`` (the
fault-tolerant training loop on one device), and the mesh constructors
(``launch/mesh.py``).  The dry run waits for ROADMAP item 11."""
