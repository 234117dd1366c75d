"""Launchers of the LM scaffolding: ``serve`` (the batched serving driver,
``python -m repro_torch.launch.serve``). Training, the dry run, the mesh
and the FLOP/HLO accounting come with ROADMAP A15, slices 2 and 3."""
