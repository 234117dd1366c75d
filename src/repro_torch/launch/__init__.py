"""Launchers of the LM scaffolding: ``serve`` (the batched serving driver,
``python -m repro_torch.launch.serve``) and ``train`` (the training
driver, ``python -m repro_torch.launch.train``). The dry run, the mesh and
the FLOP/HLO accounting come with ROADMAP A15, slice 3."""
