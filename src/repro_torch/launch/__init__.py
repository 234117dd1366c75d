"""Launchers of the LM scaffolding: ``serve`` (the batched serving driver,
``python -m repro_torch.launch.serve``), ``train`` (the training driver,
``python -m repro_torch.launch.train``) and ``mesh`` (the logical meshes
the sharding rules resolve against, and the card's constants). The dry
run and the FLOP/HLO accounting are ROADMAP A15 (3) (d3)."""
