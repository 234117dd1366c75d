"""Launchers of the LM scaffolding: ``serve`` (the batched serving driver,
``python -m repro_torch.launch.serve``), ``train`` (the training driver,
``python -m repro_torch.launch.train``), ``mesh`` (the logical meshes
the sharding rules resolve against, and the card's constants), and the
dry-run tools: ``flops`` (what a step executes, counted on meta
tensors), ``roofline`` (its roofline terms) and ``dryrun`` (every (arch
× shape × mesh) cell, ``python -m repro_torch.launch.dryrun``)."""
