"""Launching the LLM zoo: the production meshes, meta-tensor input specs,
the training launcher (``python -m repro_torch.launch.train``) and the dry
run over every (arch x shape x mesh) cell (``python -m
repro_torch.launch.dryrun``)."""
