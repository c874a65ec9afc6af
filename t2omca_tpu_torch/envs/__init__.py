"""Environment of the port: the MEC-offload env, its normalizer, critic,
scenario distributions and registry."""
