"""Environments of the port; importing registers the built-ins."""
from repro_torch.envs import warehouse  # noqa: F401
