"""Environments of the port; importing registers the built-ins."""
from repro_torch.envs import (powergrid, supplychain, traffic,  # noqa: F401
                              warehouse)
