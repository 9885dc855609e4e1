"""Durable federation runs (port of ``repro/checkpoint``): the atomic
checkpoint manager and the full-federation snapshot."""
from .manager import CheckpointManager
from .snapshot import FederationSnapshot

__all__ = ["CheckpointManager", "FederationSnapshot"]
