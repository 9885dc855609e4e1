"""Fault injection, elastic pools and seeded chaos for the FL runtime."""
from .faults import ElasticPool, FaultInjector
