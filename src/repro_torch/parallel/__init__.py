"""Sharding recipes of the port (``repro/parallel``): the aggregation
server's 1-D mesh (``sharding.agg_mesh``) and the LM half's specs."""
from .sharding import (param_specs, batch_specs, state_specs, dp_axes,
                       named, to_named_tree, constrain_act, constrain_qkv,
                       current_mesh_axes)
