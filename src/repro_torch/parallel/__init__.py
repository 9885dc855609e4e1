"""Device meshes of the port (``repro/parallel``): the aggregation
server's 1-D mesh, ``sharding.agg_mesh``."""
