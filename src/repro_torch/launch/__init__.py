"""Launch tools of the port (``repro/launch``): the analytic FLOP model
(``analytics``), the production and host meshes (``mesh``), abstract
inputs with their shardings for every arch x shape cell (``specs``), the
production training script (``train``: ``python -m
repro_torch.launch.train``) and the dry run (``dryrun``: ``python -m
repro_torch.launch.dryrun``) with its cost and memory analysis.  XLA's
compiled HLO has no counterpart here: ``hlo_cost`` counts a trace of the
eager step on fake tensors, and ``hlo_analysis`` turns it into the
reference's roofline terms and memory summary on the H100, with
collectives from a model of the cell's shardings."""
__all__ = ["analytics", "dryrun", "hlo_analysis", "hlo_cost", "mesh", "specs",
           "train"]
