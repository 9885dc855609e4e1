"""Launch tools of the port (``repro/launch``): the analytic FLOP model
(``analytics``), the production and host meshes (``mesh``), abstract
inputs with their shardings for every arch x shape cell (``specs``) and
the production training script (``train``: ``python -m
repro_torch.launch.train``).  The dry run and its HLO cost and memory
analysis (``dryrun``, ``hlo_cost``, ``hlo_analysis``) are the second half
of ROADMAP A8, not ported yet: XLA's compiled HLO has no counterpart
here, so theirs has to be designed."""
