"""Launch-side helpers of the port: the analytic FLOP model."""
