"""Models of the port: the MLP classifier of the FL experiments."""
