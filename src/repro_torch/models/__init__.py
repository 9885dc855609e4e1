"""Models of the port: the MLP and CNN classifiers of the FL experiments,
and the LM serving path (attention family and rwkv6) of
``transformer.py``."""
from .transformer import (forward, init_decode_state, init_params,
                          params_from_numpy, prefill_step, serve_step)
