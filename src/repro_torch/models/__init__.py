"""Models of the port: the MLP and CNN classifiers of the FL experiments,
and the LM zoo of ``transformer.py`` (attention with or without experts,
rwkv6, zamba2's mamba2 hybrid): serving and training steps."""
from .transformer import (forward, init_decode_state, init_params, loss_fn,
                          params_from_numpy, prefill_step, serve_step,
                          train_step)
