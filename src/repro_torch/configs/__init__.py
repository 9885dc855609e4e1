"""Model configurations (copies of the JAX package's pure-Python ones):
the LM architectures (``ModelConfig``, ``SHAPES``, ``get_config``,
``list_archs``) and the thesis' CNN (``paper_cnn``)."""
from .base import ModelConfig, SHAPES, get_config, list_archs
