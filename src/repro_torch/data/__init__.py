from .lm import synthetic_token_batches
from .synth import federated_split, make_classification_dataset
