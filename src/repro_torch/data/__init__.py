from .synth import federated_split, make_classification_dataset
