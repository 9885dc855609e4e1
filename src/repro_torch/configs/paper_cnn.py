"""The thesis' own workloads (§4.2.4): small CNN/MLP classifiers for the FL
experiments (MNIST-class / CIFAR-class). Reimplemented in JAX for the
reproduction benchmarks; shapes follow Listing 4.1.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class CNNConfig:
    name: str
    image_hw: int          # 28 (MNIST-class) or 32 (CIFAR-class)
    channels: int          # 1 or 3
    conv1: int = 16
    conv2: int = 32
    n_classes: int = 10
    lr: float = 0.01


MNIST_CNN = CNNConfig(name="paper-mnist-cnn", image_hw=28, channels=1)
CIFAR_CNN = CNNConfig(name="paper-cifar-cnn", image_hw=32, channels=3, lr=0.005)

# Reduced-size stand-ins for the simulation benchmarks: same architecture
# family (conv-pool-conv-pool-fc), ~20x fewer FLOPs so hundreds of simulated
# FL rounds run in CPU-container time. The faithful MNIST/CIFAR shapes above
# are exercised by the unit tests.
FAST_MNIST_CNN = CNNConfig(name="fast-mnist-cnn", image_hw=16, channels=1,
                           conv1=8, conv2=16, lr=0.05)
FAST_CIFAR_CNN = CNNConfig(name="fast-cifar-cnn", image_hw=16, channels=3,
                           conv1=8, conv2=16, lr=0.03)
