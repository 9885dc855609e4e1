"""The benchmark of the PyTorch/CUDA port (``repro_torch``): ``run.py`` is
its command, ``BENCHMARK.json`` at the root of the repository its cells."""
