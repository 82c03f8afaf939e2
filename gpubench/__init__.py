"""The benchmark of the PyTorch and CUDA port (birdnet_stm32_tpu_torch).

`python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of BENCHMARK.json once on the cards of the machine it
starts on. Configurations (configs/), traffic mixes (traffic/) and
per-layer metric readers (metrics/) are one file each, found by name; the
plain reference (reference/) and the fixed arithmetic (yardstick/) import
nothing of the port. It imports neither JAX nor the JAX package.
"""
