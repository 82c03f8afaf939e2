"""Benchmark entry points of the port, run as modules
(`python -m birdnet_stm32_tpu_torch.scripts.<name>`)."""
