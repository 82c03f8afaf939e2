"""Command-line verbs of the port (port of birdnet_stm32_tpu/cli)."""
