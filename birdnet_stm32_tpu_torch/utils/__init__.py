"""Utilities of the port (port of birdnet_stm32_tpu/utils)."""
