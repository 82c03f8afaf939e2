"""Evaluation helpers of the port (port of birdnet_stm32_tpu/evaluation)."""
