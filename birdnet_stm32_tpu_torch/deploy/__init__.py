"""Deployment (port of birdnet_stm32_tpu/deploy/): the serving drivers'
configuration (deploy/config.py: CLI > env > file precedence, JSON or TOML)
and the firmware headers of a bundle (deploy/headers.py)."""
