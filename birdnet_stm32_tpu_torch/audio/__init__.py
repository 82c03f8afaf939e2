"""Audio file I/O of the port (port of birdnet_stm32_tpu/audio)."""
