"""Data helpers of the port (port of birdnet_stm32_tpu/data): the mu-law
encode, the decodable audio extensions and the species-list readers."""
