"""Model definitions of the port: config, decoder, LoRA, conversion, sampling."""
