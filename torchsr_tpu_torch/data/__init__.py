"""Training data: image discovery, uint8 crop loaders, device synthesis."""
