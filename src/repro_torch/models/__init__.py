"""Model substrate of the port: configs, layers, the dense model."""
