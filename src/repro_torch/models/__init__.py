"""The dense transformer LM of the port: layers, attention, the model."""
