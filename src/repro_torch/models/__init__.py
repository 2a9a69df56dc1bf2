"""Dense decoder: parameters, layers, attention, the model."""
