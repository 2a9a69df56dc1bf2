"""Decoder models: parameters, layers, attention, the rwkv6 layers
(``ssm.py``), the model."""
