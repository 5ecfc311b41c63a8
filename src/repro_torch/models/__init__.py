"""The LM stack's models (port of ``repro.models``): shared layers with the
dropping MoE, the dense and MoE transformer, mamba2's SSD, the zamba2
hybrid, the seamless encoder-decoder and the family dispatch (``model``)."""
