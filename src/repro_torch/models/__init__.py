"""The LM stack's models (port of ``repro.models`` without MoE): shared
layers, the dense transformer, mamba2's SSD, the zamba2 hybrid, the
seamless encoder-decoder and the family dispatch (``model``)."""
