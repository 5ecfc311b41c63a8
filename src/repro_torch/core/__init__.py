"""Host constants and plain-PyTorch datapaths of the port."""
