"""Sharding of the crypto serving tensors over a device mesh: the
partition rules (:mod:`repro_torch.sharding.partition`) and the explicit
reshards of a serving policy (:mod:`repro_torch.sharding.ctx`)."""
