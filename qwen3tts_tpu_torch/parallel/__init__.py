"""Tensor- and data-parallel serving over ``torch.distributed``: the mesh,
the launcher, the parameter and KV-cache specs (``sharding.py``) and the
model's collectives (``collectives.py``)."""
