"""Probe scripts of the port, the counterparts of the repository's
``scripts/``: ``python -m pycolmap_torch.scripts.proto_gather`` runs the
Hopper gather probe on the card."""
