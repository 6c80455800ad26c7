"""The A/B experiment's data: the seeded user simulator (``synthetic``) and
the training-data loader (``loader``), both host-side numpy."""
