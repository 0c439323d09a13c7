"""Training: data, optimizer, train step and checkpoints (the counterparts
of the reference's ``repro/training``)."""
