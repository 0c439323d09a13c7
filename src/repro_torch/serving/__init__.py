"""Serving of the port: the slot engine over ``models/lm.py``."""
