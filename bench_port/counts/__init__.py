"""Frozen roofline arithmetic (see ``bounds.py``)."""
