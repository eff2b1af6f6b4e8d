"""Rx channels (demodulators) and their registry."""
