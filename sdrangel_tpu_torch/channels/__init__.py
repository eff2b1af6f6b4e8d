"""Rx channels (demodulators), Tx channels (modulators, the CW keyer) and
their registry."""
