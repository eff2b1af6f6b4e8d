"""Rx runtime: ingest corrections and the per-block pipeline engine."""
