"""Runtime: ingest corrections, the per-block Rx and Tx pipelines, the
session and its block FIFO."""
