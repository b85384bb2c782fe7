"""Microbenchmarks of per-lane table access on the CUDA card: the port of
the TPU microbenchmarks in the repository's ``experiments/`` directory."""
