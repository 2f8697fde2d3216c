"""Kernels and their plain versions: the Philox stream, the collision
resolver and the fused rollout / collector kernels."""
