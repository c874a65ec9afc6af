"""Rollout runners of the port."""
